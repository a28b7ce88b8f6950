"""smollm-360m — llama-arch small dense [hf:HuggingFaceTB/SmolLM-135M]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab_size=49152,
    norm="rmsnorm", mlp_act="swiglu", rope="rope",
    param_dtype="bfloat16", compute_dtype="bfloat16",
    source="hf:HuggingFaceTB/SmolLM-135M",
)
