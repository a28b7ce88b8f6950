"""qwen2.5-32b — dense GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab_size=152064,
    norm="rmsnorm", mlp_act="swiglu", qkv_bias=True,
    rope="rope", rope_theta=1_000_000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    source="hf:Qwen/Qwen2.5-0.5B",
)
