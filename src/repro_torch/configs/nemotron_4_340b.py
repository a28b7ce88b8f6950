"""nemotron-4-340b — dense GQA, squared-ReLU, partial rotary 50%
[arXiv:2402.16819]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab_size=256000,
    norm="layernorm", mlp_act="relu2", rope="rope", rope_pct=0.5,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    source="arXiv:2402.16819",
)
