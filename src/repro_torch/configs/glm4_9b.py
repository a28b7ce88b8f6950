"""glm4-9b — dense GQA kv=2, RoPE (half rotary), QKV bias
[hf:THUDM/glm-4-9b]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=151552,
    norm="rmsnorm", mlp_act="swiglu", qkv_bias=True,
    rope="rope", rope_pct=0.5, rope_theta=10000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    source="hf:THUDM/glm-4-9b",
)
