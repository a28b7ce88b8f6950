"""jamba-v0.1-52b — hybrid Mamba+attention 1:7, MoE 16e top-2 every 2nd
layer [arXiv:2403.19887].  No positional encoding (rope=none)."""
from ..models.config import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    attn_layer_period=8, attn_layer_offset=4,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336,
                  layer_period=2, layer_offset=1, capacity_factor=1.25),
    norm="rmsnorm", mlp_act="swiglu", rope="none",
    param_dtype="bfloat16", compute_dtype="bfloat16",
    source="arXiv:2403.19887",
)
