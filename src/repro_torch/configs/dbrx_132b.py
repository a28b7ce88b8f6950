"""dbrx-132b — fine-grained MoE: 16 experts top-4 [hf:databricks/dbrx-base]."""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab_size=100352,
    moe=MoEConfig(n_experts=16, top_k=4, d_expert=10752,
                  router="softmax", capacity_factor=1.25),
    norm="layernorm", mlp_act="swiglu", rope="rope", rope_theta=500_000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    source="hf:databricks/dbrx-base",
)
