"""deepseek-v3-671b — MoE with MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437]."""
from ..models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=2048, vocab_size=129280,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                  router="sigmoid_bias", routed_scale=2.5,
                  capacity_factor=1.25, first_dense_layers=3),
    prefix_d_ff=18432, mtp_depth=1,
    norm="rmsnorm", mlp_act="swiglu", rope="rope", rope_theta=10000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    source="arXiv:2412.19437",
)
