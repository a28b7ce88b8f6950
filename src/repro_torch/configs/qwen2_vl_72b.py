"""qwen2-vl-72b — VLM backbone with M-RoPE, dynamic resolution
[arXiv:2409.12191].  ViT frontend is a STUB: input_specs feeds
(B, vision_seq, d_model) projected patch embeddings."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064,
    norm="rmsnorm", mlp_act="swiglu", qkv_bias=True,
    rope="mrope", mrope_sections=(16, 24, 24), rope_theta=1_000_000.0,
    vision_seq=1024,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    source="arXiv:2409.12191",
)
