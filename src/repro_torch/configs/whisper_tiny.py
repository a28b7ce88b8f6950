"""whisper-tiny — encoder-decoder audio LM [arXiv:2212.04356].

Conv/mel frontend is a STUB: input_specs feeds (B, 1500, 384) frame
embeddings.  max_seq is widened beyond the card's 448 so the assigned
train_4k shape lowers (structural adaptation, see DESIGN.md).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    n_enc_layers=4, enc_seq=1500,
    norm="layernorm", mlp_act="gelu", qkv_bias=True,
    rope="learned", tie_embeddings=True,
    max_seq=4096,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    source="arXiv:2212.04356",
)
