"""xlstm-350m — sLSTM + mLSTM blocks, 7:1 ratio [arXiv:2405.04517].
d_ff=0: blocks carry their own up/down projections."""
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    ssm=SSMConfig(slstm_every=8),   # 7 mLSTM : 1 sLSTM
    norm="rmsnorm", rope="none", mlp_act="gelu",
    param_dtype="bfloat16", compute_dtype="bfloat16",
    source="arXiv:2405.04517",
)
