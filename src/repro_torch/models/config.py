"""ModelConfig — one dataclass describes every assigned architecture."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention dims [arXiv:2412.19437]."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_expert: int = 0              # expert FFN hidden dim
    n_shared: int = 0              # shared (always-on) experts
    router: str = "softmax"        # "softmax" | "sigmoid_bias" (dsv3)
    routed_scale: float = 1.0      # dsv3 routed_scaling_factor
    capacity_factor: float = 1.25
    first_dense_layers: int = 0    # dsv3: first 3 layers dense
    layer_period: int = 1          # jamba: MoE every `period` layers
    layer_offset: int = 0
    aux_loss_coef: float = 0.01    # load-balance loss (training)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    # mamba (jamba) [arXiv:2403.19887]
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0               # 0 = ceil(d_model/16)
    # xlstm [arXiv:2405.04517]
    slstm_every: int = 0           # pattern period for sLSTM blocks; 0 = none


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 = d_model // n_heads
    # blocks / norms / activations
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    mlp_act: str = "swiglu"        # swiglu | relu2 | gelu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    # positions
    rope: str = "rope"             # rope | mrope | none | learned
    rope_theta: float = 10000.0
    rope_pct: float = 1.0          # partial rotary (nemotron/glm 0.5)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # qwen2-vl t/h/w split
    # attention variants
    mla: Optional[MLAConfig] = None
    sliding_window: int = 0        # 0 = full attention
    # mixture of experts
    moe: Optional[MoEConfig] = None
    # ssm / hybrid
    ssm: Optional[SSMConfig] = None
    attn_layer_period: int = 0     # jamba: 1 attn per `period` layers
    attn_layer_offset: int = 0
    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 0               # stub frontend output length (1500 whisper)
    # multi-token prediction (dsv3)
    mtp_depth: int = 0
    # dsv3: dense-FFN width for the un-scanned prefix layers (0 = d_ff)
    prefix_d_ff: int = 0
    # frontends (stub): number of modality embedding positions for vlm
    vision_seq: int = 0
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # misc
    max_seq: int = 8192            # for learned position tables only
    source: str = ""               # citation

    # -- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def dt_rank(self) -> int:
        if self.ssm is None:
            return 0
        return self.ssm.dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    def is_attn_layer(self, i: int) -> bool:
        """Hybrid interleave: True if layer i is attention (else SSM)."""
        if self.family != "hybrid":
            return True
        return i % self.attn_layer_period == self.attn_layer_offset

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        if i < self.moe.first_dense_layers:
            return False
        return (i - self.moe.layer_offset) % self.moe.layer_period == 0 \
            if self.moe.layer_period > 1 else True

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: <=2 layers, d_model<=512, <=4 experts."""
    n_heads = min(cfg.n_heads, 4)
    # keep GQA ratio alive where possible
    ratio = max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1)
    n_kv = max(n_heads // min(ratio, n_heads), 1)
    d_model = min(cfg.d_model, 256)
    head_dim = min(cfg.resolved_head_dim, 64)
    kw = dict(
        n_layers=2, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        max_seq=256,
        param_dtype="float32", compute_dtype="float32",
    )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                              qk_nope_head_dim=32, qk_rope_head_dim=16,
                              v_head_dim=32)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2),
            d_expert=min(cfg.moe.d_expert or 256, 256),
            n_shared=min(cfg.moe.n_shared, 1),
            first_dense_layers=min(cfg.moe.first_dense_layers, 1))
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=8, d_conv=4, expand=2,
            # keep both xlstm block kinds alive in a 2-layer smoke stack
            slstm_every=2 if cfg.ssm.slstm_every else 0)
    if cfg.family == "hybrid":
        kw["n_layers"] = max(cfg.attn_layer_period, 2)  # one full period
    if cfg.n_enc_layers:
        kw["n_enc_layers"] = 2
        kw["enc_seq"] = min(cfg.enc_seq, 64)
    if cfg.vision_seq:
        kw["vision_seq"] = 16
    if cfg.rope == "mrope":
        half = head_dim // 2
        hw = (half * 3) // 8
        kw["mrope_sections"] = (half - 2 * hw, hw, hw)
    return cfg.replace(**kw)
