"""Attention (port of the serving part of ``repro/models/attention.py``):
GQA through the block-paged KV cache and over the dense engine's
contiguous per-row cache, and DeepSeek-V3's MLA (multi-head latent
attention) over the dense engine's latent cache.

Shapes: hidden (B, T, D); q (B, T, H, hd); the shared pools
(num_blocks, block_size, KV, hd); the dense cache (B, C, KV, hd).  GQA
groups query heads by KV head (H = KV * G) without materializing a K/V
repeat.

Paged: ``paged_attention`` over ``paged_gather`` (``dequant_gather`` for
an int8 pool) is the plain version of the served attention.
``gqa_paged_step`` sends it through the kernels: T = 1 to
``paged_decode_attention``, T > 1 to ``paged_prefill_attention``, or
their int8 forms over an int8 pool (``quantize_kv`` post-RoPE, four
pools written).  Dense: ``naive_attention`` and
``decode_attention`` are the plain versions; ``gqa_prefill`` runs the
contiguous ``flash_attention`` kernel and ``gqa_decode`` the
``decode_attention`` kernel.  On CPU tensors every wrapper runs its
plain version.  The reference's ``chunked_attention`` computes the same
function as ``naive_attention`` and serves only training (ROADMAP A15):
on the card the flash kernel covers every length.

MLA: ``mla_prefill`` runs the contiguous flash kernel's MLA form
(``mla_flash_attention``) and the expanded ``mla_decode`` the dense
decode kernel's (``mla_decode_attention``), on MLA's own operands: q =
[q_nope, q_rope], k_nope and V per head, and the rope key that every
head shares, one row per token (the decode reads it in place from the
latent cache); scale ``1/sqrt(qk_nope + qk_rope)``.  The absorbed
decode runs the reference's latent einsums in plain torch (no TPU
kernel computes it; ROADMAP Queue B).
The full-sequence forwards ``gqa_forward``/``mla_forward`` are the
prefills less their caches; ``gqa_prefill`` also runs bidirectionally
(``causal=False``, the whisper encoder), and ``cross_attention`` attends
decoder queries over encoder K/V without a mask (the flash kernel there,
``decode_attention`` in the decode step).  Rotary positions are ``rope``
(B,S), ``mrope`` (3,B,S: temporal, height, width streams), or none
(``learned``/``none``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..kernels.decode_attention import ops as decode_ops
from ..kernels.flash_attention import ops as flash_ops

from .common import apply_mrope, apply_rope, dense_init, mm, rmsnorm
from .config import ModelConfig

NEG_INF = -1e30


def gqa_params(gen: torch.Generator, cfg: ModelConfig, dtype):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, (d, h * hd), dtype=dtype),
        "wk": dense_init(gen, (d, kv * hd), dtype=dtype),
        "wv": dense_init(gen, (d, kv * hd), dtype=dtype),
        "wo": dense_init(gen, (h * hd, d), in_axis=0, dtype=dtype),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", h), ("bk", kv), ("bv", kv)):
            p[name] = torch.zeros((n * hd,), dtype=dtype, device=gen.device)
    return p


def mla_params(gen: torch.Generator, cfg: ModelConfig, dtype):
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    dev = gen.device
    return {
        "wdq": dense_init(gen, (d, m.q_lora_rank), dtype=dtype),
        "q_norm": {"scale": torch.ones((m.q_lora_rank,), dtype=dtype,
                                       device=dev)},
        "wuq": dense_init(gen, (m.q_lora_rank, h * qk_head), dtype=dtype),
        "wdkv": dense_init(gen, (d, m.kv_lora_rank), dtype=dtype),
        "kv_norm": {"scale": torch.ones((m.kv_lora_rank,), dtype=dtype,
                                        device=dev)},
        "wkr": dense_init(gen, (d, m.qk_rope_head_dim), dtype=dtype),
        "wuk": dense_init(gen, (m.kv_lora_rank, h * m.qk_nope_head_dim),
                          dtype=dtype),
        "wuv": dense_init(gen, (m.kv_lora_rank, h * m.v_head_dim),
                          dtype=dtype),
        "wo": dense_init(gen, (h * m.v_head_dim, d), dtype=dtype),
    }


def _grouped_scores(q, k):
    """q: (B,S,H,hd) k: (B,T,KV,hd) -> (B, KV, G, S, T) with H = KV*G."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    dt = torch.promote_types(q.dtype, k.dtype)
    return torch.einsum("bskgd,btkd->bkgst", qg.to(dt), k.to(dt))


def _grouped_out(probs, v):
    """probs: (B,KV,G,S,T) v: (B,T,KV,hd) -> (B,S,H,hd)."""
    B, KV, G, S, T = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, KV * G, v.shape[-1])


def naive_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                    kv_len=None, sliding_window: int = 0,
                    scale: Optional[float] = None):
    """Full-score attention.  q: (B,S,H,hd) k,v: (B,T,KV,hd).  Query s
    sits at position ``s + q_offset``; ``kv_len`` (B,) masks keys past
    each row's valid length.  Scores in the input type, softmax in f32,
    probabilities rounded to the V type (the reference's rounding)."""
    S = q.shape[1]
    T = k.shape[1]
    scale = scale if scale is not None else 1.0 / np.sqrt(q.shape[-1])
    scores = _grouped_scores(q * scale, k).float()               # (B,KV,G,S,T)
    q_pos = torch.arange(S, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if sliding_window:
        mask &= k_pos > q_pos - sliding_window
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    if kv_len is not None:
        valid = k_pos < kv_len[:, None]
        scores = torch.where(valid[:, None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return _grouped_out(probs, v)


def _dynamic_token_update(cache, new, idx: int):
    """Write one token at slot ``idx`` of every row, in place.  cache:
    (B, C, ...); new: (B, 1, ...); ``idx`` a host int, clamped to
    [0, C-1] as ``lax.dynamic_update_slice`` clamps its start.  A slice
    write: no index tensor, no host sync."""
    idx = min(max(int(idx), 0), cache.shape[1] - 1)
    cache[:, idx] = new[:, 0].to(cache.dtype)
    return cache


def cache_update_one(k_cache, v_cache, k_new, v_new, pos: int, window: int):
    """Insert one token at ``pos`` (ring index if window), in place."""
    cap = k_cache.shape[1]
    idx = pos % cap if window else pos
    return (_dynamic_token_update(k_cache, k_new, idx),
            _dynamic_token_update(v_cache, v_new, idx))


def decode_attention(q, k_cache, v_cache, pos: int, *, window: int = 0,
                     scale: Optional[float] = None):
    """One-token attention over the dense cache (the plain version of
    the ``decode_attention`` kernel).

    q: (B,1,H,hd); caches (B,C,KV,hd); ``pos`` = the new token's
    position, already inserted.  Slots ``< min(pos + 1, C)`` are valid:
    with a ring buffer (window) every slot is valid once it wraps.
    """
    hd = q.shape[-1]
    C = k_cache.shape[1]
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    scores = _grouped_scores(q * scale, k_cache).float()         # (B,KV,G,1,C)
    valid = torch.arange(C, device=q.device) < min(int(pos) + 1, C)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    return _grouped_out(probs, v_cache)


def paged_gather(storage, page_table):
    """Materialize per-slot logical views of a shared block pool.

    storage: (num_blocks, block_size, ...); page_table: (B, P) int32.
    Returns (B, P * block_size, ...) — row ``b`` holds slot ``b``'s
    logical positions 0..P*bs-1 in order.  Entries past the slot's true
    length are whatever the pointed-to blocks hold; callers mask by
    length.
    """
    B, P = page_table.shape
    g = storage[page_table.long()]                # (B, P, bs, ...)
    return g.reshape((B, P * storage.shape[1]) + tuple(storage.shape[2:]))


def paged_write_index(page_table, lengths, t_valid, T: int, bs: int):
    """Where a step's tokens land in a block pool of block size ``bs``
    (the index half of the reference's ``paged_scatter``).

    Token ``t`` of row ``b`` lands at logical position ``lengths[b] + t``
    iff ``t < t_valid[b]``; invalid tokens (padding, inactive slots,
    positions past the page table) are dropped, not written.  Torch has
    no ``mode="drop"``, so the kept tokens are selected here, once: the
    selection costs a host sync (``nonzero``).  Returns (rows, flat):
    the kept tokens' indices into the (B*T) flattened token axis and
    their rows in the (num_blocks*bs) flattened pool.  Every pool of
    every attention layer of a step (K, V and, under int8, their
    scales) shares one index, so a step pays that sync once.
    """
    P = page_table.shape[1]
    t = torch.arange(T, dtype=torch.int32, device=lengths.device)[None, :]
    pos = lengths[:, None] + t                                   # (B,T)
    page = pos // bs
    block = torch.gather(page_table, 1, page.clamp(0, P - 1).long())
    ok = (t < t_valid[:, None]) & (page < P)
    rows = ok.reshape(-1).nonzero().squeeze(1)
    flat = (block * bs + pos % bs).reshape(-1)[rows].long()
    return rows, flat


def paged_write(storage, vals, index):
    """Write ``vals`` (B, T, ...) into ``storage`` (num_blocks,
    block_size, ...) in place at a ``paged_write_index`` (the write half
    of the reference's ``paged_scatter``): long-tensor indexing, no host
    sync.  Returns ``storage``."""
    rows, flat = index
    nb, bs = storage.shape[:2]
    B, T = vals.shape[:2]
    dst = storage.view((nb * bs,) + tuple(storage.shape[2:]))
    src = vals.reshape((B * T,) + tuple(vals.shape[2:]))
    dst.index_put_((flat,), src[rows].to(storage.dtype))
    return storage


def paged_attention(q, k_gath, v_gath, positions, *,
                    scale: Optional[float] = None):
    """Per-slot attention over page-table-gathered caches.

    q: (B,T,H,hd) — T query tokens per slot; k_gath/v_gath: (B,C,KV,hd)
    logical views from ``paged_gather``; positions: (B,T) each query's
    absolute position in its own sequence.  Query t of slot b attends
    to logical slots l <= positions[b, t].  Scores and softmax are f32;
    the probabilities are rounded to the V type before the P.V product.
    """
    hd = q.shape[-1]
    C = k_gath.shape[1]
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    scores = _grouped_scores(q * scale, k_gath).float()          # (B,KV,G,T,C)
    kpos = torch.arange(C, device=q.device)[None, None, :]
    mask = kpos <= positions[:, :, None]                         # (B,T,C)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_gath.dtype)
    return _grouped_out(probs, v_gath)


def _project_qkv(p, cfg: ModelConfig, x, q: bool = True, kv: bool = True):
    """(q, k, v) of x (B,S,D), as (B,S,H,hd) and (B,S,KV,hd); ``q=False``
    or ``kv=False`` skips those projections (None in their place)."""
    h, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    B, S, _ = x.shape

    def proj(w, b, n):
        y = mm(x, p[w])
        if cfg.qkv_bias:
            y = y + p[b]
        return y.reshape(B, S, n, hd)
    return (proj("wq", "bq", h) if q else None,
            proj("wk", "bk", nkv) if kv else None,
            proj("wv", "bv", nkv) if kv else None)


def _rope_qk(cfg: ModelConfig, q, k, positions):
    """Rotary positions on q and k: ``rope`` over (B,S) positions,
    ``mrope`` over (3,B,S) streams; nothing for ``none`` and ``learned``
    (whisper adds its positions to the embedding)."""
    if cfg.rope == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct)
    elif cfg.rope == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k


# -- int8 block-quantized paged KV ---------------------------------------------

QUANT_EPS = 1e-8


def quantize_kv(x):
    """Symmetric per-row-per-head int8 quantization over head_dim.

    x: (..., hd) float -> (q (..., hd) int8, scale (...) f32) with
    ``dequant = q.to(f32) * scale[..., None]``; scale = max(amax, eps) /
    127 over head_dim, so every (token, head) row carries its own scale
    and a row written once is never requantized.  The reference's
    arithmetic in its order (``torch.round`` is half-to-even, as
    ``jnp.round``), so the codes and scales equal its bit for bit.
    """
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=QUANT_EPS) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q, scale):
    """Inverse of ``quantize_kv``: (..., hd) int8 x (...) f32 -> f32."""
    return q.to(torch.float32) * scale[..., None]


def dequant_gather(pool, scale, page_table):
    """``paged_gather`` of an int8 pool and its scale pool, dequantized:
    (B, P * block_size, KV, hd) f32 (the reference's read of an int8
    pool, and the plain versions' input)."""
    return dequantize_kv(paged_gather(pool, page_table),
                         paged_gather(scale, page_table))


def gqa_paged_step(p, cfg: ModelConfig, x, pools, page_table, lengths,
                   index):
    """Process T tokens per slot through a block-paged KV cache.

    x: (B,T,D); pools: the layer's shared pools, updated in place —
    ``k``/``v`` (num_blocks, block_size, KV, hd), and under int8 KV
    also ``k_scale``/``v_scale`` (num_blocks, block_size, KV) f32;
    page_table: (B,P) int32; lengths: (B,) tokens already cached per
    slot; index: the step's ``paged_write_index``, shared by every
    attention layer (it carries which of the T tokens are real).

    Decode is T=1, chunked prefill is T=chunk; slots may mix phases.
    K/V are written through the page table *before* attention, so
    in-chunk causal self-attention falls out of the position mask.  T = 1
    goes to the paged decode kernel, T > 1 to the paged prefill kernel.
    Under int8 the new rows are quantized post-RoPE and written with
    their scales (four pools, one index), and the int8 kernels
    dequantize rows as they load them; the output is then f32 (the
    dequantized K/V are), so the model must compute in f32.  Returns out
    (B,T,D).
    """
    B, T, _ = x.shape
    positions = flash_ops.prefill_positions(lengths, T)
    q, k, v = _project_qkv(p, cfg, x)
    q, k = _rope_qk(cfg, q, k, positions)
    quant = "k_scale" in pools
    if quant:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        paged_write(pools["k_scale"], ks, index)
        paged_write(pools["v_scale"], vs, index)
    paged_write(pools["k"], k, index)
    paged_write(pools["v"], v, index)
    stores = [pools[n] for n in ("k", "v", "k_scale", "v_scale")
              if n in pools]
    if T == 1:
        decode = (decode_ops.paged_decode_attention_quant if quant
                  else decode_ops.paged_decode_attention)
        # the new token is already in the pool: lengths + 1 keys visible
        out = decode(q[:, 0].contiguous(), *stores, page_table,
                     lengths + 1)[:, None]
    else:
        prefill = (flash_ops.paged_prefill_attention_quant if quant
                   else flash_ops.paged_prefill_attention)
        out = prefill(q.contiguous(), *stores, page_table, lengths)
    return mm(out.reshape(B, T, -1), p["wo"])


def gqa_prefill(p, cfg: ModelConfig, x, positions, causal: bool = True):
    """Prefill: attention over the whole prompt through the contiguous
    flash kernel, causal (with the config's sliding window) or, for an
    encoder, bidirectional.  x: (B,S,D); positions: (B,S), or (3,B,S)
    under mrope.  Returns (out (B,S,D), (k, v) (B,S,KV,hd)) for cache
    seeding."""
    q, k, v = _project_qkv(p, cfg, x)
    q, k = _rope_qk(cfg, q, k, positions)
    out = flash_ops.flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal,
                                    sliding_window=cfg.sliding_window)
    B, S = x.shape[:2]
    return mm(out.reshape(B, S, -1), p["wo"]), (k, v)


def gqa_forward(p, cfg: ModelConfig, x, positions, causal: bool = True):
    """The full-sequence forward: ``gqa_prefill`` less the cache."""
    return gqa_prefill(p, cfg, x, positions, causal)[0]


def cross_attention(p, cfg: ModelConfig, x, k, v):
    """Encoder-decoder cross-attention over the encoder's K/V (B,T,KV,hd)
    (``cross_kv``): queries from x (B,S,D), no mask, S free of T, through
    the contiguous flash kernel.  Returns (B,S,D)."""
    q, _, _ = _project_qkv(p, cfg, x, kv=False)
    out = flash_ops.flash_attention(q.contiguous(), k, v, causal=False)
    B, S = x.shape[:2]
    return mm(out.reshape(B, S, -1), p["wo"])


def cross_kv(p, cfg: ModelConfig, enc):
    """The cross-attention K/V of encoder states enc (B,T,D), contiguous."""
    _, k, v = _project_qkv(p, cfg, enc, q=False)
    return k.contiguous(), v.contiguous()


def gqa_decode(p, cfg: ModelConfig, x, k_cache, v_cache, pos: int):
    """Decode one token.  x: (B,1,D); ``pos``: host int, the position of
    this token, shared by every row.  The token's K/V land at slot
    ``pos`` (``pos % C`` with a window) by a slice write, in place; the
    decode kernel then reads ``min(pos + 1, C)`` slots.  Returns (out,
    k_cache, v_cache)."""
    B = x.shape[0]
    positions = torch.full((B, 1), int(pos), dtype=torch.int32,
                           device=x.device)
    if cfg.rope == "mrope":
        # the reference's decode position: the sequence index on all
        # three streams (not the prefill's text offset; ROADMAP Queue C)
        positions = positions.expand(3, B, 1)
    q, k, v = _project_qkv(p, cfg, x)
    q, k = _rope_qk(cfg, q, k, positions)
    cache_update_one(k_cache, v_cache, k, v, pos, cfg.sliding_window)
    C = k_cache.shape[1]
    out = decode_ops.decode_attention(q[:, 0].contiguous(), k_cache,
                                      v_cache, min(int(pos) + 1, C))
    return mm(out.reshape(B, 1, -1), p["wo"]), k_cache, v_cache


# -- MLA (DeepSeek-V3): the cache holds (c_kv, k_rope), the latent compression

def _mla_qkv(p, cfg: ModelConfig, x, positions):
    """(q, q_rope, c_kv, k_rope): q (B,S,H,nope+rope) = [q_nope, q_rope]
    with the rope columns rotated in place (the kernels' q operand, no
    concatenation), q_rope those columns as a tensor of their own, the
    latent c_kv (B,S,rank) and the single shared rope key (B,S,1,rope)."""
    m = cfg.mla
    h = cfg.n_heads
    B, S, _ = x.shape
    nope = m.qk_nope_head_dim
    cq = rmsnorm(p["q_norm"], mm(x, p["wdq"]))
    q = mm(cq, p["wuq"]).reshape(B, S, h, nope + m.qk_rope_head_dim)
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    q[..., nope:] = q_rope
    c_kv = rmsnorm(p["kv_norm"], mm(x, p["wdkv"]))      # (B,S,rank)
    k_rope = apply_rope(mm(x, p["wkr"]).reshape(B, S, 1, m.qk_rope_head_dim),
                        positions, cfg.rope_theta)      # shared single head
    return q, q_rope, c_kv, k_rope


def _mla_expand_kv(p, cfg: ModelConfig, c_kv):
    m = cfg.mla
    B, T = c_kv.shape[:2]
    h = cfg.n_heads
    k_nope = mm(c_kv, p["wuk"]).reshape(B, T, h, m.qk_nope_head_dim)
    v = mm(c_kv, p["wuv"]).reshape(B, T, h, m.v_head_dim)
    return k_nope, v


def mla_prefill(p, cfg: ModelConfig, x, positions):
    """Causal MLA over the whole prompt through the contiguous flash
    kernel, on MLA's own operands (``mla_flash_attention``: q = [q_nope,
    q_rope], the rope key shared by every head, V at v_head_dim).  x:
    (B,S,D); positions: (B,S).  Returns (out (B,S,D), (c_kv (B,S,rank),
    k_rope (B,S,rope))) — the latent cache."""
    m = cfg.mla
    B, S, _ = x.shape
    q, _, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)
    k_nope, v = _mla_expand_kv(p, cfg, c_kv)
    k_rope = k_rope.reshape(B, S, m.qk_rope_head_dim).contiguous()
    out = flash_ops.mla_flash_attention(q, k_nope.contiguous(), k_rope,
                                        v.contiguous())
    return mm(out.reshape(B, S, -1), p["wo"]), (c_kv, k_rope)


def mla_forward(p, cfg: ModelConfig, x, positions):
    """The full-sequence forward (causal, as the reference runs it):
    ``mla_prefill`` less the latent cache."""
    return mla_prefill(p, cfg, x, positions)[0]


def mla_decode(p, cfg: ModelConfig, x, c_cache, kr_cache, pos: int,
               absorb: bool = False):
    """Decode one token over the latent cache.  x: (B,1,D); c_cache:
    (B,C,rank); kr_cache: (B,C,rope); ``pos``: host int shared by every
    row.  The token's latents land at slot ``pos`` (clamped to C-1, as
    ``lax.dynamic_update_slice``) in place; slots ``< min(pos+1, C)`` are
    attended to.  ``absorb=False`` expands K/V of those slots from the
    cache and runs the ``decode_attention`` kernel; ``absorb=True`` folds
    W_uk into the query and W_uv into the output and attends in the
    latent space (the reference's einsums, plain torch).  The expanded
    form's kernel (``mla_decode_attention``) reads the rope keys in place
    from ``kr_cache``.  Returns (out, c_cache, kr_cache)."""
    m = cfg.mla
    h = cfg.n_heads
    B = x.shape[0]
    positions = torch.full((B, 1), int(pos), dtype=torch.int32,
                           device=x.device)
    q, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)
    _dynamic_token_update(c_cache, c_kv, pos)
    _dynamic_token_update(kr_cache, k_rope[:, :, 0], pos)
    n = min(int(pos) + 1, c_cache.shape[1])
    c, kr = c_cache[:, :n], kr_cache[:, :n]
    scale = 1.0 / np.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    if absorb:
        def ein(eq, a, b):
            dt = torch.promote_types(a.dtype, b.dtype)
            return torch.einsum(eq, a.to(dt), b.to(dt))
        wuk = p["wuk"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
        q_lat = ein("bshd,rhd->bshr", q[..., :m.qk_nope_head_dim], wuk)
        s_lat = ein("bshr,btr->bhst", q_lat, c)
        s_rope = ein("bshd,btd->bhst", q_rope, kr)
        scores = ((s_lat + s_rope) * scale).float()
        probs = torch.softmax(scores, dim=-1).to(c.dtype)
        o_lat = ein("bhst,btr->bshr", probs, c)          # (B,1,h,rank)
        wuv = p["wuv"].reshape(m.kv_lora_rank, h, m.v_head_dim)
        out = ein("bshr,rhd->bshd", o_lat, wuv)
    else:
        k_nope, v = _mla_expand_kv(p, cfg, c)
        out = decode_ops.mla_decode_attention(q[:, 0], k_nope.contiguous(),
                                              kr_cache, v.contiguous(), n)
    return mm(out.reshape(B, 1, -1), p["wo"]), c_cache, kr_cache
