"""GQA attention (port of the GQA part of ``repro/models/attention.py``):
through the block-paged KV cache, and over the dense engine's
contiguous per-row cache.

Shapes: hidden (B, T, D); q (B, T, H, hd); the shared pools
(num_blocks, block_size, KV, hd); the dense cache (B, C, KV, hd).  GQA
groups query heads by KV head (H = KV * G) without materializing a K/V
repeat.

Paged: ``paged_attention`` over ``paged_gather`` is the plain version of
the served attention.  ``gqa_paged_step`` sends it through the kernels:
T = 1 to ``paged_decode_attention``, T > 1 to
``paged_prefill_attention``.  Dense: ``naive_attention`` and
``decode_attention`` are the plain versions; ``gqa_prefill`` runs the
contiguous ``flash_attention`` kernel and ``gqa_decode`` the
``decode_attention`` kernel.  On CPU tensors every wrapper runs its
plain version.  The reference's ``chunked_attention`` computes the same
function as ``naive_attention`` and serves only training (ROADMAP A15):
on the card the flash kernel covers every length.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..kernels.decode_attention import ops as decode_ops
from ..kernels.flash_attention import ops as flash_ops
from .common import apply_rope, dense_init, mm
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
    (B, C, KV, hd); new: (B, 1, KV, hd); ``idx`` a host int, clamped to
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


def paged_scatter(storage, vals, page_table, lengths, t_valid):
    """Write per-slot token runs into the shared block pool, in place.

    storage: (num_blocks, block_size, ...); vals: (B, T, ...).  Token
    ``t`` of row ``b`` lands at logical position ``lengths[b] + t`` iff
    ``t < t_valid[b]``; invalid tokens (padding, inactive slots,
    positions past the page table) are dropped, not written.  Torch has
    no ``mode="drop"``, so the valid indices are selected before the
    ``index_put_``.  Returns ``storage``.
    """
    nb, bs = storage.shape[:2]
    B, T = vals.shape[:2]
    P = page_table.shape[1]
    t = torch.arange(T, dtype=torch.int32, device=vals.device)[None, :]
    pos = lengths[:, None] + t                                   # (B,T)
    page = pos // bs
    block = torch.gather(page_table, 1, page.clamp(0, P - 1).long())
    ok = (t < t_valid[:, None]) & (page < P)
    flat = storage.view((nb * bs,) + tuple(storage.shape[2:]))
    flat_idx = (block * bs + pos % bs)[ok].long()
    flat.index_put_((flat_idx,), vals[ok].to(storage.dtype))
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


def _project_qkv(p, cfg: ModelConfig, x):
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    B, S, _ = x.shape
    q = mm(x, p["wq"])
    k = mm(x, p["wk"])
    v = mm(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return (q.reshape(B, S, h, hd), k.reshape(B, S, kv, hd),
            v.reshape(B, S, kv, hd))


def _rope_qk(cfg: ModelConfig, q, k, positions):
    if cfg.rope == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct)
    elif cfg.rope != "none":
        raise NotImplementedError(
            f"rope={cfg.rope!r}: mrope is not ported yet (ROADMAP A13)")
    return q, k


def gqa_paged_step(p, cfg: ModelConfig, x, k_store, v_store, page_table,
                   lengths, t_valid):
    """Process T tokens per slot through a block-paged KV cache.

    x: (B,T,D); k_store/v_store: (num_blocks, block_size, KV, hd) shared
    pools; page_table: (B,P) int32; lengths: (B,) tokens already cached
    per slot; t_valid: (B,) how many of this call's T tokens are real
    for each slot (0 = slot idle this step).

    Decode is T=1/t_valid=1, chunked prefill is T=chunk with t_valid up
    to chunk; slots may mix phases.  K/V are scattered through the page
    table *before* attention, so in-chunk causal self-attention falls
    out of the position mask.  The pools are updated in place (the JAX
    reference donates them and returns new arrays); they are returned
    for the same call shape.  Returns (out (B,T,D), k_store, v_store).
    """
    B, T, _ = x.shape
    positions = flash_ops.prefill_positions(lengths, T)
    q, k, v = _project_qkv(p, cfg, x)
    q, k = _rope_qk(cfg, q, k, positions)
    paged_scatter(k_store, k, page_table, lengths, t_valid)
    paged_scatter(v_store, v, page_table, lengths, t_valid)
    if T == 1:
        # the new token is already in the pool: lengths + 1 keys visible
        out = decode_ops.paged_decode_attention(
            q[:, 0].contiguous(), k_store, v_store, page_table,
            lengths + 1)[:, None]
    else:
        out = flash_ops.paged_prefill_attention(
            q.contiguous(), k_store, v_store, page_table, lengths)
    return mm(out.reshape(B, T, -1), p["wo"]), k_store, v_store


def gqa_prefill(p, cfg: ModelConfig, x, positions):
    """Prefill: causal (sliding-window) attention over the whole prompt
    through the contiguous flash kernel.  x: (B,S,D); positions: (B,S).
    Returns (out (B,S,D), (k, v) (B,S,KV,hd)) for cache seeding."""
    q, k, v = _project_qkv(p, cfg, x)
    q, k = _rope_qk(cfg, q, k, positions)
    out = flash_ops.flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=True,
                                    sliding_window=cfg.sliding_window)
    B, S = x.shape[:2]
    return mm(out.reshape(B, S, -1), p["wo"]), (k, v)


def gqa_decode(p, cfg: ModelConfig, x, k_cache, v_cache, pos: int):
    """Decode one token.  x: (B,1,D); ``pos``: host int, the position of
    this token, shared by every row.  The token's K/V land at slot
    ``pos`` (``pos % C`` with a window) by a slice write, in place; the
    decode kernel then reads ``min(pos + 1, C)`` slots.  Returns (out,
    k_cache, v_cache)."""
    B = x.shape[0]
    positions = torch.full((B, 1), int(pos), dtype=torch.int32,
                           device=x.device)
    q, k, v = _project_qkv(p, cfg, x)
    q, k = _rope_qk(cfg, q, k, positions)
    cache_update_one(k_cache, v_cache, k, v, pos, cfg.sliding_window)
    C = k_cache.shape[1]
    out = decode_ops.decode_attention(q[:, 0].contiguous(), k_cache,
                                      v_cache, min(int(pos) + 1, C))
    return mm(out.reshape(B, 1, -1), p["wo"]), k_cache, v_cache
