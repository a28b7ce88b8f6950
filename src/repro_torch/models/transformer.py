"""Decoder-only model: dense, MoE (GQA or MLA attention), hybrid
Mamba+attention, xLSTM and vision-language families (port of
``repro/models/transformer.py``): the full-sequence forward (``apply``)
with its training loss (``loss``, ``mtp_logits``, ``softmax_xent``),
the block-paged step (``paged_step``) with its preemption spill
(``gather_paged_pages``/``scatter_paged_pages``) and the dense engine's
contiguous cache (``init_cache``, ``prefill``, ``decode_step``).

A config expands to a *layer pattern*: an optional unrolled ``prefix``
of sub-layer descriptors plus a repeating ``period`` applied
``n_periods`` times.  Parameters keep the JAX package's layout — the
periodic blocks' leaves are stacked on a leading layer axis
(``params["blocks"]["s0"]["attn"]["wq"]`` is (n_periods, d, H*hd)), each
period descriptor ``s{j}`` with its own stacked leaves — so the weight
bridge maps leaf to leaf, and a layer reads its weights as views of the
stacked tensors.

Sub-layer descriptor: (block, mlp) with block in {attn, mla, mamba,
mlstm, slstm} and mlp in {dense, moe, none}.  The layer stack runs as a
Python loop over the periods; the caches are updated in place.  The
full-sequence forward ``apply`` returns every position's logits and the
MoE aux loss; torch differentiates it (on the card through B2's
backward kernel), and ``remat=True`` checkpoints each period's body as
the reference's ``jax.checkpoint`` does.  The vision-language family is
a dense stack with M-RoPE positions (``make_positions``) whose first
``vision_seq`` embeddings the caller's patch embeddings replace; the
encoder-decoder is ``EncDecLM`` (``encdec.py``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from . import attention as A
from . import mamba as M
from . import sharding as S
from . import xlstm as X
from .common import (dense_init, dtype_of, embed_init, make_norm, mm,
                     resolve_device)
from .config import ModelConfig
from .mlp import mlp_forward, mlp_params
from .moe import moe_forward, moe_params

Desc = Tuple[str, str]

RECURRENT_BLOCKS = ("mamba", "mlstm", "slstm")


def layer_pattern(cfg: ModelConfig) -> Tuple[List[Desc], List[Desc], int]:
    """Returns (prefix_descs, period_descs, n_periods)."""
    if cfg.n_enc_layers or cfg.family in ("encdec", "audio"):
        raise ValueError(f"family {cfg.family!r} is an encoder-decoder: "
                         "build it with build_model (EncDecLM)")
    if cfg.family in ("dense", "vlm"):
        return [], [("attn", "dense")], cfg.n_layers
    if cfg.family == "moe":
        attn = "mla" if cfg.mla is not None else "attn"
        nd = cfg.moe.first_dense_layers
        return [(attn, "dense")] * nd, [(attn, "moe")], cfg.n_layers - nd
    if cfg.family == "hybrid":
        period = [("attn" if cfg.is_attn_layer(i) else "mamba",
                   "moe" if cfg.is_moe_layer(i) else "dense")
                  for i in range(cfg.attn_layer_period)]
        assert cfg.n_layers % cfg.attn_layer_period == 0
        return [], period, cfg.n_layers // cfg.attn_layer_period
    if cfg.family == "ssm":
        every = cfg.ssm.slstm_every or 4
        period = [("mlstm", "none")] * (every - 1) + [("slstm", "none")]
        assert cfg.n_layers % every == 0
        return [], period, cfg.n_layers // every
    raise ValueError(cfg.family)


def _sublayer_params(gen, cfg: ModelConfig, desc: Desc, dtype,
                     dense_ff: int):
    block, mlp = desc
    norm_params, _ = make_norm(cfg.norm)
    p: Dict[str, Any] = {"norm1": norm_params(cfg.d_model, dtype, gen.device)}
    if block == "attn":
        p["attn"] = A.gqa_params(gen, cfg, dtype)
    elif block == "mla":
        p["attn"] = A.mla_params(gen, cfg, dtype)
    elif block == "mamba":
        p["mamba"] = M.mamba_params(gen, cfg, dtype)
    elif block == "mlstm":
        p["mlstm"] = X.mlstm_params(gen, cfg, dtype)
    elif block == "slstm":
        p["slstm"] = X.slstm_params(gen, cfg, dtype)
    else:
        raise ValueError(block)
    if mlp != "none":
        p["norm2"] = norm_params(cfg.d_model, dtype, gen.device)
    if mlp == "dense":
        p["mlp"] = mlp_params(gen, cfg.d_model, dense_ff, cfg.mlp_act, dtype)
    elif mlp == "moe":
        p["moe"] = moe_params(gen, cfg, dtype)
    return p


def _sublayer_state(cfg: ModelConfig, desc: Desc, batch: int, capacity: int,
                    dtype, device) -> Dict[str, torch.Tensor]:
    """Dense decode-time state of one sub-layer.  Attention: (batch, cap,
    KV, hd) K/V, ``cap = min(capacity, sliding_window)`` with a window (a
    ring).  MLA: the latent cache ``c`` (batch, capacity, kv_lora_rank)
    and the shared rope key ``kr`` (batch, capacity, qk_rope_head_dim),
    in the cache type.  Mamba: the conv window in the cache type, the SSM
    state in f32.  mLSTM/sLSTM: their carries, f32 whatever the cache
    type (``capacity`` unused)."""
    block = desc[0]
    if block == "mla":
        m = cfg.mla
        return {"c": torch.zeros((batch, capacity, m.kv_lora_rank),
                                 dtype=dtype, device=device),
                "kr": torch.zeros((batch, capacity, m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}
    if block in X.STATE_LEAVES:
        return X.init_state(cfg, block, batch, device)
    if block == "attn":
        kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        cap = min(capacity, cfg.sliding_window) if cfg.sliding_window \
            else capacity
        return {"k": torch.zeros((batch, cap, kv, hd), dtype=dtype,
                                 device=device),
                "v": torch.zeros((batch, cap, kv, hd), dtype=dtype,
                                 device=device)}
    return {"conv": torch.zeros((batch, cfg.ssm.d_conv - 1, cfg.d_inner),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm.d_state),
                               dtype=torch.float32, device=device)}


def _paged_sublayer_state(cfg: ModelConfig, desc: Desc, num_blocks: int,
                          block_size: int, num_state_slots: int, dtype,
                          device, kv_dtype: Optional[str] = None):
    """Paged serving state of one sub-layer.  Attention: the shared (nb, bs,
    KV, hd) K/V pools — under ``kv_dtype="int8"`` int8 pools plus f32
    ``k_scale``/``v_scale`` pools (nb, bs, KV), one scale per row and
    head, as the reference lays them out.  Recurrent blocks (never
    quantized): one state slab per slot — mamba's conv window in the
    cache type and SSM state in f32, the xLSTM carries in f32 — plus one
    spare *dump row* at index ``num_state_slots`` that no slot owns: idle
    rows of a step scatter their state there, which drops it without a
    boolean filter (and so without a host sync).  The ``StateStore``
    never hands it out."""
    if desc[0] == "attn":
        shape = (num_blocks, block_size, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        if kv_dtype == "int8":
            pools = {"k": (shape, torch.int8), "v": (shape, torch.int8),
                     "k_scale": (shape[:3], torch.float32),
                     "v_scale": (shape[:3], torch.float32)}
            return {name: torch.zeros(shp, dtype=dt, device=device)
                    for name, (shp, dt) in pools.items()}
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    return _sublayer_state(cfg, desc, num_state_slots + 1, 0, dtype, device)


def _slab_rows(lengths, t_valid, state_slots, dump: int):
    """A paged step's state slab addressing, the same for every recurrent
    layer, so computed once per step: ``rows`` (B,) int64, the slab each
    row reads (its slot, clamped to the real slabs); ``fresh`` (B,1,1),
    rows whose sequence starts this step (``lengths == 0``: a slab
    recycled from an evicted request must never leak state into its
    successor); ``read`` (B,) int64, ``rows`` with -1 for fresh rows
    (the scan starts them from zero); ``write`` (B,) int64, the slot for
    rows that advance and the dump row for idle rows (``t_valid == 0``),
    so a stale slab id on an evicted slot cannot clobber the slab's new
    owner."""
    rows = state_slots.clamp(0, dump - 1).long()
    fresh = lengths == 0
    read = torch.where(fresh, -1, rows)
    write = torch.where(t_valid > 0, state_slots, dump).long()
    return rows, fresh[:, None, None], read, write


def _paged_sublayer(p, cfg: ModelConfig, desc: Desc, x, state, page_table,
                    lengths, t_valid, slabs, index):
    """Multi-token step through the paged serving cache, in place.

    Attention blocks read/write the shared block pool through the page
    table at the step's write ``index`` (int8 pools when the state holds
    scales, as the reference dispatches).  Recurrent blocks read/write
    their rows of the per-slot state slabs as ``slabs`` (``_slab_rows``)
    addresses them.  Mamba: the conv window by a gather, a zeroing of
    fresh rows and an ``index_copy_`` back; the SSM state inside the scan
    kernel, which reads and writes the slab pool in place
    (``mamba_slab_step``).  xLSTM: every leaf by the same gather, zeroing
    and ``index_copy_`` (the reference's gather/blank/scatter, idle rows
    to the dump row).  Same norm/residual order as the reference."""
    _, norm = make_norm(cfg.norm)
    h = norm(p["norm1"], x)
    block = desc[0]
    if block == "attn":
        # a tensor-parallel rank without q heads adds a zero partial
        y = A.gqa_paged_step(p["attn"], cfg, h, state, page_table, lengths,
                             index) if cfg.n_heads else torch.zeros_like(h)
    elif block == "mamba":
        rows, fresh, read, write = slabs
        conv = torch.where(fresh, 0, state["conv"][rows])
        y, conv = M.mamba_slab_step(p["mamba"], cfg, h, conv, state["ssm"],
                                    read, write, t_valid)
        state["conv"].index_copy_(0, write, conv.to(state["conv"].dtype))
    else:
        rows, fresh, _, write = slabs
        keys = X.STATE_LEAVES[block]
        carry = tuple(torch.where(
            fresh.reshape((-1,) + (1,) * (state[k].dim() - 1)), 0,
            state[k][rows]) for k in keys)
        step = X.mlstm_paged_step if block == "mlstm" else X.slstm_paged_step
        y, new = step(p[block], cfg, h, carry, t_valid)
        for k, a in zip(keys, new):
            state[k].index_copy_(0, write, a.to(state[k].dtype))
    return _mlp_residual(p, cfg, desc, x + _reduce(block, y))


def _reduce(block: str, y):
    """A block's output summed over the tensor-parallel ranks: a
    row-parallel projection leaves each rank a partial sum; the
    replicated blocks (``sharding.REPLICATED_BLOCKS``) are whole.  The
    identity without a mesh."""
    return y if block in S.REPLICATED_BLOCKS else S.all_reduce(y)


def _mlp_residual(p, cfg: ModelConfig, desc: Desc, x):
    """The sub-layer's second half: norm2 and its MLP or MoE, added to
    the residual; nothing for ``mlp == "none"`` (the xLSTM blocks)."""
    if desc[1] == "none":
        return x
    _, norm = make_norm(cfg.norm)
    h = norm(p["norm2"], x)
    if desc[1] == "dense":
        return x + S.all_reduce(mlp_forward(p["mlp"], cfg.mlp_act, h))
    y, _ = moe_forward(p["moe"], cfg, h)
    return x + S.all_reduce(y)


def _apply_sublayer(p, cfg: ModelConfig, desc: Desc, x, positions):
    """Full-sequence forward of one sub-layer, from zero state -> (x, its
    MoE aux loss: a zero without MoE).  Attention and MLA run the
    contiguous flash kernel; mamba its cold-start scan; the xLSTM blocks
    their recurrence from zero state."""
    _, norm = make_norm(cfg.norm)
    h = norm(p["norm1"], x)
    block = desc[0]
    if block == "attn":
        y = (A.gqa_forward(p["attn"], cfg, h, positions) if cfg.n_heads
             else torch.zeros_like(h))
    elif block == "mla":
        y = A.mla_forward(p["attn"], cfg, h, positions)
    elif block == "mamba":
        y, _ = M.mamba_forward(p["mamba"], cfg, h)
    else:
        forward = X.mlstm_forward if block == "mlstm" else X.slstm_forward
        y, _ = forward(p[block], cfg, h)
    x = x + _reduce(block, y)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if desc[1] == "moe":
        y, aux = moe_forward(p["moe"], cfg, norm(p["norm2"], x))
        return x + S.all_reduce(y), aux
    return _mlp_residual(p, cfg, desc, x), aux


def make_positions(cfg: ModelConfig, B: int, S: int, offset: int = 0,
                   device=None):
    """(B,S) int32 positions ``offset .. offset+S-1``, or (3,B,S) under
    mrope: with a vision prefix (``vision_seq`` < S) the patches sit on a
    sqrt(vision_seq) grid (t = 0, h = i // g, w = i % g) and the text
    tokens after it at a shared index starting one past the largest h;
    ``offset`` is added to every stream."""
    pos = (torch.arange(S, dtype=torch.int32, device=device)
           + offset).expand(B, S)
    if cfg.rope != "mrope":
        return pos
    vs = cfg.vision_seq
    if vs == 0 or S <= vs:
        return pos.expand(3, B, S)
    g = max(int(np.sqrt(vs)), 1)
    vis = np.arange(vs)
    hh, ww = (vis // g).astype(np.int32), (vis % g).astype(np.int32)
    text = np.arange(S - vs, dtype=np.int32) + int(np.max(hh)) + 1
    pos3 = np.stack([np.concatenate([np.zeros(vs, np.int32), text]),
                     np.concatenate([hh, text]),
                     np.concatenate([ww, text])])
    pos3 = torch.tensor(pos3, dtype=torch.int32, device=device) + offset
    return pos3[:, None, :].expand(3, B, S)


def _prefill_sublayer(p, cfg: ModelConfig, desc: Desc, x, positions, *,
                      capacity: int, cache_dtype):
    """Full-sequence forward that also emits the sub-layer's dense
    decode state.  Attention and MLA run the contiguous flash kernel;
    mamba the cold-start scan; the xLSTM blocks their recurrence from
    zero state."""
    _, norm = make_norm(cfg.norm)
    h = norm(p["norm1"], x)
    block = desc[0]
    if block == "attn":
        if cfg.n_heads:
            y, (k, v) = A.gqa_prefill(p["attn"], cfg, h, positions)
        else:   # a tensor-parallel rank without heads: a zero partial
            y = torch.zeros_like(h)
            k = v = h.new_zeros(h.shape[:2] + (0, cfg.resolved_head_dim))
        w = cfg.sliding_window
        cap = min(capacity, w) if w else capacity
        state = {"k": _seed_cache(k, cap, cache_dtype, w),
                 "v": _seed_cache(v, cap, cache_dtype, w)}
    elif block == "mla":
        y, (c, kr) = A.mla_prefill(p["attn"], cfg, h, positions)
        state = {"c": _seed_cache(c, capacity, cache_dtype, 0),
                 "kr": _seed_cache(kr, capacity, cache_dtype, 0)}
    elif block == "mamba":
        y, (conv, ssm) = M.mamba_forward(p["mamba"], cfg, h)
        state = {"conv": conv.to(cache_dtype), "ssm": ssm}
    else:
        forward = X.mlstm_forward if block == "mlstm" else X.slstm_forward
        y, carry = forward(p[block], cfg, h)
        state = dict(zip(X.STATE_LEAVES[block], carry))
    return _mlp_residual(p, cfg, desc, x + _reduce(block, y)), state


def _seed_cache(seq_kv, capacity: int, dtype, window: int):
    """Embed prefill K/V (B,S,...) into a new capacity-C cache buffer
    (contiguous, as the decode kernel reads it).

    With a sliding window keeps the last ``capacity`` tokens, each at
    its ring slot ``position % capacity`` (the order decode inserts
    continue); without one, the first ``capacity``."""
    B, S = seq_kv.shape[:2]
    buf = torch.zeros((B, capacity) + tuple(seq_kv.shape[2:]), dtype=dtype,
                      device=seq_kv.device)
    if window and S > capacity:
        slots = torch.arange(S - capacity, S, device=seq_kv.device) % capacity
        buf[:, slots] = seq_kv[:, S - capacity:].to(dtype)
    else:
        n = min(S, capacity)
        buf[:, :n] = seq_kv[:, :n]
    return buf


def _decode_sublayer(p, cfg: ModelConfig, desc: Desc, x, state, pos: int,
                     mla_absorb: bool = False):
    """One token through one sub-layer; ``state`` is updated in place
    (attention and MLA: the slice write at ``pos``; mamba: the new conv
    window copied over the old, the SSM state advanced in place by the
    scan, row b on slab b; xLSTM: the new carry copied over the old)."""
    _, norm = make_norm(cfg.norm)
    h = norm(p["norm1"], x)
    block = desc[0]
    if block == "attn":
        y = (A.gqa_decode(p["attn"], cfg, h, state["k"], state["v"], pos)[0]
             if cfg.n_heads else torch.zeros_like(h))
    elif block == "mla":
        y, _, _ = A.mla_decode(p["attn"], cfg, h, state["c"], state["kr"],
                               pos, absorb=mla_absorb)
    elif block == "mamba":
        ones = torch.ones((x.shape[0],), dtype=torch.int32, device=x.device)
        y, conv = M.mamba_slab_step(p["mamba"], cfg, h, state["conv"],
                                    state["ssm"], None, None, ones)
        state["conv"].copy_(conv)
    else:
        keys = X.STATE_LEAVES[block]
        decode = X.mlstm_decode if block == "mlstm" else X.slstm_decode
        y, new = decode(p[block], cfg, h, tuple(state[k] for k in keys))
        for k, a in zip(keys, new):
            state[k].copy_(a)
    return _mlp_residual(p, cfg, desc, x + _reduce(block, y))


def _index(tree, i: int):
    """Layer ``i`` of a stacked pytree, as views."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree, n: int) -> List[Dict[str, Any]]:
    """Every layer of a stacked pytree, as views: ``torch.unbind`` once a
    leaf, whose backward stacks the layers' gradients in one copy (a view
    per layer would write each layer's gradient into a zeroed stack of
    all ``n`` and add the stacks up)."""
    if isinstance(tree, dict):
        per = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree))


class TransformerLM:
    def __init__(self, cfg: ModelConfig, *, device=None,
                 mla_absorb: bool = False, remat: bool = False):
        """``mla_absorb``: MLA decode folds W_uk into the query and
        attends in the latent space (``attention.mla_decode``).
        ``remat``: the full-sequence forward checkpoints each period's
        body, so the backward recomputes it (``launch.train --remat``)."""
        self.cfg = cfg
        self.prefix_descs, self.period_descs, self.n_periods = layer_pattern(cfg)
        self.device = resolve_device(device)
        self.mla_absorb = mla_absorb
        self.remat = remat

    def _descs(self) -> List[Desc]:
        return list(self.prefix_descs) + list(self.period_descs)

    # -- params -------------------------------------------------------------
    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random weights drawn from ``seed`` on the model's device, with
        the reference's initializers (its numbers differ: another
        generator).  Periodic leaves are stacked on a leading layer axis."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        dtype = dtype_of(cfg.param_dtype)
        norm_params, _ = make_norm(cfg.norm)
        params: Dict[str, Any] = {
            "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype),
            "final_norm": norm_params(cfg.d_model, dtype, self.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                           dtype=dtype)
        if self.prefix_descs:
            params["prefix"] = [
                _sublayer_params(gen, cfg, d, dtype, cfg.prefix_d_ff or cfg.d_ff)
                for d in self.prefix_descs]
        blocks = {}
        for j, desc in enumerate(self.period_descs):
            blocks[f"s{j}"] = _stack_drawn(
                lambda: _sublayer_params(gen, cfg, desc, dtype, cfg.d_ff),
                self.n_periods)
        params["blocks"] = blocks
        if cfg.mtp_depth:
            # the multi-token-prediction head's leaves (its forward,
            # ``mtp_logits``, serves training: ROADMAP A15)
            params["mtp"] = {
                "norm_h": norm_params(cfg.d_model, dtype, self.device),
                "norm_e": norm_params(cfg.d_model, dtype, self.device),
                "proj": dense_init(gen, (2 * cfg.d_model, cfg.d_model),
                                   dtype=dtype),
                "layer": _sublayer_params(
                    gen, cfg, (self.period_descs[0][0], "dense"), dtype,
                    cfg.prefix_d_ff or cfg.d_ff)}
        return params

    # -- embedding / head ------------------------------------------------------
    def _embed(self, params, tokens, extra_embeds=None):
        """Token embeddings in the compute type; ``extra_embeds`` (B, n,
        d), the modality stub's patch embeddings, overwrite the first n
        positions.  A tensor-parallel rank that holds a vocab range looks
        up its own tokens, zeros elsewhere, and the ranks' rows are summed
        (one rank adds each row: the sum is exact)."""
        table = params["embed"]
        V = table.shape[0]
        if V < self.cfg.vocab_size:
            local = tokens.long() - S.current().rank * V
            ok = (local >= 0) & (local < V)
            x = torch.where(ok[..., None], table[local.clamp(0, V - 1)], 0)
            x = S.all_reduce(x.to(dtype_of(self.cfg.compute_dtype)))
        else:
            x = table[tokens.long()].to(dtype_of(self.cfg.compute_dtype))
        if extra_embeds is not None:
            n = extra_embeds.shape[1]
            x = torch.cat([extra_embeds.to(x.dtype), x[:, n:]], dim=1)
        return x

    def _head(self, params, x):
        cfg = self.cfg
        _, norm = make_norm(cfg.norm)
        h = norm(params["final_norm"], x)
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = h @ w.to(h.dtype)
        if w.shape[1] < cfg.vocab_size:
            # a vocab-parallel head: the ranks' columns, gathered whole
            logits = S.all_gather(logits, dim=-1)
        return logits

    # -- full-sequence forward ---------------------------------------------
    def _period(self, pp, x, aux, positions):
        """One period of the stack over its layer's weights ``pp``."""
        for j, desc in enumerate(self.period_descs):
            x, a = _apply_sublayer(pp[f"s{j}"], self.cfg, desc, x,
                                   positions)
            aux = aux + a
        return x, aux

    def apply(self, params, tokens, extra_embeds=None, positions=None):
        """tokens: (B,S) int32 -> (logits (B,S,V), the MoE aux loss summed
        over layers, f32).  ``extra_embeds`` overwrite the first
        positions' embeddings; ``positions`` default to
        ``make_positions``.  Differentiable; under ``remat`` (with grad
        on) each period's body is checkpointed."""
        B, S = tokens.shape
        if positions is None:
            positions = make_positions(self.cfg, B, S, device=tokens.device)
        x = self._embed(params, tokens, extra_embeds)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, desc in enumerate(self.prefix_descs):
            x, a = _apply_sublayer(params["prefix"][i], self.cfg, desc, x,
                                   positions)
            aux = aux + a
        for pp in _unbind(params["blocks"], self.n_periods):
            if self.remat and torch.is_grad_enabled():
                x, aux = torch.utils.checkpoint.checkpoint(
                    self._period, pp, x, aux, positions, use_reentrant=False)
            else:
                x, aux = self._period(pp, x, aux, positions)
        return self._head(params, x), aux

    def mtp_logits(self, params, hidden, tokens_next, positions):
        """The multi-token-prediction head (DeepSeek-V3): predict t+2 from
        ``hidden`` and the embedding of token t+1, through one dense
        sub-layer of the stack's attention kind and the LM head."""
        cfg = self.cfg
        _, norm = make_norm(cfg.norm)
        p = params["mtp"]
        e = params["embed"][tokens_next.long()].to(hidden.dtype)
        h = torch.cat([norm(p["norm_h"], hidden), norm(p["norm_e"], e)],
                      dim=-1)
        h = mm(h, p["proj"])
        h, _ = _apply_sublayer(p["layer"], cfg, (self.period_descs[0][0],
                                                 "dense"), h, positions)
        return self._head(params, h)

    def loss(self, params, batch):
        """batch: {"tokens": (B,S), "labels": (B,S), ["extra_embeds"]} ->
        the mean cross-entropy plus the MoE aux loss, plus 0.3 x the MTP
        head's cross-entropy when ``mtp_depth`` is set (f32 scalar).  As
        the reference, the MTP head reads the *embeddings* of
        ``tokens[:, :-1]`` as its hidden state, not the stack's final
        hidden state."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        logits, aux = self.apply(params, tokens, batch.get("extra_embeds"))
        total = softmax_xent(logits, labels) + aux
        if cfg.mtp_depth:
            B, S = tokens.shape
            positions = make_positions(cfg, B, S - 1, device=tokens.device)
            hidden = self._embed(params, tokens[:, :-1])
            mtp = self.mtp_logits(params, hidden, tokens[:, 1:], positions)
            total = total + 0.3 * softmax_xent(mtp, labels[:, 1:])
        return total

    # -- dense serving ------------------------------------------------------
    def init_cache(self, batch: int, capacity: int, dtype=torch.bfloat16):
        """Zeroed dense cache: per sub-layer state (``_sublayer_state``),
        periodic layers stacked on a leading layer axis."""
        cfg = self.cfg

        def state(desc, lead=()):
            one = _sublayer_state(cfg, desc, batch, capacity, dtype,
                                  self.device)
            return {k: v.expand(lead + tuple(v.shape)).contiguous()
                    for k, v in one.items()}

        cache: Dict[str, Any] = {}
        if self.prefix_descs:
            cache["prefix"] = [state(d) for d in self.prefix_descs]
        cache["blocks"] = {f"s{j}": state(d, (self.n_periods,))
                           for j, d in enumerate(self.period_descs)}
        return cache

    def prefill(self, params, tokens, capacity: int, extra_embeds=None,
                cache_dtype=torch.bfloat16):
        """tokens: (B,S) int32, every row at ``make_positions`` ->
        (last-token logits (B,V), a dense cache of ``capacity`` slots
        seeded with the prompt's state).  ``extra_embeds``: as
        ``apply``."""
        cfg = self.cfg
        B, S = tokens.shape
        positions = make_positions(cfg, B, S, device=tokens.device)
        x = self._embed(params, tokens, extra_embeds)
        kw = dict(capacity=capacity, cache_dtype=cache_dtype)
        cache: Dict[str, Any] = {}
        if self.prefix_descs:
            pc = []
            for i, desc in enumerate(self.prefix_descs):
                x, st = _prefill_sublayer(params["prefix"][i], cfg, desc, x,
                                          positions, **kw)
                pc.append(st)
            cache["prefix"] = pc
        per: List[Dict[str, Any]] = []
        for i in range(self.n_periods):
            states = {}
            for j, desc in enumerate(self.period_descs):
                x, states[f"s{j}"] = _prefill_sublayer(
                    _index(params["blocks"][f"s{j}"], i), cfg, desc, x,
                    positions, **kw)
            per.append(states)
        cache["blocks"] = _stack(per)
        return self._head(params, x[:, -1:, :])[:, 0], cache

    def decode_step(self, params, cache, token, pos: int):
        """token: (B,1) int32; ``pos``: host int, the position of this
        token in every row (on all three streams under mrope, as the
        reference) -> (logits (B,V), cache updated in place)."""
        cfg = self.cfg
        x = self._embed(params, token)
        for i, desc in enumerate(self.prefix_descs):
            x = _decode_sublayer(params["prefix"][i], cfg, desc, x,
                                 cache["prefix"][i], pos, self.mla_absorb)
        for i in range(self.n_periods):
            for j, desc in enumerate(self.period_descs):
                x = _decode_sublayer(_index(params["blocks"][f"s{j}"], i),
                                     cfg, desc, x,
                                     _index(cache["blocks"][f"s{j}"], i),
                                     pos, self.mla_absorb)
        return self._head(params, x)[:, 0], cache

    # -- paged serving ------------------------------------------------------
    def supports_paged(self) -> bool:
        """Block-paged serving covers GQA attention and the recurrent
        blocks (mamba/mlstm/slstm: per-slot state slabs) without sliding
        window or mrope (the reference's rule); the rest — MLA latent
        caches among them — serves dense."""
        cfg = self.cfg
        return (all(d[0] == "attn" or d[0] in RECURRENT_BLOCKS
                    for d in self._descs())
                and not cfg.sliding_window and cfg.rope != "mrope")

    def has_recurrent_state(self) -> bool:
        """True if any layer carries per-sequence recurrent state (the
        serving engine must then provision a ``StateStore``)."""
        return any(d[0] in RECURRENT_BLOCKS for d in self._descs())

    def has_cache_typed_state(self) -> bool:
        """True if any layer stores state in the cache type: attention
        K/V, an MLA latent cache, a mamba conv window.  The xLSTM
        carries are f32 whatever the cache type, so a pure xLSTM stack
        has none (a bf16 one serves over an f32 ``cache_dtype``)."""
        return any(d[0] not in X.STATE_LEAVES for d in self._descs())

    def has_kv_cache(self) -> bool:
        """True if any layer caches keys: attention K/V or an MLA latent
        cache, in the cache type."""
        return any(d[0] in ("attn", "mla") for d in self._descs())

    def state_slab_bytes(self, num_slots: int, dtype) -> int:
        """Device bytes of ``num_slots`` paged state slabs across every
        recurrent layer (the dump row is not counted: the reference's
        slab pools have none); 0 without recurrent layers."""
        descs = [(d, 1) for d in self.prefix_descs] + \
            [(d, self.n_periods) for d in self.period_descs]
        total = 0
        for desc, n in descs:
            if desc[0] in RECURRENT_BLOCKS:
                st = _sublayer_state(self.cfg, desc, num_slots, 0, dtype,
                                     "meta")
                total += n * sum(a.numel() * a.element_size()
                                 for a in st.values())
        return total

    def supports_prefix_sharing(self) -> bool:
        """KV pages are position-indexed and sharable; recurrent state
        summarizes the *whole* prefix and cannot be mapped mid-sequence,
        so any recurrent layer disables prefix sharing."""
        return self.supports_paged() and not self.has_recurrent_state()

    def supports_speculative(self) -> bool:
        """Rejected draft tokens roll back by arithmetic on ``lengths``;
        a recurrent slab advanced through them cannot, so any recurrent
        layer disables speculative mode."""
        return self.supports_paged() and not self.has_recurrent_state()

    def n_attn_layers(self) -> int:
        """Attention layers in the stack (the ones that own K/V pools)."""
        return (sum(d[0] == "attn" for d in self.prefix_descs)
                + self.n_periods * sum(d[0] == "attn"
                                       for d in self.period_descs))

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         dtype=torch.bfloat16, num_state_slots: int = 0,
                         kv_dtype: Optional[str] = None):
        """Shared block pool + recurrent state slabs.

        Every attention layer gets (nb, bs, KV, hd) K/V stores with no
        batch axis — slots share the pool through page tables.  Every
        recurrent layer gets slabs with a leading ``num_state_slots + 1``
        axis (the last row is the dump row, see ``_paged_sublayer_state``);
        the engine's ``StateStore`` hands out rows
        ``0..num_state_slots-1``.  ``kv_dtype="int8"`` makes the
        attention pools int8 with f32 per-row scale pools beside them.
        Periodic layers stack either kind on a leading layer axis."""
        cfg = self.cfg
        if not self.supports_paged():
            raise NotImplementedError(
                "paged cache needs an attn/mamba/mlstm/slstm stack without "
                f"sliding window/mrope (family={cfg.family!r})")
        if self.has_recurrent_state() and num_state_slots < 1:
            raise ValueError(
                f"family {cfg.family!r} has recurrent layers: "
                "init_paged_cache needs num_state_slots >= 1")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None or 'int8', "
                             f"got {kv_dtype!r}")

        def store(desc, lead=()):
            one = _paged_sublayer_state(cfg, desc, num_blocks, block_size,
                                        num_state_slots, dtype, self.device,
                                        kv_dtype)
            return {k: v.expand(lead + tuple(v.shape)).contiguous()
                    for k, v in one.items()}

        cache: Dict[str, Any] = {}
        if self.prefix_descs:
            cache["prefix"] = [store(d) for d in self.prefix_descs]
        cache["blocks"] = {f"s{j}": store(d, (self.n_periods,))
                           for j, d in enumerate(self.period_descs)}
        return cache

    def copy_paged_block(self, cache, src: int, dst: int):
        """COW fork: duplicate physical block ``src`` into ``dst`` across
        every attention layer's K/V store (and, under int8, its scale
        pools), in place.  Recurrent slabs are
        never shared (prefix sharing is off for recurrent stacks) and
        are left untouched."""
        for d, st in zip(self.prefix_descs, cache.get("prefix", [])):
            if d[0] == "attn":
                for a in st.values():
                    a[dst] = a[src]
        for j, d in enumerate(self.period_descs):
            if d[0] == "attn":
                for a in cache["blocks"][f"s{j}"].values():
                    a[:, dst] = a[:, src]
        return cache

    def gather_paged_pages(self, cache, blocks, slab: int):
        """Spill read: copy physical blocks ``blocks`` ((n,) int64 on the
        cache's device) out of every attention layer's pools (K/V, and
        under int8 the ``k_scale``/``v_scale`` pools) and state slab
        ``slab`` out of every recurrent layer (every leaf: mamba's conv
        window and SSM state, the xLSTM carries) into a standalone tree
        the engine parks in host memory while the slot is preempted.  Layout as ``copy_paged_block``: prefix leaves
        index axis 0, periodic leaves axis 1 (behind the layer axis)."""
        def take(st, desc, axis):
            if desc[0] == "attn":
                return {k: a.index_select(axis, blocks) for k, a in st.items()}
            return {k: a.select(axis, slab).clone() for k, a in st.items()}

        out: Dict[str, Any] = {}
        if self.prefix_descs:
            out["prefix"] = [take(st, d, 0) for d, st
                             in zip(self.prefix_descs, cache["prefix"])]
        out["blocks"] = {f"s{j}": take(cache["blocks"][f"s{j}"], d, 1)
                         for j, d in enumerate(self.period_descs)}
        return out

    def scatter_paged_pages(self, cache, payload, blocks, slab: int):
        """Spill write, the inverse of ``gather_paged_pages``, in place:
        the payload (on any device) lands at physical ``blocks`` and
        ``slab``, which may differ from where it was gathered.  Attention
        reads go through the page table and recurrent reads through the
        slot->slab map, so the restored slot decodes as if it had never
        been preempted."""
        def put(st, pst, desc, axis):
            for k, a in st.items():
                p = pst[k].to(a.device)
                if desc[0] == "attn":
                    a.index_copy_(axis, blocks, p)
                else:
                    a.select(axis, slab).copy_(p)

        for d, st, pst in zip(self.prefix_descs, cache.get("prefix", []),
                              payload.get("prefix", [])):
            put(st, pst, d, 0)
        for j, d in enumerate(self.period_descs):
            put(cache["blocks"][f"s{j}"], payload["blocks"][f"s{j}"], d, 1)
        return cache

    def paged_block_size(self, cache) -> Optional[int]:
        """The block size of the pool's attention layers (None without
        attention)."""
        stores = cache.get("prefix", []) + list(cache["blocks"].values())
        return next((st["k"].shape[-3] for st in stores if "k" in st), None)

    def paged_step(self, params, cache, tokens, page_table, lengths, t_valid,
                   state_slots=None, *, all_logits: bool = False,
                   index=None):
        """Advance each slot by up to T tokens through the paged cache.

        tokens: (B,T) int32; page_table: (B,P) int32; lengths: (B,)
        tokens already cached per slot; t_valid: (B,) in [0,T] tokens of
        this call that are real per slot; state_slots: (B,) int32 slab
        of each slot's recurrent state (default: row ``b`` owns slab
        ``b``; the engine passes its ``StateStore`` assignment).  Covers
        decode (T=1) and chunked prefill (T=chunk) uniformly; slots may
        mix phases.  The cache is updated in place.  Returns (logits
        (B,V) at each slot's last valid token, cache) — or (logits
        (B,T,V) at every position, cache) under ``all_logits`` (rows past
        ``t_valid`` are garbage).  ``index``: the step's
        ``paged_write_index``, when the caller has it (a tensor-parallel
        step computes it once per device for every rank).
        """
        if state_slots is None:
            state_slots = torch.arange(tokens.shape[0], dtype=torch.int32,
                                       device=tokens.device)
        cfg = self.cfg
        block_size = self.paged_block_size(cache)
        # every attention layer writes through one index, so the step
        # pays its selection's host sync once, not once per layer
        if index is None and block_size is not None:
            index = A.paged_write_index(page_table, lengths, t_valid,
                                        tokens.shape[1], block_size)
        # and every recurrent layer addresses its slabs through one set of
        # rows; the dump row is the last of the slab axis, axis 1 behind
        # the layer axis (recurrent blocks are periodic: ``layer_pattern``)
        n_rows = next((next(iter(st.values())).shape[1] for d, st in
                       zip(self.period_descs, cache["blocks"].values())
                       if d[0] in RECURRENT_BLOCKS), None)
        slabs = (None if n_rows is None else
                 _slab_rows(lengths, t_valid, state_slots, n_rows - 1))
        x = self._embed(params, tokens)
        for i, desc in enumerate(self.prefix_descs):
            x = _paged_sublayer(params["prefix"][i], cfg, desc, x,
                                cache["prefix"][i], page_table, lengths,
                                t_valid, slabs, index)
        for i in range(self.n_periods):
            for j, desc in enumerate(self.period_descs):
                x = _paged_sublayer(_index(params["blocks"][f"s{j}"], i),
                                    cfg, desc, x,
                                    _index(cache["blocks"][f"s{j}"], i),
                                    page_table, lengths, t_valid,
                                    slabs, index)
        if all_logits:
            return self._head(params, x), cache
        if tokens.shape[1] == 1:
            # decode steps: the only valid token is position 0
            x_last = x
        else:
            last = (t_valid - 1).clamp(min=0).long()             # (B,)
            x_last = x[torch.arange(x.shape[0], device=x.device), last][:, None]
        return self._head(params, x_last)[:, 0], cache


def softmax_xent(logits, labels):
    """Mean over positions of the f32 logsumexp minus the gold logit."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def _stack(layers: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack a list of identically-shaped pytrees on a new leading axis."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([l[k] for l in layers]) for k in first}
    return torch.stack(layers)


def _stack_drawn(draw, n: int) -> Dict[str, Any]:
    """``_stack`` of ``n`` pytrees drawn by ``draw()`` in turn, each copied
    into the stacked leaves as soon as it is drawn: at most the stack and
    one drawn tree are held, not every tree twice (4 of nemotron-4-340b's
    layers are 27.6 GB in bf16)."""
    out = None

    def put(dst, src, i):
        if isinstance(src, dict):
            for k in src:
                put(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    def empty(t):
        if isinstance(t, dict):
            return {k: empty(v) for k, v in t.items()}
        return t.new_empty((n,) + tuple(t.shape))

    for i in range(n):
        tree = draw()
        if out is None:
            out = empty(tree)
        put(out, tree, i)
        del tree
    return out
