"""Decoder-only transformer, dense family (port of the paged serving
subset of ``repro/models/transformer.py``).

A config expands to a *layer pattern*: a repeating ``period`` of
sub-layer descriptors applied ``n_periods`` times.  Parameters keep the
JAX package's layout — the periodic blocks' leaves are stacked on a
leading layer axis (``params["blocks"]["s0"]["attn"]["wq"]`` is
(n_layers, d, H*hd)) — so the weight bridge maps leaf to leaf, and a
layer reads its weights as views of the stacked tensors.

Sub-layer descriptor: (block, mlp) with block = "attn", mlp = "dense".
The recurrent, MoE/MLA and encoder-decoder families are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from . import attention as A
from .common import (dense_init, dtype_of, embed_init, make_norm,
                     resolve_device)
from .config import ModelConfig
from .mlp import mlp_forward, mlp_params

Desc = Tuple[str, str]

_NOT_PORTED = {"moe": "A12 (MoE/MLA)", "hybrid": "A10 (recurrent families)",
               "ssm": "A10 (recurrent families)",
               "encdec": "A13 (encoder-decoder)",
               "audio": "A13 (encoder-decoder)",
               "vlm": "A13 (mrope/vision, dense engine)"}


def layer_pattern(cfg: ModelConfig) -> Tuple[List[Desc], List[Desc], int]:
    """Returns (prefix_descs, period_descs, n_periods)."""
    if cfg.family == "dense" and not cfg.n_enc_layers:
        return [], [("attn", "dense")], cfg.n_layers
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP "
        f"{_NOT_PORTED.get(cfg.family, 'A10-A13')})")


def _sublayer_params(gen, cfg: ModelConfig, dtype, dense_ff: int):
    norm_params, _ = make_norm(cfg.norm)
    return {"norm1": norm_params(cfg.d_model, dtype, gen.device),
            "attn": A.gqa_params(gen, cfg, dtype),
            "norm2": norm_params(cfg.d_model, dtype, gen.device),
            "mlp": mlp_params(gen, cfg.d_model, dense_ff, cfg.mlp_act, dtype)}


def _paged_sublayer(p, cfg: ModelConfig, x, state, page_table, lengths,
                    t_valid):
    """Multi-token step through the paged serving cache: attention reads
    and writes the shared block pool through the page table (in place),
    then the dense MLP.  Same norm/residual order as the reference."""
    _, norm = make_norm(cfg.norm)
    h = norm(p["norm1"], x)
    y, _, _ = A.gqa_paged_step(p["attn"], cfg, h, state["k"], state["v"],
                               page_table, lengths, t_valid)
    x = x + y
    h = norm(p["norm2"], x)
    return x + mlp_forward(p["mlp"], cfg.mlp_act, h)


def _index(tree, i: int):
    """Layer ``i`` of a stacked pytree, as views."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


class TransformerLM:
    def __init__(self, cfg: ModelConfig, *, device=None):
        self.cfg = cfg
        self.prefix_descs, self.period_descs, self.n_periods = layer_pattern(cfg)
        self.device = resolve_device(device)

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
        blocks = {}
        for j in range(len(self.period_descs)):
            layers = [_sublayer_params(gen, cfg, dtype, cfg.d_ff)
                      for _ in range(self.n_periods)]
            blocks[f"s{j}"] = _stack(layers)
        params["blocks"] = blocks
        return params

    # -- embedding / head ------------------------------------------------------
    def _embed(self, params, tokens):
        return params["embed"][tokens.long()].to(dtype_of(self.cfg.compute_dtype))

    def _head(self, params, x):
        cfg = self.cfg
        _, norm = make_norm(cfg.norm)
        h = norm(params["final_norm"], x)
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return h @ w.to(h.dtype)

    # -- paged serving ------------------------------------------------------
    def supports_paged(self) -> bool:
        """Block-paged serving covers GQA attention stacks without
        sliding window or mrope."""
        cfg = self.cfg
        return (all(d[0] == "attn" for d in self.period_descs)
                and not cfg.sliding_window and cfg.rope != "mrope")

    def has_recurrent_state(self) -> bool:
        """True if any layer carries per-sequence recurrent state (none
        in the ported families)."""
        return False

    def supports_prefix_sharing(self) -> bool:
        """KV pages are position-indexed and sharable."""
        return self.supports_paged() and not self.has_recurrent_state()

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         dtype=torch.bfloat16, kv_dtype: Optional[str] = None):
        """Shared block pool: every attention layer gets (nb, bs, KV, hd)
        K/V stores with no batch axis — slots share the pool through page
        tables — stacked on a leading layer axis like the params."""
        cfg = self.cfg
        if not self.supports_paged():
            raise NotImplementedError(
                "paged cache needs a GQA attention stack without sliding "
                "window/mrope")
        if kv_dtype is not None:
            raise NotImplementedError(
                f"kv_dtype={kv_dtype!r}: int8 KV is not ported yet (ROADMAP A9)")
        shape = (self.n_periods, num_blocks, block_size, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        return {"blocks": {
            f"s{j}": {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                      "v": torch.zeros(shape, dtype=dtype, device=self.device)}
            for j in range(len(self.period_descs))}}

    def copy_paged_block(self, cache, src: int, dst: int):
        """COW fork: duplicate physical block ``src`` into ``dst`` across
        every layer's K/V store, in place."""
        for st in cache["blocks"].values():
            for a in st.values():
                a[:, dst] = a[:, src]
        return cache

    def paged_step(self, params, cache, tokens, page_table, lengths, t_valid,
                   *, all_logits: bool = False):
        """Advance each slot by up to T tokens through the paged cache.

        tokens: (B,T) int32; page_table: (B,P) int32; lengths: (B,)
        tokens already cached per slot; t_valid: (B,) in [0,T] tokens of
        this call that are real per slot.  Covers decode (T=1) and
        chunked prefill (T=chunk) uniformly; slots may mix phases.  The
        cache is updated in place.  Returns (logits (B,V) at each slot's
        last valid token, cache) — or (logits (B,T,V) at every position,
        cache) under ``all_logits`` (rows past ``t_valid`` are garbage).
        """
        x = self._embed(params, tokens)
        for i in range(self.n_periods):
            for j in range(len(self.period_descs)):
                x = _paged_sublayer(_index(params["blocks"][f"s{j}"], i),
                                    self.cfg, x,
                                    _index(cache["blocks"][f"s{j}"], i),
                                    page_table, lengths, t_valid)
        if all_logits:
            return self._head(params, x), cache
        if tokens.shape[1] == 1:
            # decode steps: the only valid token is position 0
            x_last = x
        else:
            last = (t_valid - 1).clamp(min=0).long()             # (B,)
            x_last = x[torch.arange(x.shape[0], device=x.device), last][:, None]
        return self._head(params, x_last)[:, 0], cache


def _stack(layers: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack a list of identically-shaped pytrees on a new leading axis."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([l[k] for l in layers]) for k in first}
    return torch.stack(layers)
