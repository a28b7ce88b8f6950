"""Whisper-style encoder-decoder [arXiv:2212.04356] (port of
``repro/models/encdec.py``).

The audio frontend (mel spectrogram and the two convolutions) is a stub,
as in the JAX package: the encoder takes precomputed frame embeddings
(B, enc_seq, d_model) (``frontends.fake_audio_frames``).  After them:
sinusoidal encoder positions, a bidirectional encoder stack, a causal
decoder with learned positions and cross-attention, and the tied LM
head.  Parameters keep the reference's tree (``enc_blocks`` and
``dec_blocks`` stacked on a leading layer axis), so the weight bridge
maps leaf to leaf.

On a CUDA device every attention runs a hand-written kernel: the
encoder's self-attention and the decoder's cross-attention in ``apply``
and ``prefill`` the contiguous flash kernel without the causal mask (S
decoder queries over T encoder keys, S free of T), the decoder's
self-attention the causal one; ``decode_step`` runs the dense decode
kernel for the self-attention and for the cross-attention over the whole
cross cache (``n_valid = enc_seq``: one query without a mask).  The dense
serving cache holds the decoder's K/V and the cross K/V, computed once
at prefill.  The block-paged engine does not serve this model (as in the
reference), and neither does the engine's continuous API, which carries
no encoder frames: ``ServeEngine.generate_batch(extra_embeds=frames)``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import attention as A
from ..kernels.decode_attention import ops as decode_ops
from .common import dtype_of, embed_init, make_norm, mm, resolve_device
from .config import ModelConfig
from .mlp import mlp_forward, mlp_params
from .transformer import _index, _seed_cache, _stack


def _sinusoid(length: int, d: int, device=None) -> torch.Tensor:
    """(length, d) f32: sin then cos of ``pos / 10000^(2i/d)``, computed
    in f64 as the reference's numpy does."""
    pos = np.arange(length)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * dim / d))
    return torch.tensor(np.concatenate([np.sin(ang), np.cos(ang)], axis=1),
                        dtype=torch.float32, device=device)


class EncDecLM:
    def __init__(self, cfg: ModelConfig, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- params -------------------------------------------------------------
    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random weights drawn from ``seed`` on the model's device, with
        the reference's initializers and tree (its numbers differ: another
        generator)."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        dtype = dtype_of(cfg.param_dtype)
        norm_params, _ = make_norm(cfg.norm)
        d, dev = cfg.d_model, self.device

        def enc_layer():
            return {"norm1": norm_params(d, dtype, dev),
                    "attn": A.gqa_params(gen, cfg, dtype),
                    "norm2": norm_params(d, dtype, dev),
                    "mlp": mlp_params(gen, d, cfg.d_ff, cfg.mlp_act, dtype)}

        def dec_layer():
            return {"norm1": norm_params(d, dtype, dev),
                    "attn": A.gqa_params(gen, cfg, dtype),
                    "norm_x": norm_params(d, dtype, dev),
                    "xattn": A.gqa_params(gen, cfg, dtype),
                    "norm2": norm_params(d, dtype, dev),
                    "mlp": mlp_params(gen, d, cfg.d_ff, cfg.mlp_act, dtype)}

        return {
            "embed": embed_init(gen, (cfg.vocab_size, d), dtype),
            "dec_pos": embed_init(gen, (cfg.max_seq, d), dtype),
            "enc_blocks": _stack([enc_layer()
                                  for _ in range(cfg.n_enc_layers)]),
            "enc_norm": norm_params(d, dtype, dev),
            "dec_blocks": _stack([dec_layer() for _ in range(cfg.n_layers)]),
            "final_norm": norm_params(d, dtype, dev),
        }

    # -- the serving engine's probes (its dense mode only) -----------------
    def supports_paged(self) -> bool:
        return False

    def has_kv_cache(self) -> bool:
        return True

    # -- encoder --------------------------------------------------------------
    def encode(self, params, frames):
        """frames: (B, T, d) stub embeddings -> encoder states (B, T, d)
        in the compute type."""
        cfg = self.cfg
        if frames is None:
            raise ValueError("an encoder-decoder needs its encoder frames "
                             "(extra_embeds (B, enc_seq, d_model))")
        _, norm = make_norm(cfg.norm)
        B, T = frames.shape[:2]
        x = frames.to(dtype_of(cfg.compute_dtype))
        x = x + _sinusoid(T, cfg.d_model, x.device).to(x.dtype)[None]
        pos = torch.zeros((B, T), dtype=torch.int32, device=x.device)
        for i in range(cfg.n_enc_layers):
            p = _index(params["enc_blocks"], i)
            x = x + A.gqa_forward(p["attn"], cfg, norm(p["norm1"], x), pos,
                                  causal=False)
            x = x + mlp_forward(p["mlp"], cfg.mlp_act, norm(p["norm2"], x))
        return norm(params["enc_norm"], x)

    # -- decoder --------------------------------------------------------------
    def _dec_embed(self, params, tokens, pos0: int):
        """Token plus learned position embeddings of positions ``pos0 ..
        pos0+S-1``, added in the parameter type, in the compute type."""
        S = tokens.shape[1]
        table = params["dec_pos"]
        if pos0 + S > table.shape[0]:
            raise ValueError(f"decoder position table too small "
                             f"({table.shape[0]} < {pos0 + S})")
        x = params["embed"][tokens.long()] + table[pos0: pos0 + S][None]
        return x.to(dtype_of(self.cfg.compute_dtype))

    def _head(self, params, x):
        _, norm = make_norm(self.cfg.norm)
        h = norm(params["final_norm"], x)
        return h @ params["embed"].T.to(h.dtype)                # tied head

    def _dec_layer(self, p, x, enc_kv, positions):
        """One decoder layer over the whole sequence -> (x, (k, v)): its
        causal self-attention's K/V for the cache."""
        cfg = self.cfg
        _, norm = make_norm(cfg.norm)
        y, kv = A.gqa_prefill(p["attn"], cfg, norm(p["norm1"], x), positions)
        x = x + y
        x = x + A.cross_attention(p["xattn"], cfg, norm(p["norm_x"], x),
                                  *enc_kv)
        x = x + mlp_forward(p["mlp"], cfg.mlp_act, norm(p["norm2"], x))
        return x, kv

    def apply(self, params, tokens, extra_embeds=None, positions=None):
        """The full-sequence forward.  tokens: (B, S) int32 at decoder
        positions 0..S-1; ``extra_embeds``: the encoder frames (B, T, d)
        -> (logits (B, S, V), a zero aux loss).  ``positions`` is unused
        (learned positions), as in the reference."""
        del positions
        enc = self.encode(params, extra_embeds)
        x = self._dec_embed(params, tokens, 0)
        pos = torch.zeros(tokens.shape, dtype=torch.int32, device=x.device)
        for i in range(self.cfg.n_layers):
            p = _index(params["dec_blocks"], i)
            x, _ = self._dec_layer(p, x, A.cross_kv(p["xattn"], self.cfg, enc),
                                   pos)
        return self._head(params, x), torch.zeros((), dtype=torch.float32,
                                                  device=x.device)

    # -- dense serving ------------------------------------------------------
    def init_cache(self, batch: int, capacity: int, dtype=torch.bfloat16):
        """Zeroed dense cache: the decoder's self-attention K/V (L, batch,
        capacity, KV, hd) and the cross K/V (L, batch, enc_seq, KV, hd)."""
        cfg = self.cfg
        kv, hd, L = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers

        def z(n):
            return torch.zeros((L, batch, n, kv, hd), dtype=dtype,
                               device=self.device)
        return {"k": z(capacity), "v": z(capacity),
                "cross_k": z(cfg.enc_seq), "cross_v": z(cfg.enc_seq)}

    def prefill(self, params, tokens, capacity: int, extra_embeds=None,
                cache_dtype=torch.bfloat16):
        """Encode the frames, run the prompt (B, S) through the decoder ->
        (last-token logits (B, V), a dense cache of ``capacity`` slots
        seeded with the prompt's K/V, and the cross K/V in the cache
        type)."""
        enc = self.encode(params, extra_embeds)
        x = self._dec_embed(params, tokens, 0)
        pos = torch.zeros(tokens.shape, dtype=torch.int32, device=x.device)
        per = []
        for i in range(self.cfg.n_layers):
            p = _index(params["dec_blocks"], i)
            ck, cv = A.cross_kv(p["xattn"], self.cfg, enc)
            x, (k, v) = self._dec_layer(p, x, (ck, cv), pos)
            per.append({"k": _seed_cache(k, capacity, cache_dtype, 0),
                        "v": _seed_cache(v, capacity, cache_dtype, 0),
                        "cross_k": ck.to(cache_dtype),
                        "cross_v": cv.to(cache_dtype)})
        return self._head(params, x[:, -1:])[:, 0], _stack(per)

    def decode_step(self, params, cache, token, pos: int):
        """token: (B, 1) int32 at decoder position ``pos`` (a host int,
        clamped to the position table as the reference's traced decode
        clamps it) -> (logits (B, V), cache updated in place)."""
        cfg = self.cfg
        _, norm = make_norm(cfg.norm)
        pos = int(pos)
        x = self._dec_embed(params, token,
                            min(pos, params["dec_pos"].shape[0] - 1))
        B = token.shape[0]
        for i in range(cfg.n_layers):
            p, c = _index(params["dec_blocks"], i), _index(cache, i)
            y, _, _ = A.gqa_decode(p["attn"], cfg, norm(p["norm1"], x),
                                   c["k"], c["v"], pos)
            x = x + y
            q, _, _ = A._project_qkv(p["xattn"], cfg, norm(p["norm_x"], x),
                                     kv=False)
            y = decode_ops.decode_attention(q[:, 0].contiguous(),
                                            c["cross_k"], c["cross_v"],
                                            c["cross_k"].shape[1])
            x = x + mm(y.reshape(B, 1, -1), p["xattn"]["wo"])
            x = x + mlp_forward(p["mlp"], cfg.mlp_act, norm(p["norm2"], x))
        return self._head(params, x)[:, 0], cache
