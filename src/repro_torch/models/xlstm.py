"""xLSTM blocks — sLSTM (scalar memory, recurrent) + mLSTM (matrix
memory) [arXiv:2405.04517] (port of ``repro/models/xlstm.py``).

mLSTM has no hidden-to-hidden weights: the stabilized recurrence runs
one time step at a time here (the reference's ``lax.scan``), for prefill
and for the paged and dense decode steps alike.  State per layer: C
(B,H,dk,dv), n (B,H,dk), m (B,H), all f32 whatever the model's type —
constant size per sequence.  sLSTM has true recurrence (block-diagonal
per-head R matrices); state (h, c, n, m) each (B,di) f32.

Plain torch, no kernel: the reference has none (ROADMAP Queue B lists a
fused mLSTM step as later work).  The arithmetic keeps the reference's
order and types: the log-space stabilizer ``m``, ``max(|n.q|, 1)``,
``max(n, 1e-6)`` in sLSTM, ``log_sigmoid`` on the forget gate, the f32
``w_if``/``b_if``/``R``/``b`` leaves inside a bf16 model.

Both blocks carry their own up/down projections (the configs have
d_ff = 0: no separate FFN).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .common import dense_init, mm
from .config import ModelConfig

EXPAND = 2  # projection factor for both block types
NEG_PAD = -1e30
# each block's state leaves, in its carry's order (all f32)
STATE_LEAVES = {"mlstm": ("C", "n", "m"), "slstm": ("h", "cs", "ns", "ms")}


def _dims(cfg: ModelConfig):
    di = EXPAND * cfg.d_model
    H = cfg.n_heads
    dh = di // H
    return di, H, dh


def init_state(cfg: ModelConfig, block: str, batch: int, device=None):
    """Zero state of one ``block`` ("mlstm" or "slstm") for ``batch``
    rows: the named f32 leaves of ``STATE_LEAVES[block]``, in order."""
    di, H, dh = _dims(cfg)
    shapes = {"C": (H, dh, dh), "n": (H, dh), "m": (H,), "h": (di,),
              "cs": (di,), "ns": (di,), "ms": (di,)}
    return {k: torch.zeros((batch,) + shapes[k], dtype=torch.float32,
                           device=device) for k in STATE_LEAVES[block]}


# -- mLSTM --------------------------------------------------------------------

def mlstm_params(gen: torch.Generator, cfg: ModelConfig, dtype):
    d = cfg.d_model
    di, H, dh = _dims(cfg)
    dev = gen.device
    return {
        "up": dense_init(gen, (d, 2 * di), dtype=dtype),
        "wq": dense_init(gen, (di, di), dtype=dtype),
        "wk": dense_init(gen, (di, di), dtype=dtype),
        "wv": dense_init(gen, (di, di), dtype=dtype),
        "w_if": dense_init(gen, (di, 2 * H), dtype=torch.float32),
        "b_if": torch.cat([torch.zeros((H,), device=dev),
                           torch.full((H,), 3.0, device=dev)]),
        "down": dense_init(gen, (di, d), dtype=dtype),
    }


def _mlstm_step(carry, xs):
    C, n, m = carry                                     # (B,H,dk,dv),(B,H,dk),(B,H)
    q_t, k_t, v_t, li_t, lf_t = xs
    m_new = torch.maximum(lf_t + m, li_t)
    i_t = torch.exp(li_t - m_new)                       # (B,H)
    f_t = torch.exp(lf_t + m - m_new)
    C = f_t[..., None, None] * C + i_t[..., None, None] * \
        (k_t[..., :, None] * v_t[..., None, :])
    n = f_t[..., None] * n + i_t[..., None] * k_t
    num = torch.einsum("bhkv,bhk->bhv", C, q_t)
    den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, q_t)), min=1.0)
    h_t = num / den[..., None]
    return (C, n, m_new), h_t


def _mlstm_inputs(p, cfg: ModelConfig, x):
    """Projections of x (B,S,d): q, k, v (B,S,H,dh) f32, log_i, log_f
    (B,S,H) f32, and the output gate's z (B,S,di) in x's type."""
    B, S, _ = x.shape
    di, H, dh = _dims(cfg)
    up = mm(x, p["up"])
    xi, z = up[..., :di], up[..., di:]                  # (B,S,di)
    q = mm(xi, p["wq"]).reshape(B, S, H, dh) / np.sqrt(dh)
    k = mm(xi, p["wk"]).reshape(B, S, H, dh) / np.sqrt(dh)
    v = mm(xi, p["wv"]).reshape(B, S, H, dh)
    gates = xi.float() @ p["w_if"] + p["b_if"]          # (B,S,2H)
    log_i, log_f = gates[..., :H], F.logsigmoid(gates[..., H:])
    return q.float(), k.float(), v.float(), log_i, log_f, z


def _mlstm_out(p, h, z):
    return mm(h * F.silu(z), p["down"])


def mlstm_forward(p, cfg: ModelConfig, x, *, chunk_size: int = 64):
    """x: (B,S,d) -> (y, state) from zero state.  The time axis is cut
    into ``chunk_size`` chunks as the reference's scan does, the last
    one padded with ``log_i = NEG_PAD``, ``log_f = 0`` and zero q/k/v
    (steps that leave the state as it was), so the carried state is the
    reference's."""
    B, S, _ = x.shape
    di = _dims(cfg)[0]
    q, k, v, log_i, log_f, z = _mlstm_inputs(p, cfg, x)
    ct = min(chunk_size, S)
    pad = -(-S // ct) * ct - S

    def prep(a, fill=0.0):  # (B,S,...) -> (S+pad, B, ...)
        if pad:
            a = torch.cat([a, torch.full((B, pad) + tuple(a.shape[2:]), fill,
                                         dtype=a.dtype, device=a.device)], 1)
        return a.movedim(1, 0)

    xs = (prep(q), prep(k), prep(v), prep(log_i, NEG_PAD), prep(log_f))
    state = tuple(init_state(cfg, "mlstm", B, x.device).values())
    hs = []
    for t in range(S + pad):
        state, h_t = _mlstm_step(state, tuple(a[t] for a in xs))
        hs.append(h_t)
    h = torch.stack(hs[:S], 1).reshape(B, S, di).to(x.dtype)
    return _mlstm_out(p, h, z), state


def _mask_carry(new, old, keep):
    """Per-row select over a tuple-of-tensors carry: row ``b`` advances
    iff ``keep[b]`` (shared by the paged steps of both block types)."""
    return tuple(torch.where(keep.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
                 for a, b in zip(new, old))


def mlstm_paged_step(p, cfg: ModelConfig, x, state, t_valid):
    """Advance each row by up to T tokens from carried per-row state.

    x: (B,T,d); state: (C, n, m) f32; t_valid: (B,) int32 — row ``b``
    consumes only its first ``t_valid[b]`` tokens (outputs past that are
    garbage the caller ignores).  The same ``_mlstm_step`` as
    ``mlstm_forward``; at T = 1 the loop is one step, as the reference's
    decode fast path (bitwise its length-1 scan).  Returns (y, new
    state)."""
    B, T, _ = x.shape
    di = _dims(cfg)[0]
    q, k, v, log_i, log_f, z = _mlstm_inputs(p, cfg, x)
    hs = []
    for t in range(T):
        new, h_t = _mlstm_step(state, (q[:, t], k[:, t], v[:, t],
                                       log_i[:, t], log_f[:, t]))
        state = _mask_carry(new, state, t < t_valid)
        hs.append(h_t)
    h = torch.stack(hs, 1).reshape(B, T, di).to(x.dtype)
    return _mlstm_out(p, h, z), state


def mlstm_decode(p, cfg: ModelConfig, x, state):
    """One token: x (B,1,d).  The T = 1 case of ``mlstm_paged_step``."""
    ones = torch.ones((x.shape[0],), dtype=torch.int32, device=x.device)
    return mlstm_paged_step(p, cfg, x, state, ones)


# -- sLSTM --------------------------------------------------------------------

def slstm_params(gen: torch.Generator, cfg: ModelConfig, dtype):
    d = cfg.d_model
    di, H, dh = _dims(cfg)
    return {
        "up": dense_init(gen, (d, di), dtype=dtype),
        "W": dense_init(gen, (di, 4 * di), dtype=dtype),
        # block-diagonal recurrent weights: (H, dh, 4*dh)
        "R": dense_init(gen, (H, dh, 4 * dh), in_axis=1, dtype=torch.float32),
        "b": torch.zeros((4 * di,), dtype=torch.float32, device=gen.device),
        "down": dense_init(gen, (di, d), dtype=dtype),
    }


def _slstm_step(p, cfg: ModelConfig, wx_t, state):
    """wx_t: (B,4di) precomputed W x_t.  state: (h,c,n,m) each (B,di)."""
    di, H, dh = _dims(cfg)
    h, c, n, m = state
    rh = torch.einsum("bhk,hkg->bhg", h.reshape(-1, H, dh),
                      p["R"]).reshape(-1, 4 * di)
    pre = wx_t.float() + rh + p["b"]
    zi, ii, fi, oi = pre.split(di, dim=-1)
    z_t = torch.tanh(zi)
    o_t = torch.sigmoid(oi)
    li = ii                                   # log-space input gate
    lf = F.logsigmoid(fi)
    m_new = torch.maximum(lf + m, li)
    i_t = torch.exp(li - m_new)
    f_t = torch.exp(lf + m - m_new)
    c_new = f_t * c + i_t * z_t
    n_new = f_t * n + i_t
    h_new = o_t * c_new / torch.clamp(n_new, min=1e-6)
    return (h_new, c_new, n_new, m_new)


def _slstm_wx(p, x):
    return mm(mm(x, p["up"]), p["W"])                   # (B,S,4di)


def slstm_forward(p, cfg: ModelConfig, x, *, chunk_size: int = 64):
    """x: (B,S,d) -> (y, state) from zero state.  As the reference, the
    last ``chunk_size`` chunk is padded with zero ``W x`` rows that the
    recurrence runs through, so the returned state is the one after the
    padding steps (the outputs at the padded steps are dropped)."""
    B, S, _ = x.shape
    di = _dims(cfg)[0]
    wx = _slstm_wx(p, x)
    ct = min(chunk_size, S)
    pad = -(-S // ct) * ct - S
    if pad:
        wx = torch.cat([wx, wx.new_zeros((B, pad, 4 * di))], 1)
    state = tuple(init_state(cfg, "slstm", B, x.device).values())
    hs = []
    for t in range(S + pad):
        state = _slstm_step(p, cfg, wx[:, t], state)
        hs.append(state[0])
    h = torch.stack(hs[:S], 1).to(x.dtype)
    return mm(h, p["down"]), state


def slstm_paged_step(p, cfg: ModelConfig, x, state, t_valid):
    """Advance each row by up to T tokens from carried per-row state.

    x: (B,T,d); state: (h, c, n, m) each (B,di) f32; t_valid: (B,)
    int32 caps how many of the T tokens are real per row.  The same
    ``_slstm_step`` as ``slstm_forward``, as the T = 1 decode too."""
    wx = _slstm_wx(p, x)
    hs = []
    for t in range(x.shape[1]):
        new = _slstm_step(p, cfg, wx[:, t], state)
        state = _mask_carry(new, state, t < t_valid)
        hs.append(new[0])
    h = torch.stack(hs, 1).to(x.dtype)                  # (B,T,di)
    return mm(h, p["down"]), state


def slstm_decode(p, cfg: ModelConfig, x, state):
    """One token: x (B,1,d).  The T = 1 case of ``slstm_paged_step``."""
    ones = torch.ones((x.shape[0],), dtype=torch.int32, device=x.device)
    return slstm_paged_step(p, cfg, x, state, ones)

