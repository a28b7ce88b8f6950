"""Mamba (S6) block, the SSM layer of Jamba [arXiv:2403.19887] (port of
the serving subset of ``repro/models/mamba.py``).

State per sequence: a conv window (B, d_conv-1, d_inner) in the cache
type and an SSM state (B, d_inner, d_state) in f32 — constant size per
token.  ``mamba_forward`` runs a whole prompt from zero state (the
dense engine's prefill) and returns the state it leaves;
``mamba_slab_step`` advances each row by up to T tokens from its
carried state, read and written in place in a slab pool (the serving
engines' state; the reference's ``mamba_paged_step`` and
``mamba_decode`` are its cases with row b on slab b).  Both run
the recurrence through the selective-scan kernel (``kernels/ssm_scan``)
on a CUDA device and through its plain version on the CPU.  Everything
around it (projections, the conv taps, softplus, the gate) stays torch
ops in the reference's order and types.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssm_scan import ops as scan_ops
from . import sharding as S
from .common import dense_init, mm
from .config import ModelConfig


def mamba_params(gen: torch.Generator, cfg: ModelConfig, dtype):
    """``A_log`` and ``D`` stay float32 inside a model of any type, as in
    the reference."""
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm.d_state
    dc, dtr = cfg.ssm.d_conv, cfg.dt_rank
    dev = gen.device
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": dense_init(gen, (d, 2 * di), dtype=dtype),
        "conv_w": dense_init(gen, (dc, di), dtype=dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, (di, dtr + 2 * N), dtype=dtype),
        "dt_proj": dense_init(gen, (dtr, di), dtype=dtype),
        "dt_bias": torch.zeros((di,), dtype=dtype, device=dev),
        "A_log": torch.log(A).expand(di, N).contiguous(),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (di, d), dtype=dtype),
    }


def _conv_taps(xp, w, b, T: int):
    """Depthwise causal conv over a left-extended input.

    xp: (B, dc-1+T, di) — the dc-1 tokens of history followed by the T
    new tokens; w: (dc, di).  Returns (B, T, di).  Taps are added in the
    reference's order (its bitwise consistency between prefill, dense
    decode and the paged step rests on it)."""
    dc = w.shape[0]
    out = sum(xp[:, i: i + T, :] * w[i][None, None, :] for i in range(dc))
    return out + b[None, None, :]


def _causal_conv(x, w, b):
    """Depthwise causal conv from zero history.  x: (B,S,di); w: (dc,di)."""
    dc = w.shape[0]
    xp = F.pad(x, (0, 0, dc - 1, 0))
    return _conv_taps(xp, w, b, x.shape[1])


def _softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) in the same ops."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _ssm_inputs(p, cfg: ModelConfig, xs):
    """xs: (B,S,di) post-conv.  Returns dt (B,S,di), Bc, Cc (B,S,N).
    ``x_proj`` is row-parallel under tensor parallelism: its (dt_rank +
    2N) output is summed over the ranks before dt, B and C are cut."""
    N, dtr = cfg.ssm.d_state, cfg.dt_rank
    proj = S.all_reduce(mm(xs, p["x_proj"]))
    dt_in, Bc, Cc = torch.split(proj, [dtr, N, N], dim=-1)
    dt = _softplus(mm(dt_in, p["dt_proj"]) + p["dt_bias"])
    return dt, Bc, Cc


def _ssm_step(h, dt_t, x_t, b_t, c_t, A):
    """One float32 recurrence step: h' = exp(dt A) h + dt B x; y = C h'.
    The plain scan (``kernels/ssm_scan/ops.py``) applies it per token."""
    decay = torch.exp(dt_t[..., None] * A[None])       # (B,di,N)
    drive = (dt_t * x_t)[..., None] * b_t[:, None, :]
    h = decay * h + drive
    y_t = torch.einsum("bdn,bn->bd", h, c_t)
    return h, y_t


def selective_scan(dt, Bc, Cc, xs, A, D, h0=None):
    """h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ; y_t = C_t h_t + D x_t
    over the whole sequence (the reference's argument order).  dt, xs:
    (B,S,di); Bc, Cc: (B,S,N); A: (di,N).  Returns (y in xs's type,
    h_last (B,di,N) f32).  The plain version (the tests' oracle for the
    kernel's cold-start case)."""
    B, _, di = xs.shape
    if h0 is None:
        h0 = torch.zeros((B, di, Bc.shape[-1]), dtype=torch.float32,
                         device=xs.device)
    y, h_last = scan_ops.selective_scan_plain(dt, xs, Bc, Cc, A, D, h0, None)
    return y.to(xs.dtype), h_last


def mamba_forward(p, cfg: ModelConfig, x):
    """Prefill from zero state.  x: (B,S,d) -> (y (B,S,d), (conv_state,
    ssm_state)): the last d_conv-1 pre-conv inputs seed the decode conv
    window, the scan's final state (f32) the SSM state.  The scan is the
    selective-scan kernel's cold-start case (``h0`` zero, every row
    valid for all S tokens), and differentiable: training runs it."""
    dc = cfg.ssm.d_conv
    B = x.shape[0]
    xz = mm(x, p["in_proj"])
    xs, z = torch.chunk(xz, 2, dim=-1)
    conv_tail = xs[:, -(dc - 1):, :]                            # decode seed
    xs = F.silu(_causal_conv(xs, p["conv_w"], p["conv_b"]))
    dt, Bc, Cc = _ssm_inputs(p, cfg, xs)
    A = -torch.exp(p["A_log"])
    h0 = torch.zeros((B, cfg.d_inner, cfg.ssm.d_state), dtype=torch.float32,
                     device=x.device)
    # the unmasked scan, differentiable (B5' on the card); Bc/Cc go in as
    # torch.split views of the x_proj output (the kernel takes their row
    # stride)
    y, h_last = scan_ops.selective_scan(dt, xs, Bc, Cc, A, p["D"], h0)
    y = y.to(xs.dtype) * F.silu(z)
    return mm(y, p["out_proj"]), (conv_tail, h_last)


def _paged_scan_inputs(p, cfg: ModelConfig, x, conv_state, t_valid):
    """What a carried-state step feeds the scan: (xs, z, dt, Bc, Cc, A,
    new conv state) from x (B,T,d) and the conv window (B,dc-1,di)."""
    dc = cfg.ssm.d_conv
    T = x.shape[1]
    xz = mm(x, p["in_proj"])
    xs, z = torch.chunk(xz, 2, dim=-1)                          # (B,T,di)
    xp = torch.cat([conv_state.to(xs.dtype), xs], dim=1)
    # next conv window: the dc-1 inputs ending at each row's own valid
    # length (stream position t_valid-1 lives at xp index t_valid+dc-2)
    idx = t_valid[:, None] + torch.arange(dc - 1, dtype=torch.int32,
                                          device=x.device)[None, :]
    new_conv_state = torch.gather(
        xp, 1, idx.long()[..., None].expand(-1, -1, xp.shape[-1]))
    xs = F.silu(_conv_taps(xp, p["conv_w"], p["conv_b"], T))
    dt, Bc, Cc = _ssm_inputs(p, cfg, xs)
    return xs, z, dt, Bc, Cc, -torch.exp(p["A_log"]), new_conv_state


def mamba_slab_step(p, cfg: ModelConfig, x, conv_state, ssm_pool,
                    read_rows, write_rows, t_valid):
    """Advance each row by up to T tokens from carried per-row state.

    x: (B,T,d); conv_state: (B,dc-1,di); t_valid: (B,) int32 — row ``b``
    consumes only its first ``t_valid[b]`` tokens: its state stops
    advancing there and outputs past it are garbage the caller ignores.
    Covers paged decode (T=1), chunked prefill (T=chunk) and the dense
    decode.  The SSM state lives in a slab pool ``ssm_pool`` (S,di,N)
    f32 that the scan kernel reads and writes in place: row ``b`` starts
    from ``ssm_pool[read_rows[b]]`` (negative: from zero) and leaves its
    state in ``ssm_pool[write_rows[b]]``; None for both means row b <->
    slab b (see ``kernels/ssm_scan/ops.py::selective_scan_slab`` for the
    precondition on the rows).  Returns (y (B,T,d), new conv state)."""
    xs, z, dt, Bc, Cc, A, new_conv_state = _paged_scan_inputs(
        p, cfg, x, conv_state, t_valid)
    y = scan_ops.selective_scan_slab(dt, xs, Bc, Cc, A, p["D"], ssm_pool,
                                     read_rows, write_rows, t_valid)
    y = y.to(x.dtype) * F.silu(z)
    return mm(y, p["out_proj"]), new_conv_state
