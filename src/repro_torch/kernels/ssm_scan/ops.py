"""Selective scan (Mamba S6): CUDA kernel wrapper and plain version.

``selective_scan`` is the port of
``repro/kernels/ssm_scan/kernel.py::selective_scan_kernel``, extended
with a carried state ``h0`` and per-row valid lengths ``t_valid`` so the
paged serving step (``models/mamba.py::mamba_paged_step``) can run on it
(see ``csrc/selective_scan.cu``).  On a CPU tensor it runs
``selective_scan_plain``; on a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "selective_scan",
    Path(__file__).parent / "csrc" / "selective_scan.cu",
    {f"selective_scan_{t}": [_P] * 10 + [_I] * 4 + [_P]
     for t in ("f32", "bf16")})

_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_STATE = 16          # d_state the kernel keeps in registers


def check_scan_operands(dt, xs, Bc, Cc, A, D, h0, t_valid):
    """Raise unless the operands are what the kernel takes: one device,
    contiguous; dt/xs (B, T, di) and Bc/Cc (B, T, N) of one model type
    (f32 or bf16); A (di, N), D (di,) and h0 (B, di, N) f32; t_valid (B,)
    int32; 1 <= N <= 16."""
    ts = (dt, xs, Bc, Cc, A, D, h0, t_valid)
    if any(t.device != dt.device for t in ts):
        raise ValueError("selective_scan operands must share one device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("selective_scan operands must be contiguous")
    if dt.dtype not in _NAMES or any(t.dtype != dt.dtype
                                     for t in (xs, Bc, Cc)):
        raise TypeError(f"dt/xs/Bc/Cc must share one of f32/bf16, got "
                        f"{dt.dtype}/{xs.dtype}/{Bc.dtype}/{Cc.dtype}")
    if any(t.dtype != torch.float32 for t in (A, D, h0)):
        raise TypeError("A, D and h0 must be float32")
    if t_valid.dtype != torch.int32:
        raise TypeError("t_valid must be int32")
    if dt.dim() != 3 or xs.shape != dt.shape:
        raise ValueError(f"bad shapes dt={tuple(dt.shape)} xs={tuple(xs.shape)}")
    B, T, di = dt.shape
    N = Bc.shape[-1]
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"d_state {N}: the kernel keeps at most "
                         f"{MAX_STATE} state values per channel")
    want = {"Bc": (B, T, N), "Cc": (B, T, N), "A": (di, N), "D": (di,),
            "h0": (B, di, N), "t_valid": (B,)}
    got = {"Bc": Bc, "Cc": Cc, "A": A, "D": D, "h0": h0, "t_valid": t_valid}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(got[name].shape)}, "
                             f"expected {shape}")


def selective_scan_plain(dt, xs, Bc, Cc, A, D, h0, t_valid):
    """The same function in plain PyTorch: the reference's masked scan
    (``mamba_paged_step``), one ``_ssm_step`` per position in f32; step
    ``t`` of row ``b`` advances the state only if ``t < t_valid[b]``, and
    its output is ``C_t . h_new`` either way.  Returns (y (B, T, di) f32
    with ``D x`` added, h_last (B, di, N) f32)."""
    # imported here: models.mamba imports this module
    from ...models.mamba import _ssm_step
    dt32, x32, b32, c32 = (a.float() for a in (dt, xs, Bc, Cc))
    h, ys = h0, []
    for t in range(dt.shape[1]):
        h_new, y_t = _ssm_step(h, dt32[:, t], x32[:, t], b32[:, t],
                               c32[:, t], A)
        h = torch.where((t < t_valid)[:, None, None], h_new, h)
        ys.append(y_t)
    y = torch.stack(ys, dim=1)
    return y + D[None, None] * x32, h


def selective_scan(dt, xs, Bc, Cc, A, D, h0, t_valid):
    """dt, xs: (B, T, di); Bc, Cc: (B, T, N) in the model dtype; A: (di,
    N), D: (di,), h0: (B, di, N) float32; t_valid: (B,) int32 -> (y (B, T,
    di) float32 with ``D x`` added, h_last (B, di, N) float32)."""
    if dt.device.type == "cpu":
        return selective_scan_plain(dt, xs, Bc, Cc, A, D, h0, t_valid)
    if dt.device.type != "cuda":
        raise ValueError(f"selective_scan: no kernel for {dt.device}")
    check_scan_operands(dt, xs, Bc, Cc, A, D, h0, t_valid)
    B, T, di = dt.shape
    N = Bc.shape[-1]
    y = torch.empty((B, T, di), dtype=torch.float32, device=dt.device)
    h_last = torch.empty((B, di, N), dtype=torch.float32, device=dt.device)
    stream = torch.cuda.current_stream(dt.device).cuda_stream
    KERNEL.launch(
        f"selective_scan_{_NAMES[dt.dtype]}",
        dt.data_ptr(), xs.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
        A.data_ptr(), D.data_ptr(), h0.data_ptr(), t_valid.data_ptr(),
        y.data_ptr(), h_last.data_ptr(), B, T, di, N, stream)
    return y, h_last
