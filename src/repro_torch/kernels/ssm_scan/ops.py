"""Selective scan (Mamba S6): CUDA kernel wrappers and plain versions.

``selective_scan`` is the port of
``repro/kernels/ssm_scan/kernel.py::selective_scan_kernel``, extended
with a carried state ``h0`` and per-row valid lengths ``t_valid`` (the
reference's ``mamba_paged_step`` runs that masked scan).
``selective_scan_slab`` is the same scan reading and writing the serving
engine's state pool in place, rows by index (see
``csrc/selective_scan.cu``).  On a CPU tensor each runs its plain
version; on a CUDA tensor it launches the kernel or raises.
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
    {**{f"selective_scan_{t}": [_P] * 10 + [_I] * 5 + [_P]
        for t in ("f32", "bf16")},
     **{f"selective_scan_slab_{t}": [_P] * 11 + [_I] * 6 + [_P]
        for t in ("f32", "bf16")}})

_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_STATE = 16          # d_state the kernel keeps in registers


def bc_row_stride(t):
    """The row stride ``s`` of a (B, T, N) tensor whose element (b, t, n)
    lies at ``(b*T + t)*s + n`` — a contiguous tensor (``s = N``) or a
    ``torch.split`` view of the last axis of a contiguous (B, T, W)
    tensor (``s = W``) — or None if it has no such stride."""
    B, T, N = t.shape
    s = t.stride(1) if T > 1 else t.stride(0) if B > 1 else N
    ok = ((N == 1 or t.stride(2) == 1) and s >= N
          and (B == 1 or t.stride(0) == T * s))
    return s if ok else None


def _check_common(dt, xs, Bc, Cc, A, D, t_valid, state, state_name):
    """The checks both entries share; returns the B/C row stride."""
    ts = (dt, xs, Bc, Cc, A, D, state, t_valid)
    if any(t.device != dt.device for t in ts):
        raise ValueError("selective_scan operands must share one device")
    if any(not t.is_contiguous() for t in (dt, xs, A, D, state, t_valid)):
        raise ValueError("selective_scan operands other than Bc/Cc must be "
                         "contiguous")
    if dt.dtype not in _NAMES or any(t.dtype != dt.dtype
                                     for t in (xs, Bc, Cc)):
        raise TypeError(f"dt/xs/Bc/Cc must share one of f32/bf16, got "
                        f"{dt.dtype}/{xs.dtype}/{Bc.dtype}/{Cc.dtype}")
    if any(t.dtype != torch.float32 for t in (A, D, state)):
        raise TypeError(f"A, D and {state_name} must be float32")
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
            "t_valid": (B,)}
    got = {"Bc": Bc, "Cc": Cc, "A": A, "D": D, "t_valid": t_valid}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(got[name].shape)}, "
                             f"expected {shape}")
    if tuple(state.shape[1:]) != (di, N) or state.dim() != 3:
        raise ValueError(f"{state_name} has shape {tuple(state.shape)}, "
                         f"expected (*, {di}, {N})")
    s = bc_row_stride(Bc)
    if s is None or bc_row_stride(Cc) != s:
        raise ValueError(f"Bc/Cc need one row stride (element (b, t, n) at "
                         f"(b*T + t)*s + n), got strides {Bc.stride()} and "
                         f"{Cc.stride()}")
    return s


def check_scan_operands(dt, xs, Bc, Cc, A, D, h0, t_valid):
    """Raise unless the operands are what the kernel takes: one device;
    dt/xs (B, T, di) and Bc/Cc (B, T, N) of one model type (f32 or
    bf16); A (di, N), D (di,) and h0 (B, di, N) f32; t_valid (B,) int32;
    1 <= N <= 16.  All contiguous but Bc and Cc, which need one row
    stride (``bc_row_stride``): the ``torch.split`` views of the x_proj
    output go in as they are.  Returns that stride."""
    s = _check_common(dt, xs, Bc, Cc, A, D, t_valid, h0, "h0")
    if h0.shape[0] != dt.shape[0]:
        raise ValueError(f"h0 has shape {tuple(h0.shape)}, expected "
                         f"({dt.shape[0]}, {dt.shape[2]}, {Bc.shape[-1]})")
    return s


def check_slab_operands(dt, xs, Bc, Cc, A, D, pool, read_rows, write_rows,
                        t_valid):
    """``check_scan_operands`` with a state pool (S, di, N) f32 in place
    of h0, and row indices (B,) int64 on the same device, or None for
    row b -> slab b (then S == B).  The row values are not checked here
    (that would read the device): see ``selective_scan_slab``."""
    s = _check_common(dt, xs, Bc, Cc, A, D, t_valid, pool, "pool")
    B = dt.shape[0]
    for name, rows in (("read_rows", read_rows), ("write_rows", write_rows)):
        if rows is None:
            if pool.shape[0] != B:
                raise ValueError(f"{name}=None maps row b to slab b: the "
                                 f"pool needs {B} slabs, has {pool.shape[0]}")
        elif (rows.dtype != torch.int64 or tuple(rows.shape) != (B,)
              or rows.device != dt.device or not rows.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({B},) int64 "
                             f"tensor on {dt.device}")
    return s


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


def selective_scan_slab_plain(dt, xs, Bc, Cc, A, D, pool, read_rows,
                              write_rows, t_valid):
    """The slab entry in plain PyTorch, written out as gather, scan,
    scatter: gather the rows' slabs (a negative read row starts from
    zero), scan, ``index_copy_`` the last states to their write rows
    (None: row b <-> slab b).  Updates ``pool`` in place; returns y (B,
    T, di) f32."""
    if read_rows is None:
        h0 = pool
    else:
        h0 = torch.where((read_rows < 0)[:, None, None], 0,
                         pool[read_rows.clamp(min=0)])
    y, h_last = selective_scan_plain(dt, xs, Bc, Cc, A, D, h0, t_valid)
    if write_rows is None:
        pool.copy_(h_last)
    else:
        pool.index_copy_(0, write_rows, h_last)
    return y


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _device(name, dt):
    if dt.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {dt.device}")


def selective_scan(dt, xs, Bc, Cc, A, D, h0, t_valid):
    """dt, xs: (B, T, di); Bc, Cc: (B, T, N) in the model dtype (Bc, Cc
    may be split views, see ``check_scan_operands``); A: (di, N), D:
    (di,), h0: (B, di, N) float32; t_valid: (B,) int32 -> (y (B, T, di)
    float32 with ``D x`` added, h_last (B, di, N) float32).  On a CUDA
    tensor with grad on and an operand that requires grad it raises
    ``NotImplementedError``: the kernel has no backward yet (ROADMAP
    A15b), and a result without a gradient would train silently wrong."""
    if dt.device.type == "cpu":
        return selective_scan_plain(dt, xs, Bc, Cc, A, D, h0, t_valid)
    _device("selective_scan", dt)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, xs, Bc, Cc, A, D, h0)):
        raise NotImplementedError(
            "selective_scan: the scan kernel (B5) has no backward yet, so a "
            "mamba layer cannot be trained on the card (ROADMAP Queue A, "
            "A15b); run it under torch.no_grad() or train on the CPU")
    ldbc = check_scan_operands(dt, xs, Bc, Cc, A, D, h0, t_valid)
    B, T, di = dt.shape
    N = Bc.shape[-1]
    y = torch.empty((B, T, di), dtype=torch.float32, device=dt.device)
    h_last = torch.empty((B, di, N), dtype=torch.float32, device=dt.device)
    if B == 0:
        return y, h_last
    KERNEL.launch(
        f"selective_scan_{_NAMES[dt.dtype]}",
        dt.data_ptr(), xs.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
        A.data_ptr(), D.data_ptr(), h0.data_ptr(), t_valid.data_ptr(),
        y.data_ptr(), h_last.data_ptr(), B, T, di, N, ldbc, _stream(dt))
    return y, h_last


def selective_scan_slab(dt, xs, Bc, Cc, A, D, pool, read_rows, write_rows,
                        t_valid):
    """The scan with its state in a slab pool (S, di, N) f32, updated in
    place: row b starts from ``pool[read_rows[b]]`` (negative: from
    zero) and leaves its last state in ``pool[write_rows[b]]``; None
    for either means row b <-> slab b.  Other operands as
    ``selective_scan``.  Returns y (B, T, di) f32.

    Precondition (the serving engine keeps it): rows that write a real
    slab hold distinct slabs and read only their own; other rows
    (t_valid 0) write only a spare *dump* slab, which they may share,
    and their outputs are ignored.  Such a row may read a slab that a
    live row rewrites in the same launch, so on the card its y and the
    dump slab are not defined; everything else equals the plain
    version within the scan's tolerance.  Row values must lie in
    [0, S) (or be negative for a read); the kernel neither reads nor
    writes a slab outside it, where the plain version raises."""
    if dt.device.type == "cpu":
        return selective_scan_slab_plain(dt, xs, Bc, Cc, A, D, pool,
                                         read_rows, write_rows, t_valid)
    _device("selective_scan_slab", dt)
    ldbc = check_slab_operands(dt, xs, Bc, Cc, A, D, pool, read_rows,
                               write_rows, t_valid)
    B, T, di = dt.shape
    y = torch.empty((B, T, di), dtype=torch.float32, device=dt.device)
    if B == 0:
        return y
    KERNEL.launch(
        f"selective_scan_slab_{_NAMES[dt.dtype]}",
        dt.data_ptr(), xs.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
        A.data_ptr(), D.data_ptr(), pool.data_ptr(),
        None if read_rows is None else read_rows.data_ptr(),
        None if write_rows is None else write_rows.data_ptr(),
        t_valid.data_ptr(), y.data_ptr(), B, T, di, Bc.shape[-1], ldbc,
        pool.shape[0], _stream(dt))
    return y
