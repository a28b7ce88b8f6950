"""Selective scan (Mamba S6): CUDA kernel wrappers and plain versions.

``selective_scan`` is the port of
``repro/kernels/ssm_scan/kernel.py::selective_scan_kernel``, extended
with a carried state ``h0`` and per-row valid lengths ``t_valid`` (the
reference's ``mamba_paged_step`` runs that masked scan).  Unmasked
(``t_valid=None``: every row valid for all T steps, the TPU op's own
contract with an ``h0``) it is differentiable: ``_SelectiveScan`` runs
the forward's checkpointing twin and the backward kernel B5'
(``csrc/selective_scan_backward.cu``) on the card, the plain forward
and ``selective_scan_backward_plain`` on the CPU.
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
_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_STATE = 16          # d_state the kernel keeps in registers
# steps between two stored states of the checkpointing forward: the
# backward recomputes one such chunk at a time, its decays in registers.
# The kernels' own copies (csrc/selective_scan.cu's kCkptSteps,
# csrc/selective_scan_backward.cu's kChunk) are held to it when each
# library loads.
CKPT_STEPS = 8
# channel blocks in one thread-block cluster of B5', which sums their
# partials of d_Bc/d_Cc (held to the kernel's kCluster likewise)
BACKWARD_CLUSTER = 8


def _check_ckpt_steps(lib) -> None:
    fn = lib.selective_scan_ckpt_steps
    fn.argtypes, fn.restype = [], _I
    if fn() != CKPT_STEPS:
        raise RuntimeError(f"selective_scan.cu stores a state every {fn()} "
                           f"steps, ops.py expects CKPT_STEPS = {CKPT_STEPS}")


def _layout(lib, di: int, N: int) -> dict:
    fn = lib.selective_scan_backward_layout
    fn.argtypes, fn.restype = [_I, _I, ctypes.POINTER(_I)], _I
    out = (_I * 5)()
    rc = fn(di, N, out)
    if rc != 0:
        raise ValueError(f"selective_scan_backward_layout(di={di}, N={N}): "
                         f"CUDA error {rc}")
    return dict(zip(("chunk_steps", "cluster", "channels_per_block",
                     "values_per_thread", "clusters"), out))


def _check_backward_layout(lib) -> None:
    """The backward's chunk, cluster and partials as ops.py sizes them:
    the workspace it allocates is what the kernel indexes."""
    for N in range(1, MAX_STATE + 1):
        for di in (1, 96, 1000, 8192):
            got = _layout(lib, di, N)
            want = dict(chunk_steps=CKPT_STEPS, cluster=BACKWARD_CLUSTER,
                        clusters=backward_workspace_shape(1, 1, di, N)[3])
            if any(got[k] != v for k, v in want.items()):
                raise RuntimeError(f"selective_scan_backward.cu's layout "
                                   f"at di={di}, N={N} is {got}; ops.py "
                                   f"expects {want}")


KERNEL = CudaKernel(
    "selective_scan",
    Path(__file__).parent / "csrc" / "selective_scan.cu",
    {**{f"selective_scan_{t}": [_P] * 10 + [_I] * 5 + [_P]
        for t in ("f32", "bf16")},
     **{f"selective_scan_slab_{t}": [_P] * 11 + [_I] * 6 + [_P]
        for t in ("f32", "bf16")},
     # the unmasked scan that also stores the state every CKPT_STEPS steps
     **{f"selective_scan_ckpt_{t}": [_P] * 10 + [_I] * 5 + [_P]
        for t in ("f32", "bf16")}},
    check=_check_ckpt_steps)
BACKWARD_KERNEL = CudaKernel(
    "selective_scan_backward",
    Path(__file__).parent / "csrc" / "selective_scan_backward.cu",
    {f"selective_scan_backward_{t}": [_P] * 19 + [_I] * 5 + [_P]
     for t in ("f32", "bf16")},
    check=_check_backward_layout)


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
    """The checks every entry shares; returns the B/C row stride.
    ``t_valid`` None: the unmasked scan (every row valid for all T);
    ``state`` None: checked by the caller."""
    given = [t for t in (state, t_valid) if t is not None]
    if any(t.device != dt.device for t in [dt, xs, Bc, Cc, A, D] + given):
        raise ValueError("selective_scan operands must share one device")
    if any(not t.is_contiguous() for t in [dt, xs, A, D] + given):
        raise ValueError("selective_scan operands other than Bc/Cc must be "
                         "contiguous")
    if dt.dtype not in _NAMES or any(t.dtype != dt.dtype
                                     for t in (xs, Bc, Cc)):
        raise TypeError(f"dt/xs/Bc/Cc must share one of f32/bf16, got "
                        f"{dt.dtype}/{xs.dtype}/{Bc.dtype}/{Cc.dtype}")
    if any(t.dtype != torch.float32 for t in (A, D, state) if t is not None):
        raise TypeError(f"A, D and {state_name} must be float32")
    if t_valid is not None and t_valid.dtype != torch.int32:
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
        if got[name] is not None and tuple(got[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(got[name].shape)}, "
                             f"expected {shape}")
    if state is not None and (tuple(state.shape[1:]) != (di, N)
                              or state.dim() != 3):
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
    bf16); A (di, N), D (di,) and h0 (B, di, N) f32; t_valid (B,) int32
    or None (unmasked); 1 <= N <= 16.  All contiguous but Bc and Cc,
    which need one row stride (``bc_row_stride``): the ``torch.split``
    views of the x_proj output go in as they are.  Returns that
    stride."""
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
    its output is ``C_t . h_new`` either way (``t_valid`` None: every
    step advances).  Returns (y (B, T, di) f32 with ``D x`` added, h_last
    (B, di, N) f32)."""
    # imported here: models.mamba imports this module
    from ...models.mamba import _ssm_step
    dt32, x32, b32, c32 = (a.float() for a in (dt, xs, Bc, Cc))
    h, ys = h0, []
    for t in range(dt.shape[1]):
        h_new, y_t = _ssm_step(h, dt32[:, t], x32[:, t], b32[:, t],
                               c32[:, t], A)
        h = h_new if t_valid is None else torch.where(
            (t < t_valid)[:, None, None], h_new, h)
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


def selective_scan_backward_plain(dt, xs, Bc, Cc, A, D, h0, dy, dh_last):
    """The unmasked scan's gradient in plain PyTorch, f32 inside: the
    explicit reverse recurrence, with the states of one ``CKPT_STEPS``
    chunk at a time recomputed from the state at its start (the
    reference's chunked ``jax.checkpoint``, which B5' follows).  With
    ``g_t`` the gradient reaching h_t, from ``dh_last`` (None: zero) back:

        g_t   = dy_t C_t + exp(dt_{t+1} A) g_{t+1}
        dC_t  = sum_d dy_t h_t           dB_t = sum_d g_t dt_t x_t
        ddt_t = sum_n g_t (A exp(dt_t A) h_{t-1} + x_t B_t)
        dx_t  = dt_t sum_n g_t B_t + D dy_t
        dA    = sum_{b,t} g_t exp(dt_t A) h_{t-1} dt_t
        dD    = sum_{b,t} dy_t x_t       dh0 = exp(dt_1 A) g_1

    dy: (B, T, di), dh_last: (B, di, N) or None.  Returns (d_dt, d_xs,
    d_Bc, d_Cc, dA, dD, dh0), all f32 (the B/C gradients contiguous (B,
    T, N))."""
    B, T, di = dt.shape
    N = Bc.shape[-1]
    dt32, x32, b32, c32 = (a.float() for a in (dt, xs, Bc, Cc))
    dy = dy.float()
    f32 = dict(dtype=torch.float32, device=dt.device)

    def advance(h, t):
        decay = torch.exp(dt32[:, t, :, None] * A[None])
        return decay * h + (dt32[:, t] * x32[:, t])[..., None] \
            * b32[:, t, None, :]
    starts, h = [], h0
    for t in range(T):
        if t % CKPT_STEPS == 0:
            starts.append(h)
        h = advance(h, t)
    # g: the gradient reaching the state after the step being walked,
    # less that step's own dy C (exp(dt_{t+1} A) g_{t+1})
    g = torch.zeros_like(h0) if dh_last is None else dh_last.float()
    d_dt, d_x = torch.empty((B, T, di), **f32), torch.empty((B, T, di), **f32)
    d_b, d_c = torch.empty((B, T, N), **f32), torch.empty((B, T, N), **f32)
    d_a = torch.zeros((di, N), **f32)
    for c in reversed(range(len(starts))):
        t0 = c * CKPT_STEPS
        hs = [starts[c]]
        for t in range(t0, min(T, t0 + CKPT_STEPS)):
            hs.append(advance(hs[-1], t))
        for t in reversed(range(t0, t0 + len(hs) - 1)):
            dtv, xv, bv = dt32[:, t, :, None], x32[:, t], b32[:, t, None, :]
            decay = torch.exp(dtv * A[None])
            g = dy[:, t, :, None] * c32[:, t, None, :] + g
            ah = decay * hs[t - t0]
            d_c[:, t] = torch.einsum("bd,bdn->bn", dy[:, t], hs[t - t0 + 1])
            d_dt[:, t] = (g * (A[None] * ah + xv[..., None] * bv)).sum(-1)
            d_x[:, t] = dt32[:, t] * (g * bv).sum(-1) + D * dy[:, t]
            d_b[:, t] = torch.einsum("bdn,bd->bn", g, dt32[:, t] * xv)
            d_a += (g * ah * dtv).sum(0)
            g = decay * g
    d_d = (dy * x32).sum((0, 1))
    return d_dt, d_x, d_b, d_c, d_a, d_d, g


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _launch_scan(dt, xs, Bc, Cc, A, D, h0, t_valid, ckpt: bool = False):
    """B5 on the card through its served entry (``t_valid`` a tensor, or
    None: every row valid) or, with ``ckpt`` (unmasked only), its
    checkpointing twin.  Returns (y, h_last), and the stored states (B,
    ceil(T / CKPT_STEPS), di, N) f32 with ``ckpt``: the state before
    steps 0, 8, 16, ..."""
    _device("selective_scan", dt)
    ldbc = check_scan_operands(dt, xs, Bc, Cc, A, D, h0, t_valid)
    B, T, di = dt.shape
    N = Bc.shape[-1]
    f32 = dict(dtype=torch.float32, device=dt.device)
    y = torch.empty((B, T, di), **f32)
    h_last = torch.empty((B, di, N), **f32)
    states = torch.empty((B, -(-T // CKPT_STEPS), di, N), **f32) \
        if ckpt else None
    if B > 0:
        ptrs = (dt.data_ptr(), xs.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                A.data_ptr(), D.data_ptr(), h0.data_ptr())
        dims = (B, T, di, N, ldbc, _stream(dt))
        name = _NAMES[dt.dtype]
        if ckpt:
            KERNEL.launch(f"selective_scan_ckpt_{name}", *ptrs, y.data_ptr(),
                          h_last.data_ptr(), states.data_ptr(), *dims)
        else:
            if t_valid is None:
                t_valid = torch.full((B,), T, dtype=torch.int32,
                                     device=dt.device)
            KERNEL.launch(f"selective_scan_{name}", *ptrs,
                          t_valid.data_ptr(), y.data_ptr(),
                          h_last.data_ptr(), *dims)
    return (y, h_last, states) if ckpt else (y, h_last)


def selective_scan_ckpt(dt, xs, Bc, Cc, A, D, h0):
    """The unmasked scan through B5's checkpointing twin: (y, h_last)
    equal to the served entry's bit for bit, and the state before every
    ``CKPT_STEPS``-th step (B, ceil(T / CKPT_STEPS), di, N) f32, from
    which ``selective_scan_backward`` recomputes the rest."""
    return _launch_scan(dt, xs, Bc, Cc, A, D, h0, None, ckpt=True)


def backward_workspace_shape(B: int, T: int, di: int, N: int) -> tuple:
    """The d_Bc/d_Cc partials B5' (csrc/selective_scan_backward.cu)
    writes, (2, B, T, n_grp, N) f32: 128 threads a block, ``L`` lanes a
    channel (1, 2 or 4 as N <= 4, 8, 16), so 128 / L channels a block;
    ``BACKWARD_CLUSTER`` blocks a cluster, which writes one partial."""
    L = 1 if N <= 4 else 2 if N <= 8 else 4
    n_blk = -(-di // (128 // L))
    return (2, B, T, -(-n_blk // BACKWARD_CLUSTER), N)


def backward_layout(di: int, N: int) -> dict:
    """The layout B5' takes at (di, N), as the built kernel reports it:
    steps a chunk, blocks a cluster, channels a block, state values a
    thread, clusters along di (one partial of d_Bc/d_Cc each).  Builds
    the library; launches nothing."""
    return _layout(BACKWARD_KERNEL.load(), di, N)


def backward_occupancy(dtype, N: int) -> dict:
    """What the card makes of the B5' kernel that serves ``dtype`` (f32
    or bf16) at ``N`` states: registers and local (spill) bytes a
    thread, shared bytes a block, resident blocks an SM, resident
    clusters on the card.  Builds the library; launches nothing."""
    lib = BACKWARD_KERNEL.load()
    fn = lib.selective_scan_backward_occupancy
    fn.argtypes, fn.restype = [_I, _I, ctypes.POINTER(_I)], _I
    out = (_I * 5)()
    rc = fn(N, int(dtype == torch.float32), out)
    if rc != 0:
        raise RuntimeError(f"selective_scan_backward_occupancy: CUDA error "
                           f"{rc} ({lib.kernel_error_string(rc).decode()})")
    return dict(zip(("registers", "spill_bytes", "smem_bytes",
                     "blocks_per_sm", "clusters"), out))


def selective_scan_backward(dt, xs, Bc, Cc, A, D, states, dy, dh_last):
    """B5': the unmasked scan's gradient on the card from its operands
    (Bc/Cc as ``selective_scan`` takes them), the states that
    ``selective_scan_ckpt`` stored, dy (B, T, di) f32 and dh_last (B, di,
    N) f32 or None (zero).  Returns (d_dt, d_xs, d_Bc, d_Cc, dA, dD,
    dh0): the first four in the model dtype, d_Bc/d_Cc contiguous (B, T,
    N); dA (di, N), dD (di,) and dh0 (B, di, N) f32.  The plain version
    is ``selective_scan_backward_plain`` (from h0 in place of the
    states)."""
    _device("selective_scan_backward", dt)
    ldbc = _check_common(dt, xs, Bc, Cc, A, D, None, None, "states")
    B, T, di = dt.shape
    N = Bc.shape[-1]
    f32 = dict(dtype=torch.float32, device=dt.device)
    for name, t, shape in (("states", states,
                            (B, -(-T // CKPT_STEPS), di, N)),
                           ("dy", dy, (B, T, di)),
                           ("dh_last", dh_last, (B, di, N))):
        if t is None and name == "dh_last":
            continue
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != dt.device or not t.is_contiguous()):
            raise ValueError(f"selective_scan_backward: {name} must be a "
                             f"contiguous {shape} float32 tensor on "
                             f"{dt.device}")
    d_dt, d_x = torch.empty_like(dt), torch.empty_like(xs)
    d_b = torch.empty((B, T, N), dtype=Bc.dtype, device=dt.device)
    d_c = torch.empty((B, T, N), dtype=Cc.dtype, device=dt.device)
    d_a, d_d = torch.empty((di, N), **f32), torch.empty((di,), **f32)
    dh0 = torch.empty((B, di, N), **f32)
    if B == 0 or T == 0:
        d_a.zero_()
        d_d.zero_()
        dh0.zero_() if dh_last is None else dh0.copy_(dh_last)
        return d_dt, d_x, d_b, d_c, d_a, d_d, dh0
    # each cluster's partial of d_Bc and d_Cc, and each row's of dA and
    # dD: summed in a fixed order by the kernel's second pass
    ws_bc = torch.empty(backward_workspace_shape(B, T, di, N), **f32)
    ws_a, ws_d = torch.empty((B, di, N), **f32), torch.empty((B, di), **f32)
    BACKWARD_KERNEL.launch(
        f"selective_scan_backward_{_NAMES[dt.dtype]}",
        dt.data_ptr(), xs.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
        A.data_ptr(), D.data_ptr(), states.data_ptr(), dy.data_ptr(),
        None if dh_last is None else dh_last.data_ptr(),
        d_dt.data_ptr(), d_x.data_ptr(), d_b.data_ptr(), d_c.data_ptr(),
        d_a.data_ptr(), d_d.data_ptr(), dh0.data_ptr(), ws_bc.data_ptr(),
        ws_a.data_ptr(), ws_d.data_ptr(), B, T, di, N, ldbc, _stream(dt))
    return d_dt, d_x, d_b, d_c, d_a, d_d, dh0


class _SelectiveScan(torch.autograd.Function):
    """The unmasked scan with its gradient.  On the card: the
    checkpointing twin, then B5' from the saved operands and states.  On
    the CPU: the plain forward, then ``selective_scan_backward_plain``
    from the saved operands and h0 (the same wiring).  Each gradient
    comes back in its input's type, d_Bc/d_Cc contiguous (B, T, N) also
    where Bc/Cc are split views."""

    @staticmethod
    def forward(ctx, dt, xs, Bc, Cc, A, D, h0):
        ctx.set_materialize_grads(False)
        if dt.device.type == "cpu":
            y, h_last = selective_scan_plain(dt, xs, Bc, Cc, A, D, h0, None)
            ctx.save_for_backward(dt, xs, Bc, Cc, A, D, h0)
        else:
            y, h_last, states = selective_scan_ckpt(dt, xs, Bc, Cc, A, D, h0)
            ctx.save_for_backward(dt, xs, Bc, Cc, A, D, states)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        dt, xs, Bc, Cc, A, D, state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(dt.shape, dtype=torch.float32, device=dt.device)
        dh_last = None if dh_last is None else dh_last.float().contiguous()
        if dt.device.type == "cpu":
            grads = selective_scan_backward_plain(dt, xs, Bc, Cc, A, D, state,
                                                  dy, dh_last)
        else:
            grads = selective_scan_backward(dt, xs, Bc, Cc, A, D, state,
                                            dy.float().contiguous(), dh_last)
        types = (dt.dtype, xs.dtype, Bc.dtype, Cc.dtype, A.dtype, D.dtype,
                 torch.float32)                           # h0 is f32
        return tuple(g.to(t) if need else None
                     for g, t, need in zip(grads, types,
                                           ctx.needs_input_grad))


def selective_scan(dt, xs, Bc, Cc, A, D, h0, t_valid=None):
    """dt, xs: (B, T, di); Bc, Cc: (B, T, N) in the model dtype (Bc, Cc
    may be split views, see ``check_scan_operands``); A: (di, N), D:
    (di,), h0: (B, di, N) float32; t_valid: (B,) int32, or None: every
    row valid for all T steps -> (y (B, T, di) float32 with ``D x``
    added, h_last (B, di, N) float32).

    Differentiable unmasked: with grad on and an operand that requires
    grad it runs ``_SelectiveScan`` (on the card the checkpointing twin
    and B5').  A masked call (a ``t_valid`` tensor) under autograd
    raises ``NotImplementedError``: only the unmasked scan is
    differentiable, and deciding on the host whether a device
    ``t_valid`` is full would read the device."""
    ops_in = (dt, xs, Bc, Cc, A, D, h0)
    if _wants_grad(*ops_in):
        if t_valid is not None:
            raise NotImplementedError(
                "selective_scan: only the unmasked scan (t_valid=None, "
                "every row valid for all T steps) is differentiable; run a "
                "masked scan under torch.no_grad()")
        return _SelectiveScan.apply(*ops_in)
    if dt.device.type == "cpu":
        return selective_scan_plain(*ops_in, t_valid)
    return _launch_scan(*ops_in, t_valid)


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
    writes a slab outside it, where the plain version raises.  On a CUDA
    tensor with grad on and an operand that requires grad it raises
    ``NotImplementedError`` (no gradient)."""
    if dt.device.type == "cpu":
        return selective_scan_slab_plain(dt, xs, Bc, Cc, A, D, pool,
                                         read_rows, write_rows, t_valid)
    _device("selective_scan_slab", dt)
    if _wants_grad(dt, xs, Bc, Cc, A, D):
        # the kernel fills y through ctypes: autograd would see a result
        # without a gradient and train with zero gradients for the scan
        raise NotImplementedError(
            "selective_scan_slab: the slab entry (a masked scan over the "
            "state pool, updated in place) is not differentiable; serve it "
            "under torch.no_grad(), train through the unmasked "
            "selective_scan")
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
