"""Prefill attention: CUDA kernel wrappers and plain versions.

``paged_prefill_attention`` is the paged form of
``repro/kernels/flash_attention/kernel.py::flash_attention`` that the
serving engine's mixed prefill+decode steps need (see
``csrc/paged_prefill.cu``).  ``flash_attention`` is its contiguous
form, with causal and sliding-window masks, for the dense engine's
prefill (see ``csrc/flash_prefill.cu``).  On a CPU tensor each runs its
plain version; on a CUDA tensor it launches its kernel or raises.
``paged_prefill_attention_quant`` is the paged form over int8 pools with
per-row f32 scales (see ``csrc/paged_prefill_quant.cu``): the int8
engine's mixed steps, which the reference serves without a kernel.
``mla_flash_attention`` is the contiguous form on DeepSeek-V3's MLA
operands as ``mla_prefill`` makes them: a rope key shared by every head
and V at its own head dim.

The libraries hold three bodies.  bf16 at head_dim 64, 128 or 192
runs on the tensor cores (``csrc/prefill_mma.cuh``, the ``*_mma``
entries; ``MMA_HEAD_DIMS``), and so does f32 q over f32, bf16 or int8
K/V at 64, 128 or 192, in split TF32 (``csrc/prefill_tf32.cuh``, the
``*_tf32`` entries; ``TF32_HEAD_DIMS``); everything else on CUDA cores
(``csrc/prefill_body.cuh``).  bf16 MLA operands
at ``MLA_DIMS`` run the bf16 tensor-core body with a q/k head of 192
and a V head of 128 (``flash_attention_mla_bf16_mma``).
``paged_prefill_entry``, ``quant_prefill_entry``, ``flash_entry`` and
``mla_flash_entry`` pick the entry from dtypes and dims alone.

Training differentiates both contiguous forms on the card: on a CUDA
tensor with grad on and an operand that requires grad,
``flash_attention`` and ``mla_flash_attention`` run inside a
``torch.autograd.Function``, whose backward is the gradient of B2 (see
``csrc/flash_backward.cu``; the JAX package leaves it to XLA).  Where
``flash_backward_entry`` picks a tensor-core backward (bf16 at head_dim
64/128/192 with V as wide, and at ``MLA_DIMS``: ``csrc/backward_mma.cuh``;
f32 at ``TF32_BACKWARD_HEAD_DIMS``, 64/128, in split TF32:
``csrc/backward_tf32.cuh``), the Function's forward launches the
forward entry's ``*_lse`` twin, which also stores each row's
logsumexp, and the backward takes it (``backward_takes_lse``); other
head dims (f32 at 192 among them) keep the served forward entry and the
CUDA-core backward, which recomputes it.  Serving (no grad) launches the served
entries only.  On a CPU tensor the plain versions are differentiated by
torch itself.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from ..build import CudaKernel
from ..decode_attention.ops import (MLA_DIMS, _NAMES, check_mla_operands,
                                    check_paged_operands, mla_gqa_operands)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "paged_prefill_attention",
    Path(__file__).parent / "csrc" / "paged_prefill.cu",
    {f"paged_prefill_attention_{q}_{kv}{body}":
     [_P] * 6 + [_I] * 7 + [ctypes.c_float, _P]
     for q, kv, body in (("f32", "f32", ""), ("f32", "bf16", ""),
                         ("bf16", "bf16", ""), ("bf16", "bf16", "_mma"),
                         ("f32", "f32", "_tf32"), ("f32", "bf16", "_tf32"))})
QUANT_KERNEL = CudaKernel(
    "paged_prefill_attention_quant",
    Path(__file__).parent / "csrc" / "paged_prefill_quant.cu",
    {f"paged_prefill_attention_quant_f32{body}": [_P] * 8 + [_I] * 7
     + [ctypes.c_float, _P] for body in ("", "_tf32")})
FLASH_KERNEL = CudaKernel(
    "flash_attention",
    Path(__file__).parent / "csrc" / "flash_prefill.cu",
    {**{f"flash_attention_{t}": [_P] * 4 + [_I] * 8 + [ctypes.c_float, _P]
        for t in ("f32", "bf16", "bf16_mma", "f32_tf32")},
     "flash_attention_mla_bf16_mma": [_P] * 5 + [_I] * 4
     + [ctypes.c_float, _P],
     # the tensor-core entries that also store the row logsumexp
     **{f"flash_attention_{t}_lse": [_P] * 5 + [_I] * 8
        + [ctypes.c_float, _P] for t in ("bf16_mma", "f32_tf32")},
     "flash_attention_mla_bf16_mma_lse": [_P] * 6 + [_I] * 4
     + [ctypes.c_float, _P]})
BACKWARD_KERNEL = CudaKernel(
    "flash_attention_backward",
    Path(__file__).parent / "csrc" / "flash_backward.cu",
    {**{f"flash_attention_backward_{t}": [_P] * 10 + [_I] * 9
        + [ctypes.c_float, _P]
        for t in ("f32", "bf16", "bf16_mma", "f32_tf32")},
     "flash_attention_backward_mla_bf16_mma": [_P] * 13 + [_I] * 4
     + [ctypes.c_float, _P]})
# the forward entries that also store the row logsumexp, by served entry
LSE_ENTRIES = {"flash_attention_bf16_mma": "flash_attention_bf16_mma_lse",
               "flash_attention_f32_tf32": "flash_attention_f32_tf32_lse",
               "flash_attention_mla_bf16_mma":
               "flash_attention_mla_bf16_mma_lse"}
# heads a block of the MLA backward walks (csrc/backward_mma.cuh's
# kMlaHeads): the rope key's gradient has ceil(H / this) f32 partials
BACKWARD_MLA_HEADS = 8
# the backward holds q/k and V tiles of up to this head_dim in shared memory
BACKWARD_MAX_HEAD_DIM = 192
# head_dims the GQA bf16 tensor-core bodies are instantiated for (V as
# wide): smollm-360m's and jamba-v0.1's 64 and 128 (and most configs';
# 56 takes the CUDA-core body) and nemotron-4-340b's 192.  DeepSeek-V3's
# MLA (q/k 192, V 128) has its own tensor-core entry (mla_flash_entry).
MMA_HEAD_DIMS = (64, 128, 192)
# and the split-TF32 forward bodies (f32 q), 8-warp blocks at 192 whose
# shared memory does not grow with G (the CUDA-core body's does)
TF32_HEAD_DIMS = (64, 128, 192)
# the split-TF32 backward's head dims (hd = hdv): f32 at 192 (nemotron's
# heads) and elsewhere keeps the CUDA-core backward
TF32_BACKWARD_HEAD_DIMS = (64, 128)
# the backward entries that take the forward's logsumexp (tensor cores)
LSE_BACKWARDS = ("flash_attention_backward_bf16_mma",
                 "flash_attention_backward_f32_tf32",
                 "flash_attention_backward_mla_bf16_mma")


def _body(dtypes, hd: int) -> str:
    """Entry suffix of the body that serves these operands (q's type
    first): ``_mma`` (bf16 tensor cores) for bf16 throughout at
    ``MMA_HEAD_DIMS``, ``_tf32`` (split TF32 tensor cores) for f32 q at
    ``TF32_HEAD_DIMS``, else ``""`` (the CUDA-core body)."""
    if all(d == torch.bfloat16 for d in dtypes):
        return "_mma" if hd in MMA_HEAD_DIMS else ""
    return "_tf32" if dtypes[0] == torch.float32 \
        and hd in TF32_HEAD_DIMS else ""


def paged_prefill_entry(q_dtype, kv_dtype, hd: int) -> str:
    """The C entry of ``KERNEL`` that serves these operands."""
    return (f"paged_prefill_attention_{_NAMES[q_dtype]}_{_NAMES[kv_dtype]}"
            + _body((q_dtype, kv_dtype), hd))


def quant_prefill_entry(hd: int) -> str:
    """The C entry of ``QUANT_KERNEL`` that serves head_dim ``hd``."""
    return "paged_prefill_attention_quant_f32" + _body((torch.float32,), hd)


def flash_entry(dtype, hd: int) -> str:
    """The C entry of ``FLASH_KERNEL`` that serves these operands."""
    return f"flash_attention_{_NAMES[dtype]}" + _body((dtype,), hd)


def flash_backward_entry(dtypes, hd: int, hdv: int, *,
                         mla: bool = False) -> str:
    """The C entry of ``BACKWARD_KERNEL`` that serves these operands (q's
    type first): ``_bf16_mma`` (the bf16 tensor-core body) for bf16
    throughout at hd = hdv in ``MMA_HEAD_DIMS``; ``_f32_tf32`` (split TF32
    on the tensor cores) for f32 at hd = hdv in
    ``TF32_BACKWARD_HEAD_DIMS``; with ``mla`` (MLA's own operands: q/k
    ``hd`` = nope + rope, V ``hdv``) ``_mla_bf16_mma`` for bf16 at
    ``MLA_DIMS``; else the CUDA-core body for q's type.  Each
    tensor-core entry (``LSE_BACKWARDS``) takes the logsumexp of its
    forward entry's ``*_lse`` twin.  From dtypes and dims alone, never
    from a failed build or launch."""
    bf16 = all(d == torch.bfloat16 for d in dtypes)
    if mla:
        if not bf16 or (hd, hdv) != (MLA_DIMS[0] + MLA_DIMS[1], MLA_DIMS[2]):
            raise ValueError(f"MLA backward at {hd}/{hdv}, {dtypes}: the "
                             f"MLA entry takes bf16 at {MLA_DIMS}")
        return "flash_attention_backward_mla_bf16_mma"
    if hd == hdv:
        # the head dim tested here, not the forward's entry: f32 at 192
        # has a split-TF32 forward (and its *_lse twin) but no backward
        if bf16 and hd in MMA_HEAD_DIMS:
            return "flash_attention_backward_bf16_mma"
        if all(d == torch.float32 for d in dtypes) \
                and hd in TF32_BACKWARD_HEAD_DIMS:
            return "flash_attention_backward_f32_tf32"
    return f"flash_attention_backward_{_NAMES[dtypes[0]]}"


def backward_takes_lse(q, v) -> bool:
    """Whether B2's gradient at GQA operands q, v runs a tensor-core
    backward (``LSE_BACKWARDS``), which takes each row's logsumexp from
    the forward's ``*_lse`` twin (the CUDA-core one recomputes it)."""
    return flash_backward_entry((q.dtype, v.dtype), q.shape[-1],
                                v.shape[-1]) in LSE_BACKWARDS


def prefill_positions(lengths, T: int):
    """(B, T) absolute position of each query token: ``lengths + t``."""
    return lengths[:, None] + torch.arange(T, dtype=torch.int32,
                                           device=lengths.device)[None, :]


def paged_prefill_attention_plain(q, k_pool, v_pool, page_table, lengths):
    """The same function in plain PyTorch: the reference's
    ``paged_attention`` over ``paged_gather``."""
    # imported here: models.attention imports this module
    from ...models.attention import paged_attention, paged_gather
    return paged_attention(q, paged_gather(k_pool, page_table),
                           paged_gather(v_pool, page_table),
                           prefill_positions(lengths, q.shape[1]))


def paged_prefill_attention(q, k_pool, v_pool, page_table, lengths):
    """q: (B, T, H, hd), token t of slot b at position lengths[b] + t;
    k_pool/v_pool: (nb, bs, KV, hd); page_table: (B, P) int32; lengths:
    (B,) int32 tokens cached before this chunk -> (B, T, H, hd) in the
    pool's dtype.  Query t sees keys at positions <= lengths[b] + t."""
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(q, k_pool, v_pool, page_table,
                                             lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention: no kernel for {q.device}")
    check_paged_operands(q, k_pool, v_pool, page_table, lengths, 4)
    B, T, H, hd = q.shape
    bs, KV = k_pool.shape[1], k_pool.shape[2]
    out = torch.empty(q.shape, dtype=k_pool.dtype, device=q.device)
    # the kernel launches on the runtime's current device: one card
    stream = torch.cuda.current_stream(q.device).cuda_stream
    KERNEL.launch(
        paged_prefill_entry(q.dtype, k_pool.dtype, hd),
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, T, H, KV, hd, bs, page_table.shape[1],
        ctypes.c_float(1.0 / np.sqrt(hd)), stream)
    return out


def paged_prefill_attention_quant_plain(q, k_pool, v_pool, k_scale, v_scale,
                                        page_table, lengths):
    """The same function in plain PyTorch: the reference's
    ``paged_attention`` over ``dequant_gather``."""
    # imported here: models.attention imports this module
    from ...models.attention import dequant_gather, paged_attention
    k = dequant_gather(k_pool, k_scale, page_table)
    v = dequant_gather(v_pool, v_scale, page_table)
    return paged_attention(q, k, v, prefill_positions(lengths, q.shape[1]))


def paged_prefill_attention_quant(q, k_pool, v_pool, k_scale, v_scale,
                                  page_table, lengths):
    """q: (B, T, H, hd) f32, token t of slot b at position lengths[b] + t;
    k_pool/v_pool: (nb, bs, KV, hd) int8; k_scale/v_scale: (nb, bs, KV)
    f32; page_table: (B, P) int32; lengths: (B,) int32 tokens cached
    before this chunk -> (B, T, H, hd) f32."""
    if q.device.type == "cpu":
        return paged_prefill_attention_quant_plain(
            q, k_pool, v_pool, k_scale, v_scale, page_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_prefill_attention_quant: no kernel for {q.device}")
    check_paged_operands(q, k_pool, v_pool, page_table, lengths, 4,
                         scales=(k_scale, v_scale))
    B, T, H, hd = q.shape
    bs, KV = k_pool.shape[1], k_pool.shape[2]
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    QUANT_KERNEL.launch(
        quant_prefill_entry(hd),
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, T, H, KV, hd, bs,
        page_table.shape[1], ctypes.c_float(1.0 / np.sqrt(hd)), stream)
    return out


def check_flash_operands(q, k, v, causal: bool, sliding_window: int):
    """Raise unless the operands are what the contiguous kernel takes:
    one CUDA device, contiguous, q/k/v of one type (f32 or bf16), q (B,
    S, H, hd) and k/v (B, T, KV, hd) with KV dividing H, hd % 8 == 0,
    S, T >= 1 and, under the causal mask, S <= T (without it any S: a
    decoder's queries over an encoder's keys), and a window only under
    the causal mask (so every query row sees at least one key)."""
    ts = (q, k, v)
    if any(t.device != q.device for t in ts):
        raise ValueError("flash attention operands must share one device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("flash attention operands must be contiguous")
    if q.dtype not in _NAMES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of f32/bf16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)}")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}")
    if hd % 8:
        raise ValueError(f"head_dim {hd}: the kernel loads K/V rows in "
                         "16-byte chunks and needs head_dim % 8 == 0")
    if S < 1 or T < 1 or (causal and S > T):
        raise ValueError(f"{S} queries over {T} keys: the kernel takes "
                         "1 <= S <= T under the causal mask, S, T >= 1 "
                         "without it")
    if sliding_window < 0 or (sliding_window and not causal):
        raise ValueError(f"sliding_window={sliding_window} needs "
                         "causal=True and a window >= 0")


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          sliding_window: int = 0):
    """The same function in plain PyTorch: the reference's
    ``naive_attention``."""
    # imported here: models.attention imports this module
    from ...models.attention import naive_attention
    return naive_attention(q, k, v, causal=causal,
                           sliding_window=sliding_window)


def flash_attention_lse_plain(q, k, v, *, causal: bool = True,
                              sliding_window: int = 0):
    """``flash_attention_plain``'s output and each row's logsumexp (B, H,
    S) f32 of the masked scores as it computes them (q * scale and the
    scores rounded to q's type, masked keys at -1e30): what the ``*_lse``
    entries store."""
    from ...models.attention import NEG_INF, _grouped_scores
    B, S, H, hd = q.shape
    T = k.shape[1]
    scores = _grouped_scores(q * (1.0 / np.sqrt(hd)), k).float()
    s = torch.arange(S, device=q.device)[:, None]
    t = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= t <= s
    if sliding_window:
        mask &= t > s - sliding_window
    lse = torch.logsumexp(torch.where(mask, scores, NEG_INF), dim=-1)
    return (flash_attention_plain(q, k, v, causal=causal,
                                  sliding_window=sliding_window),
            lse.reshape(B, H, S))


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _flash_forward(q, k, v, causal: bool, sliding_window: int,
                   lse: bool = False):
    """Launch the contiguous forward entry ``flash_entry`` picks; with
    ``lse`` its ``*_lse`` twin, and return (out, lse (B, H, S) f32)."""
    check_flash_operands(q, k, v, causal, sliding_window)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (B, S, T, H, KV, hd, int(causal), int(sliding_window),
            ctypes.c_float(1.0 / np.sqrt(hd)), stream)
    entry = flash_entry(q.dtype, hd)
    if not lse:
        FLASH_KERNEL.launch(entry, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), *args)
        return out
    if entry not in LSE_ENTRIES:
        raise ValueError(f"{entry} stores no logsumexp: only the tensor-"
                         f"core entries, bf16 at head_dim {MMA_HEAD_DIMS} "
                         f"and f32 at {TF32_HEAD_DIMS}")
    rows = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    FLASH_KERNEL.launch(LSE_ENTRIES[entry], q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), out.data_ptr(), rows.data_ptr(), *args)
    return out, rows


class _FlashAttention(torch.autograd.Function):
    """B2 on the card with its gradient: the forward entry (its ``*_lse``
    twin where the backward runs on the tensor cores), then
    ``flash_attention_backward`` from the saved operands, output and
    logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sliding_window):
        if backward_takes_lse(q, v):
            out, lse = _flash_forward(q, k, v, causal, sliding_window,
                                      lse=True)
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            out = _flash_forward(q, k, v, causal, sliding_window)
            ctx.save_for_backward(q, k, v, out)
        ctx.mask = (causal, sliding_window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, *lse = ctx.saved_tensors
        causal, window = ctx.mask
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, dout.contiguous(), causal=causal,
            sliding_window=window, lse=lse[0] if lse else None)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0):
    """q: (B, S, H, hd); k/v: (B, T, KV, hd), one type; query s at
    position s sees keys kpos < T with kpos <= s (causal) and
    kpos > s - sliding_window (window > 0); without the causal mask
    every key, and S may exceed T -> (B, S, H, hd) in q's type.
    Differentiable: on the card through ``flash_attention_backward`` when
    grad is on and an operand requires it; otherwise the served entry
    alone."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if not _wants_grad(q, k, v):
        return _flash_forward(q, k, v, causal, sliding_window)
    return _FlashAttention.apply(q, k, v, causal, sliding_window)


def check_backward_operands(q, k, v, out, dout, causal: bool,
                            sliding_window: int):
    """Raise unless the operands are what the backward kernel takes: the
    forward's (``check_flash_operands``, but V and the output may have a
    head dim of their own), out and dout (B, S, H, hdv) of q's type, both
    head dims multiples of 8 and at most ``BACKWARD_MAX_HEAD_DIM``."""
    check_flash_operands(q, k, k, causal, sliding_window)  # q and k
    for t in (v, out, dout):
        if t.device != q.device or t.dtype != q.dtype \
                or not t.is_contiguous():
            raise ValueError("flash attention backward: v, out and dout must "
                             "be contiguous, of q's type and device")
    B, S, H, hd = q.shape
    hdv = v.shape[-1]
    if v.shape[:3] != k.shape[:3] or out.shape != (B, S, H, hdv) \
            or dout.shape != out.shape:
        raise ValueError(f"bad shapes v={tuple(v.shape)} "
                         f"out={tuple(out.shape)} dout={tuple(dout.shape)}")
    if hdv % 8 or max(hd, hdv) > BACKWARD_MAX_HEAD_DIM:
        raise ValueError(f"head dims {hd}/{hdv}: the backward kernel takes "
                         f"multiples of 8 up to {BACKWARD_MAX_HEAD_DIM}")


def flash_attention_backward_plain(q, k, v, out, dout, *, causal: bool = True,
                                   sliding_window: int = 0):
    """The same function in plain PyTorch: ``torch.autograd.grad`` of
    ``flash_attention_plain`` at (q, k, v) against ``dout`` (``out`` is
    recomputed, so unused) -> (dq, dk, dv)."""
    del out
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        o = flash_attention_plain(*qkv, causal=causal,
                                  sliding_window=sliding_window)
        return torch.autograd.grad(o, qkv, dout)


def _check_lse(lse, q):
    B, S, H = q.shape[:3]
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous f32 (B, H, S) = "
                         f"{(B, H, S)} tensor on q's device, got "
                         f"{tuple(lse.shape)} {lse.dtype}")


def flash_attention_backward(q, k, v, out, dout, *, causal: bool = True,
                             sliding_window: int = 0, lse=None):
    """The gradient of ``flash_attention`` (masks as there): q (B, S, H,
    hd), k (B, T, KV, hd), v (B, T, KV, hdv), the forward's out and the
    incoming dout (B, S, H, hdv) -> (dq, dk, dv) in q's type; scale
    1/sqrt(hd).  GQA's group sum lands in dk/dv.  On a CPU tensor the
    plain version; on a CUDA tensor the entry ``flash_backward_entry``
    picks, or a raise.  The tensor-core entries (bf16 at hd = hdv in
    ``MMA_HEAD_DIMS``, f32 at hd = hdv in ``TF32_BACKWARD_HEAD_DIMS``:
    delta = rowsum(dout * out), then dk/dv, then dq) take each row's
    logsumexp ``lse`` (B, H, S) f32 as the ``*_lse`` forward entry stores
    it; without one they launch that entry to get it.  The CUDA-core
    entry (other head dims) recomputes it in a first pass and ignores
    ``lse``."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(
            q, k, v, out, dout, causal=causal, sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward: no kernel for "
                         f"{q.device}")
    check_backward_operands(q, k, v, out, dout, causal, sliding_window)
    B, S, H, hd = q.shape
    T, KV, hdv = k.shape[1], k.shape[2], v.shape[-1]
    entry = flash_backward_entry((q.dtype,), hd, hdv)
    if backward_takes_lse(q, v):
        if lse is None:
            _, lse = _flash_forward(q, k, v, causal, sliding_window,
                                    lse=True)
        _check_lse(lse, q)
    else:  # the CUDA-core entry writes its own
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    BACKWARD_KERNEL.launch(
        entry, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), B, S, T, H, KV, hd, hdv,
        int(causal), int(sliding_window), ctypes.c_float(1.0 / np.sqrt(hd)),
        stream)
    return dq, dk, dv


def mla_flash_entry(dtypes, dims) -> str:
    """The C entry of ``FLASH_KERNEL`` that serves MLA's operands of these
    types (q, k_nope, rope key, V) and ``dims`` (nope, rope, v head dims):
    ``flash_attention_mla_bf16_mma`` for bf16 throughout at ``MLA_DIMS``,
    else the entry ``flash_entry`` picks for ``mla_gqa_operands``'
    concatenation.  From dtypes and dims alone, never from a failed build
    or launch."""
    if tuple(dims) == MLA_DIMS and all(d == torch.bfloat16 for d in dtypes):
        return "flash_attention_mla_bf16_mma"
    return flash_entry(dtypes[0], dims[0] + dims[1])


def mla_flash_attention_plain(q, k_nope, k_rope, v):
    """The same function in plain PyTorch: causal ``naive_attention`` over
    ``mla_gqa_operands``, cut to V's head dim."""
    k, vp = mla_gqa_operands(k_nope, k_rope, v)
    return flash_attention_plain(q, k, vp, causal=True)[..., :v.shape[-1]]


def _check_mla_flash_operands(q, k_nope, k_rope, v):
    check_mla_operands(q, k_nope, k_rope, v, 4)
    S, T = q.shape[1], k_nope.shape[1]
    if k_rope.shape[1] != T or not 1 <= S <= T:
        raise ValueError(f"{S} queries over {T} keys and "
                         f"{k_rope.shape[1]} rope keys: the kernel takes "
                         "1 <= S <= T rope keys")


def _mla_flash_forward(q, k_nope, k_rope, v, lse: bool = False):
    """Launch ``flash_attention_mla_bf16_mma`` on MLA's own operands; with
    ``lse`` its ``*_lse`` twin, and return (out, lse (B, H, S) f32)."""
    _check_mla_flash_operands(q, k_nope, k_rope, v)
    B, S, H, hd = q.shape
    T = k_nope.shape[1]
    out = torch.empty((B, S, H, v.shape[-1]), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [q.data_ptr(), k_nope.data_ptr(), k_rope.data_ptr(), v.data_ptr(),
            out.data_ptr()]
    rows = None
    if lse:
        rows = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        ptrs.append(rows.data_ptr())
    FLASH_KERNEL.launch(
        LSE_ENTRIES["flash_attention_mla_bf16_mma"] if lse
        else "flash_attention_mla_bf16_mma", *ptrs, B, S, T, H,
        ctypes.c_float(1.0 / np.sqrt(hd)), stream)
    return (out, rows) if lse else out


def mla_flash_attention_backward(q, k_nope, k_rope, v, out, dout, *,
                                 lse=None):
    """The gradient of ``mla_flash_attention`` on MLA's own operands (bf16
    at ``MLA_DIMS``): the forward's out and the incoming dout (B, S, H,
    vd) -> (dq (B, S, H, nope + rope), dk_nope (B, T, H, nope), d_rope
    (B, T, rope), the rope key's gradient summed over the heads that share
    it, dv (B, T, H, vd)).  CUDA tensors only (on the CPU torch
    differentiates ``mla_flash_attention_plain``):
    ``flash_attention_backward_mla_bf16_mma``, which assembles each K tile
    from k_nope and the rope key in shared memory (no broadcast K or (B,
    T, H, nope + rope) dk is built), from ``lse`` (B, H, S) f32 as
    ``flash_attention_mla_bf16_mma_lse`` stores it (launched here when
    none is given).  Beyond the gradients it holds delta (B, H, S) f32
    only: the rope key's per-group f32 partials live in dq's storage,
    which the kernel writes last (a tensor of their own where dq is
    smaller, S < T / 12 at 128 heads)."""
    if q.device.type != "cuda":
        raise ValueError(f"mla_flash_attention_backward: no kernel for "
                         f"{q.device}")
    _check_mla_flash_operands(q, k_nope, k_rope, v)
    B, S, H, hd = q.shape
    T, vd = k_nope.shape[1], v.shape[-1]
    if out.shape != (B, S, H, vd) or dout.shape != out.shape or any(
            t.dtype != q.dtype or t.device != q.device
            or not t.is_contiguous() for t in (out, dout)):
        raise ValueError(f"out {tuple(out.shape)} / dout "
                         f"{tuple(dout.shape)}: contiguous {(B, S, H, vd)} "
                         "of q's type and device")
    entry = flash_backward_entry(
        (q.dtype, k_nope.dtype, k_rope.dtype, v.dtype), hd, vd, mla=True)
    if lse is None:
        _, lse = _mla_flash_forward(q, k_nope, k_rope, v, lse=True)
    _check_lse(lse, q)
    dq, dk_nope, dv = (torch.empty_like(t) for t in (q, k_nope, v))
    d_rope = torch.empty((B, T, k_rope.shape[-1]), dtype=k_rope.dtype,
                         device=q.device)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    part_bytes = B * T * -(-H // BACKWARD_MLA_HEADS) * k_rope.shape[-1] * 4
    rope_part = dq if dq.numel() * dq.element_size() >= part_bytes else \
        torch.empty(part_bytes, dtype=torch.uint8, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    BACKWARD_KERNEL.launch(
        entry, q.data_ptr(), k_nope.data_ptr(), k_rope.data_ptr(),
        v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dk_nope.data_ptr(), d_rope.data_ptr(), dv.data_ptr(),
        delta.data_ptr(), rope_part.data_ptr(), B, S, T, H,
        ctypes.c_float(1.0 / np.sqrt(hd)), stream)
    return dq, dk_nope, d_rope, dv


class _MlaFlashAttention(torch.autograd.Function):
    """MLA's B2 entry with its gradient: the forward's ``*_lse`` twin, then
    ``mla_flash_attention_backward`` on the same operands (the rope key
    read in place, its gradient summed over the heads in the kernel)."""

    @staticmethod
    def forward(ctx, q, k_nope, k_rope, v):
        out, lse = _mla_flash_forward(q, k_nope, k_rope, v, lse=True)
        ctx.save_for_backward(q, k_nope, k_rope, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k_nope, k_rope, v, out, lse = ctx.saved_tensors
        return mla_flash_attention_backward(q, k_nope, k_rope, v, out,
                                            dout.contiguous(), lse=lse)


def mla_flash_attention(q, k_nope, k_rope, v):
    """q: (B, S, H, nope + rope) = [q_nope | q_rope]; k_nope (B, T, H,
    nope); k_rope (B, T, rope), one rope key per token shared by every
    head; v (B, T, H, vd); query s at position s sees keys kpos <= s
    (causal, as MLA's prefill) -> (B, S, H, vd) in q's type.  Scale
    1/sqrt(nope + rope).  bf16 at ``MLA_DIMS`` launches
    ``flash_attention_mla_bf16_mma``; other types or dims launch the GQA
    entry over ``mla_gqa_operands``.  Differentiable on the card (with
    grad on and an operand that requires it): the MLA entry through
    ``_MlaFlashAttention``, the GQA one through ``flash_attention`` and
    the torch ops that build its operands."""
    if q.device.type == "cpu":
        return mla_flash_attention_plain(q, k_nope, k_rope, v)
    if q.device.type != "cuda":
        raise ValueError(f"mla_flash_attention: no kernel for {q.device}")
    dims = (k_nope.shape[-1], k_rope.shape[-1], v.shape[-1])
    entry = mla_flash_entry((q.dtype, k_nope.dtype, k_rope.dtype, v.dtype),
                            dims)
    if entry != "flash_attention_mla_bf16_mma":
        k, vp = mla_gqa_operands(k_nope, k_rope, v)
        return flash_attention(q, k, vp, causal=True)[..., :v.shape[-1]]
    if not _wants_grad(q, k_nope, k_rope, v):
        return _mla_flash_forward(q, k_nope, k_rope, v)
    return _MlaFlashAttention.apply(q, k_nope, k_rope, v)
