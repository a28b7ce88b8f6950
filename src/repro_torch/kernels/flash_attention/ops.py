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

The libraries hold three bodies.  At head_dim 64 or 128 everything
runs on the tensor cores: bf16 (``csrc/prefill_mma.cuh``, the ``*_mma``
entries) and f32 q over f32, bf16 or int8 K/V in split TF32
(``csrc/prefill_tf32.cuh``, the ``*_tf32`` entries); at any other
head_dim on CUDA cores (``csrc/prefill_body.cuh``).  bf16 MLA operands
at ``MLA_DIMS`` run the bf16 tensor-core body with a q/k head of 192
and a V head of 128 (``flash_attention_mla_bf16_mma``).
``paged_prefill_entry``, ``quant_prefill_entry``, ``flash_entry`` and
``mla_flash_entry`` pick the entry from dtypes and dims alone.
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
     + [ctypes.c_float, _P]})
# head_dims the GQA tensor-core bodies are instantiated for: smollm-360m's
# and jamba-v0.1's (and most configs'; 56 takes the CUDA-core body).
# DeepSeek-V3's MLA (q/k 192, V 128) has its own tensor-core entry
# (mla_flash_entry); 192 with V as wide takes the CUDA-core body.
MMA_HEAD_DIMS = (64, 128)


def _body(dtypes, hd: int) -> str:
    """Entry suffix of the body that serves these operands (q's type
    first): at head_dim 64 or 128 ``_mma`` (bf16 tensor cores) for bf16
    throughout and ``_tf32`` (split TF32 tensor cores) for f32 q, else
    ``""`` (the CUDA-core body)."""
    if hd not in MMA_HEAD_DIMS:
        return ""
    if all(d == torch.bfloat16 for d in dtypes):
        return "_mma"
    return "_tf32" if dtypes[0] == torch.float32 else ""


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


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0):
    """q: (B, S, H, hd); k/v: (B, T, KV, hd), one type; query s at
    position s sees keys kpos < T with kpos <= s (causal) and
    kpos > s - sliding_window (window > 0); without the causal mask
    every key, and S may exceed T -> (B, S, H, hd) in q's type."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    check_flash_operands(q, k, v, causal, sliding_window)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    FLASH_KERNEL.launch(
        flash_entry(q.dtype, hd),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, T, H, KV, hd, int(causal), int(sliding_window),
        ctypes.c_float(1.0 / np.sqrt(hd)), stream)
    return out


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


def mla_flash_attention(q, k_nope, k_rope, v):
    """q: (B, S, H, nope + rope) = [q_nope | q_rope]; k_nope (B, T, H,
    nope); k_rope (B, T, rope), one rope key per token shared by every
    head; v (B, T, H, vd); query s at position s sees keys kpos <= s
    (causal, as MLA's prefill) -> (B, S, H, vd) in q's type.  Scale
    1/sqrt(nope + rope).  bf16 at ``MLA_DIMS`` launches
    ``flash_attention_mla_bf16_mma``; other types or dims launch the GQA
    entry over ``mla_gqa_operands``."""
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
    check_mla_operands(q, k_nope, k_rope, v, 4)
    B, S, H, hd = q.shape
    T = k_nope.shape[1]
    if k_rope.shape[1] != T or not 1 <= S <= T:
        raise ValueError(f"{S} queries over {T} keys and "
                         f"{k_rope.shape[1]} rope keys: the kernel takes "
                         "1 <= S <= T rope keys")
    out = torch.empty((B, S, H, v.shape[-1]), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    FLASH_KERNEL.launch(
        entry, q.data_ptr(), k_nope.data_ptr(), k_rope.data_ptr(),
        v.data_ptr(), out.data_ptr(), B, S, T, H,
        ctypes.c_float(1.0 / np.sqrt(hd)), stream)
    return out
