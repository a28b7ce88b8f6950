"""Decode attention: CUDA kernel wrappers, plain versions, checks.

``paged_decode_attention`` is the port of
``repro/kernels/decode_attention/kernel.py::paged_decode_attention``
(see ``csrc/paged_decode.cu`` for the kernel and what bounds it).  It
takes the serving engine's pool layout ``(nb, bs, KV, hd)`` directly.
``decode_attention`` is the port of ``decode_attention`` in the same
file, the dense engine's one-token step over a contiguous cache (see
``csrc/dense_decode.cu``).  ``paged_decode_attention_quant`` is the port
of ``paged_decode_attention_quant`` there, the paged step over int8
pools with per-row f32 scales (see ``csrc/paged_decode_quant.cu``).  On
a CPU tensor each runs its plain version; on a CUDA tensor it launches
its kernel or raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from ..build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "paged_decode_attention",
    Path(__file__).parent / "csrc" / "paged_decode.cu",
    {f"paged_decode_attention_{q}_{kv}":
     [_P] * 6 + [_I] * 6 + [ctypes.c_float, _P]
     for q, kv in (("f32", "f32"), ("f32", "bf16"), ("bf16", "bf16"))})

QUANT_KERNEL = CudaKernel(
    "paged_decode_attention_quant",
    Path(__file__).parent / "csrc" / "paged_decode_quant.cu",
    {"paged_decode_attention_quant_f32": [_P] * 8 + [_I] * 6
     + [ctypes.c_float, _P]})

DENSE_KERNEL = CudaKernel(
    "decode_attention",
    Path(__file__).parent / "csrc" / "dense_decode.cu",
    {f"decode_attention_{q}_{kv}": [_P] * 4 + [_I] * 6 + [ctypes.c_float, _P]
     for q, kv in (("f32", "f32"), ("f32", "bf16"), ("bf16", "bf16"))})

_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# (query type, K/V type) pairs the kernels are built for: a bf16 model
# with an f32 pool is refused by the engine (see ServeEngine)
SUPPORTED = {(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.bfloat16)}


def check_paged_operands(q, k_pool, v_pool, page_table, lengths, n_q_dims,
                         scales=()):
    """Raise unless the operands are what the paged kernels take: one
    CUDA device, contiguous, a supported (q, K/V) type pair, pools of
    shape (nb, bs, KV, hd) with KV dividing q's heads and hd % 8 == 0,
    int32 page table (B, P) and lengths (B,).  With ``scales`` (the
    int8 kernels' k_scale, v_scale): f32 q, int8 pools, f32 scales of
    shape (nb, bs, KV) and hd % 16 == 0."""
    ts = (q, k_pool, v_pool, page_table, lengths) + tuple(scales)
    if any(t.device != q.device for t in ts):
        raise ValueError("paged attention operands must share one device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("paged attention operands must be contiguous")
    if scales:
        if q.dtype != torch.float32 or k_pool.dtype != torch.int8 \
                or v_pool.dtype != torch.int8 \
                or any(s.dtype != torch.float32 for s in scales):
            raise TypeError(f"the int8 kernels take f32 q, int8 pools and "
                            f"f32 scales, got q={q.dtype} k={k_pool.dtype} "
                            f"v={v_pool.dtype} scales="
                            f"{[s.dtype for s in scales]}")
        if any(tuple(s.shape) != tuple(k_pool.shape[:3]) for s in scales):
            raise ValueError(f"scales {[tuple(s.shape) for s in scales]} do "
                             f"not match pool {tuple(k_pool.shape)}")
    elif (q.dtype, k_pool.dtype) not in SUPPORTED \
            or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"unsupported dtypes q={q.dtype} k={k_pool.dtype} "
                        f"v={v_pool.dtype}; kernels take {sorted(map(str, SUPPORTED))}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    if q.dim() != n_q_dims or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"bad shapes q={tuple(q.shape)} "
                         f"k={tuple(k_pool.shape)} v={tuple(v_pool.shape)}")
    B, H, hd = q.shape[0], q.shape[-2], q.shape[-1]
    KV = k_pool.shape[2]
    if k_pool.shape[3] != hd or H % KV:
        raise ValueError(f"q heads/head_dim {H}/{hd} do not fit pool "
                         f"{tuple(k_pool.shape)}")
    chunk = 16 if scales else 8          # values per 16-byte load
    if hd % chunk:
        raise ValueError(f"head_dim {hd}: the kernels load K/V rows in "
                         f"16-byte chunks and need head_dim % {chunk} == 0")
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {B}")


def paged_decode_attention_plain(q, k_pool, v_pool, page_table, lengths):
    """The same function in plain PyTorch: the reference's
    ``paged_attention`` over ``paged_gather`` with query position
    ``lengths - 1`` (keys ``kpos < lengths`` are visible)."""
    # imported here: models.attention imports this module
    from ...models.attention import paged_attention, paged_gather
    o = paged_attention(q[:, None], paged_gather(k_pool, page_table),
                        paged_gather(v_pool, page_table),
                        (lengths - 1)[:, None])
    return o[:, 0]


def paged_decode_attention(q, k_pool, v_pool, page_table, lengths):
    """q: (B, H, hd); k_pool/v_pool: (nb, bs, KV, hd); page_table: (B, P)
    int32; lengths: (B,) int32 >= 1, the number of valid keys of each
    slot -> (B, H, hd) in the pool's dtype."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, page_table,
                                            lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    check_paged_operands(q, k_pool, v_pool, page_table, lengths, 3)
    B, H, hd = q.shape
    bs, KV = k_pool.shape[1], k_pool.shape[2]
    out = torch.empty(q.shape, dtype=k_pool.dtype, device=q.device)
    # the kernel launches on the runtime's current device: one card
    stream = torch.cuda.current_stream(q.device).cuda_stream
    KERNEL.launch(
        f"paged_decode_attention_{_NAMES[q.dtype]}_{_NAMES[k_pool.dtype]}",
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, H, KV, hd, bs, page_table.shape[1],
        ctypes.c_float(1.0 / np.sqrt(hd)), stream)
    return out


def paged_decode_attention_quant_plain(q, k_pool, v_pool, k_scale, v_scale,
                                       page_table, lengths):
    """The same function in plain PyTorch: the reference's
    ``paged_attention`` over ``dequant_gather`` with
    query position ``lengths - 1``."""
    # imported here: models.attention imports this module
    from ...models.attention import dequant_gather, paged_attention
    k = dequant_gather(k_pool, k_scale, page_table)
    v = dequant_gather(v_pool, v_scale, page_table)
    return paged_attention(q[:, None], k, v, (lengths - 1)[:, None])[:, 0]


def paged_decode_attention_quant(q, k_pool, v_pool, k_scale, v_scale,
                                 page_table, lengths):
    """q: (B, H, hd) f32; k_pool/v_pool: (nb, bs, KV, hd) int8;
    k_scale/v_scale: (nb, bs, KV) f32 per-row scales; page_table: (B, P)
    int32; lengths: (B,) int32 >= 1 valid keys -> (B, H, hd) f32."""
    if q.device.type == "cpu":
        return paged_decode_attention_quant_plain(
            q, k_pool, v_pool, k_scale, v_scale, page_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_decode_attention_quant: no kernel for {q.device}")
    check_paged_operands(q, k_pool, v_pool, page_table, lengths, 3,
                         scales=(k_scale, v_scale))
    B, H, hd = q.shape
    bs, KV = k_pool.shape[1], k_pool.shape[2]
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    QUANT_KERNEL.launch(
        "paged_decode_attention_quant_f32",
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, H, KV, hd, bs,
        page_table.shape[1], ctypes.c_float(1.0 / np.sqrt(hd)), stream)
    return out


def check_dense_operands(q, k_cache, v_cache, n_valid):
    """Raise unless the operands are what the dense decode kernel takes:
    one CUDA device, contiguous, a supported (q, K/V) type pair, q (B, H,
    hd) and caches (B, C, KV, hd) with KV dividing H and hd % 8 == 0, and
    1 <= n_valid <= C."""
    ts = (q, k_cache, v_cache)
    if any(t.device != q.device for t in ts):
        raise ValueError("decode attention operands must share one device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("decode attention operands must be contiguous")
    if (q.dtype, k_cache.dtype) not in SUPPORTED \
            or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"unsupported dtypes q={q.dtype} k={k_cache.dtype} "
                        f"v={v_cache.dtype}; the kernel takes "
                        f"{sorted(map(str, SUPPORTED))}")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"bad shapes q={tuple(q.shape)} "
                         f"k={tuple(k_cache.shape)} v={tuple(v_cache.shape)}")
    B, H, hd = q.shape
    C, KV = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != hd or H % KV:
        raise ValueError(f"q {tuple(q.shape)} does not fit cache "
                         f"{tuple(k_cache.shape)}")
    if hd % 8:
        raise ValueError(f"head_dim {hd}: the kernel loads K/V rows in "
                         "16-byte chunks and needs head_dim % 8 == 0")
    if not 1 <= n_valid <= C:
        raise ValueError(f"n_valid {n_valid} outside [1, {C}]")


def decode_attention_plain(q, k_cache, v_cache, n_valid: int):
    """The same function in plain PyTorch: the reference's
    ``decode_attention`` with the new token at position ``n_valid - 1``
    (slots ``< n_valid`` are visible)."""
    # imported here: models.attention imports this module
    from ...models.attention import decode_attention as reference
    return reference(q[:, None], k_cache, v_cache, n_valid - 1)[:, 0]


def decode_attention(q, k_cache, v_cache, n_valid: int):
    """q: (B, H, hd); k_cache/v_cache: (B, C, KV, hd); n_valid: host int,
    the slots every row attends to (``min(pos + 1, C)``: a wrapped ring
    has all C valid) -> (B, H, hd) in the cache's dtype."""
    n_valid = int(n_valid)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, n_valid)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    check_dense_operands(q, k_cache, v_cache, n_valid)
    B, H, hd = q.shape
    C, KV = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty(q.shape, dtype=k_cache.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    DENSE_KERNEL.launch(
        f"decode_attention_{_NAMES[q.dtype]}_{_NAMES[k_cache.dtype]}",
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        B, C, H, KV, hd, n_valid, ctypes.c_float(1.0 / np.sqrt(hd)), stream)
    return out
