"""Paged decode attention: CUDA kernel wrapper, plain version, checks.

``paged_decode_attention`` is the port of
``repro/kernels/decode_attention/kernel.py::paged_decode_attention``
(see ``csrc/paged_decode.cu`` for the kernel and what bounds it).  It
takes the serving engine's pool layout ``(nb, bs, KV, hd)`` directly.
On a CPU tensor it runs ``paged_decode_attention_plain``; on a CUDA
tensor it launches the kernel or raises.
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

_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# (query type, K/V type) pairs the kernels are built for: a bf16 model
# with an f32 pool is refused by the engine (see ServeEngine)
SUPPORTED = {(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.bfloat16)}


def check_paged_operands(q, k_pool, v_pool, page_table, lengths, n_q_dims):
    """Raise unless the operands are what the paged kernels take: one
    CUDA device, contiguous, a supported (q, K/V) type pair, pools of
    shape (nb, bs, KV, hd) with KV dividing q's heads and hd % 8 == 0,
    int32 page table (B, P) and lengths (B,)."""
    ts = (q, k_pool, v_pool, page_table, lengths)
    if any(t.device != q.device for t in ts):
        raise ValueError("paged attention operands must share one device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("paged attention operands must be contiguous")
    if (q.dtype, k_pool.dtype) not in SUPPORTED or v_pool.dtype != k_pool.dtype:
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
    if hd % 8:
        raise ValueError(f"head_dim {hd}: the kernels load K/V rows in "
                         "16-byte chunks and need head_dim % 8 == 0")
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
