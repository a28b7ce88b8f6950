"""Paged chunked-prefill attention: CUDA kernel wrapper and plain version.

``paged_prefill_attention`` is the paged form of
``repro/kernels/flash_attention/kernel.py::flash_attention`` that the
serving engine's mixed prefill+decode steps need (see
``csrc/paged_prefill.cu``).  On a CPU tensor it runs
``paged_prefill_attention_plain``; on a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from ..build import CudaKernel
from ..decode_attention.ops import _NAMES, check_paged_operands

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "paged_prefill_attention",
    Path(__file__).parent / "csrc" / "paged_prefill.cu",
    {f"paged_prefill_attention_{q}_{kv}":
     [_P] * 6 + [_I] * 7 + [ctypes.c_float, _P]
     for q, kv in (("f32", "f32"), ("f32", "bf16"), ("bf16", "bf16"))})


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
        f"paged_prefill_attention_{_NAMES[q.dtype]}_{_NAMES[k_pool.dtype]}",
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, T, H, KV, hd, bs, page_table.shape[1],
        ctypes.c_float(1.0 / np.sqrt(hd)), stream)
    return out
