"""Top-k MoE gating: CUDA kernel wrapper and plain version.

``gating_topk`` is the port of
``repro/kernels/moe_gating/kernel.py::gating_topk`` (see
``csrc/gating_topk.cu``).  On a CPU tensor it runs
``gating_topk_plain``; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "gating_topk",
    Path(__file__).parent / "csrc" / "gating_topk.cu",
    {"gating_topk_f32": [_P] * 3 + [_I] * 3 + [_P]})

MAX_EXPERTS, MAX_K = 256, 8
NEG = -1e30             # the TPU kernel's mask for an entry already taken


def check_gating_operands(scores, k: int) -> None:
    """Raise unless ``scores`` is a contiguous f32 (T, E) tensor with
    E <= 256 and 1 <= k <= min(E, 8)."""
    if scores.dtype != torch.float32:
        raise TypeError(f"gating scores must be float32, got {scores.dtype}")
    if scores.dim() != 2 or not scores.is_contiguous():
        raise ValueError(f"gating scores must be a contiguous (T, E) "
                         f"tensor, got {tuple(scores.shape)}")
    E = scores.shape[1]
    if not 1 <= E <= MAX_EXPERTS or not 1 <= k <= min(E, MAX_K):
        raise ValueError(f"top-{k} of {E} experts: the kernel takes "
                         f"E <= {MAX_EXPERTS} and 1 <= k <= min(E, {MAX_K})")


def gating_topk_plain(scores, k: int):
    """The same function in plain PyTorch, the TPU kernel's rule written
    out: k passes of max plus *first* argmax, the taken entry masked to
    -1e30.  Ties go to the lowest index explicitly — ``torch.topk``
    promises no order among equal values.  (T, E) -> (vals (T, k) f32,
    idx (T, k) int32)."""
    s = scores.float()
    E = s.shape[-1]
    eidx = torch.arange(E, device=s.device)
    vals, idx = [], []
    for _ in range(k):
        m = s.max(dim=-1).values
        first = torch.where(s == m[:, None], eidx, E).min(dim=-1).values
        vals.append(m)
        idx.append(first)
        s = torch.where(eidx == first[:, None], NEG, s)
    return torch.stack(vals, dim=1), torch.stack(idx, dim=1).to(torch.int32)


def gating_topk(scores, k: int):
    """scores: (T, E) float32 -> (vals (T, k) float32 largest first,
    idx (T, k) int32), ties to the lowest expert index."""
    if scores.device.type == "cpu":
        return gating_topk_plain(scores, k)
    if scores.device.type != "cuda":
        raise ValueError(f"gating_topk: no kernel for {scores.device}")
    check_gating_operands(scores, k)
    T = scores.shape[0]
    vals = torch.empty((T, k), dtype=torch.float32, device=scores.device)
    idx = torch.empty((T, k), dtype=torch.int32, device=scores.device)
    if T == 0:
        return vals, idx
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    KERNEL.launch("gating_topk_f32", scores.data_ptr(), vals.data_ptr(),
                  idx.data_ptr(), T, scores.shape[1], k, stream)
    return vals, idx
