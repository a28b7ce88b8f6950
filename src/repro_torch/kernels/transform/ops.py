"""Fused tensor_transform: CUDA kernel wrapper and plain version.

``fused_transform`` is the port of
``repro/kernels/transform/kernel.py::fused_transform_2d`` behind
``TensorTransform(backend="fused")`` (see ``csrc/fused_transform.cu``):
``y = cast(clip(f32(x) * scale + bias, lo, hi))`` over any shape, in one
pass.  On a CPU tensor it runs its plain version; on a CUDA tensor it
launches the kernel or raises.

Both follow the reference's arithmetic: ``scale``, ``bias``, ``lo`` and
``hi`` are rounded to f32 (JAX's weak-typed Python floats), the product
and the sum round separately, the clip keeps NaN, and casts to integer
types saturate as JAX's do (NaN -> 0, truncation toward zero, clamped to
the type's range).  The 64-bit types are refused: JAX without x64
computes them in 32 bits, so there is no reference to hold them to.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from ..build import CudaKernel

_P = ctypes.c_void_p
_F = ctypes.c_float
KERNEL = CudaKernel(
    "fused_transform",
    Path(__file__).parent / "csrc" / "fused_transform.cu",
    {"fused_transform": [ctypes.c_int, ctypes.c_int, _P, _P,
                         ctypes.c_longlong, _F, _F, _F, _F, _P]})

# the stream's element types the kernel is built for, by its type code
DTYPES = (torch.bool, torch.uint8, torch.int8, torch.uint16, torch.int16,
          torch.uint32, torch.int32, torch.float16, torch.bfloat16,
          torch.float32)
_CODE = {dt: i for i, dt in enumerate(DTYPES)}
_INT = (torch.uint8, torch.int8, torch.uint16, torch.int16, torch.uint32,
        torch.int32)


def _f32(v: float) -> float:
    """``v`` rounded to f32, as JAX rounds a weak-typed Python float."""
    return float(np.float32(v))


def _check_dtypes(x, out_dtype) -> None:
    for dt in (x.dtype, out_dtype):
        if dt not in _CODE:
            raise TypeError(
                f"fused_transform: no kernel for {dt}; it takes "
                f"{[str(d)[6:] for d in DTYPES]} (64-bit types are refused)")


def _saturate(y, dtype):
    """f32 -> integer type as JAX casts: NaN -> 0, toward zero, clamped."""
    info = torch.iinfo(dtype)
    t = torch.trunc(y).double().nan_to_num(nan=0.0)
    return t.clamp(info.min, info.max).to(torch.int64).to(dtype)


def fused_transform_plain(x, *, scale: float = 1.0, bias: float = 0.0,
                          lo: float = -np.inf, hi: float = np.inf,
                          out_dtype=None):
    """The same function in plain PyTorch (the reference's
    ``fused_transform_ref`` with JAX's integer casts)."""
    out_dtype = out_dtype or x.dtype
    _check_dtypes(x, out_dtype)
    y = x.to(torch.float32) * _f32(scale)
    y = y + _f32(bias)
    y = torch.clamp(y, _f32(lo), _f32(hi))
    if out_dtype == torch.bool:
        return y != 0
    if out_dtype in _INT:
        return _saturate(y, out_dtype)
    return y.to(out_dtype)


def fused_transform(x, *, scale: float = 1.0, bias: float = 0.0,
                    lo: float = -np.inf, hi: float = np.inf, out_dtype=None):
    """x: any shape of a type in ``DTYPES`` -> the same shape in
    ``out_dtype`` (default: x's type):
    ``cast(clip(f32(x) * scale + bias, lo, hi))``."""
    if x.device.type == "cpu":
        return fused_transform_plain(x, scale=scale, bias=bias, lo=lo, hi=hi,
                                     out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_transform: no kernel for {x.device}")
    out_dtype = out_dtype or x.dtype
    _check_dtypes(x, out_dtype)
    if not x.is_contiguous():
        raise ValueError("fused_transform: x must be contiguous")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch("fused_transform", _CODE[x.dtype], _CODE[out_dtype],
                  x.data_ptr(), out.data_ptr(), x.numel(), _F(_f32(scale)),
                  _F(_f32(bias)), _F(_f32(lo)), _F(_f32(hi)), stream)
    return out
