"""TensorTransform — elementwise/layout operators on tensor streams.

Supports NNStreamer's operator set as a *chain*:
  typecast:<dtype>, add:<v>, subtract:<v>, multiply:<v>, divide:<v>,
  clamp:<lo>:<hi>, normalize (mean/std standardization), transpose:<perm>

Chains parse from gst-style option strings:
  ``option="typecast:float32,divide:255.0,subtract:0.5"``

Backends:
  * "numpy"  — eager, one pass per op (the naive baseline in E4 terms)
  * "fused"  — single fused pass through the hand-written kernel
               (``kernels/transform``, B7) on the element's device: CUDA
               unless the caller names the CPU, where the kernel's plain
               version runs; the arith chain is folded into one
               scale/bias/clamp affine op (``fold_affine``) before launch.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...kernels.transform import ops as tops
from ...models.common import resolve_device
from ..element import Element, Pad
from ..stream import Buffer, canonical_dtype


class TransformOp:
    def __init__(self, kind: str, *args):
        self.kind = kind
        self.args = args

    def __repr__(self):
        return f"TransformOp({self.kind}, {self.args})"


def parse_chain(option: str) -> List[TransformOp]:
    ops: List[TransformOp] = []
    for item in option.split(","):
        item = item.strip()
        if not item:
            continue
        parts = item.split(":")
        kind = parts[0]
        if kind == "typecast":
            ops.append(TransformOp("typecast", canonical_dtype(parts[1])))
        elif kind in ("add", "subtract", "multiply", "divide"):
            ops.append(TransformOp(kind, float(parts[1])))
        elif kind == "clamp":
            ops.append(TransformOp("clamp", float(parts[1]), float(parts[2])))
        elif kind == "normalize":
            ops.append(TransformOp("normalize"))
        elif kind == "transpose":
            perm = tuple(int(p) for p in parts[1:])
            ops.append(TransformOp("transpose", perm))
        else:
            raise ValueError(f"unknown transform op {kind!r}")
    return ops


def fold_affine(ops: Sequence[TransformOp]) -> Optional[Tuple[float, float, float, float, Optional[str]]]:
    """Fold a pure arith/typecast chain into (scale, bias, lo, hi, dtype).

    Returns None if the chain contains normalize/transpose (not foldable).
    y = clamp(x * scale + bias, lo, hi), then cast.
    """
    scale, bias = 1.0, 0.0
    lo, hi = -np.inf, np.inf
    out_dtype: Optional[str] = None
    for op in ops:
        if op.kind == "typecast":
            out_dtype = op.args[0]
        elif op.kind == "add":
            bias += op.args[0]
        elif op.kind == "subtract":
            bias -= op.args[0]
        elif op.kind == "multiply":
            scale *= op.args[0]
            bias *= op.args[0]
        elif op.kind == "divide":
            scale /= op.args[0]
            bias /= op.args[0]
        elif op.kind == "clamp":
            # clamp then further affine is NOT foldable in general; only
            # allow clamp as the terminal arith op
            lo, hi = op.args
        else:
            return None
    return scale, bias, lo, hi, out_dtype


def apply_chain_numpy(arr: np.ndarray, ops: Sequence[TransformOp]) -> np.ndarray:
    out = arr
    for op in ops:
        if op.kind == "typecast":
            out = out.astype(op.args[0])
        elif op.kind == "add":
            out = out + op.args[0]
        elif op.kind == "subtract":
            out = out - op.args[0]
        elif op.kind == "multiply":
            out = out * op.args[0]
        elif op.kind == "divide":
            out = out / op.args[0]
        elif op.kind == "clamp":
            out = np.clip(out, op.args[0], op.args[1])
        elif op.kind == "normalize":
            mean = out.mean()
            std = out.std()
            out = (out - mean) / (std + 1e-8)
        elif op.kind == "transpose":
            out = np.transpose(out, op.args[0])
        else:
            raise ValueError(op.kind)
    return out


def _to_torch(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":      # numpy has no bf16 of its own
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


class TensorTransform(Element):
    def __init__(self, name: str, option: str, backend: str = "numpy",
                 device=None):
        super().__init__(name)
        if backend not in ("numpy", "fused"):
            raise ValueError(f"unknown TensorTransform backend {backend!r}")
        self.add_sink_pad()
        self.add_src_pad()
        self.ops = parse_chain(option)
        self.backend = backend
        self._fused = None
        self.device = None
        if backend == "fused":
            folded = fold_affine(self.ops)
            if folded is None:
                raise ValueError(
                    "fused backend requires a foldable arith/typecast chain")
            self._fused = folded
            self.device = resolve_device(device)

    def transform(self, pad: Pad, buf: Buffer) -> Optional[Buffer]:
        arr = np.asarray(buf.data)
        if self.backend == "fused":
            scale, bias, lo, hi, dtype = self._fused
            out = _to_numpy(tops.fused_transform(
                _to_torch(arr, self.device), scale=scale, bias=bias, lo=lo,
                hi=hi, out_dtype=getattr(torch, dtype) if dtype else None))
        else:
            out = apply_chain_numpy(arr, self.ops)
        return buf.with_chunks(out)
