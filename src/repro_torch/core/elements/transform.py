"""TensorTransform — elementwise/layout operators on tensor streams.

Supports NNStreamer's operator set as a *chain*:
  typecast:<dtype>, add:<v>, subtract:<v>, multiply:<v>, divide:<v>,
  clamp:<lo>:<hi>, normalize (mean/std standardization), transpose:<perm>

Chains parse from gst-style option strings:
  ``option="typecast:float32,divide:255.0,subtract:0.5"``

Backends:
  * "numpy"  — eager, one pass per op (the naive baseline in E4 terms)
  * "fused"  — single fused pass through a hand-written kernel; not
               ported yet (raises).  ``fold_affine`` folds the arith
               chain into the one scale/bias/clamp op that kernel takes.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

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


class TensorTransform(Element):
    def __init__(self, name: str, option: str, backend: str = "numpy"):
        super().__init__(name)
        if backend == "fused":
            raise NotImplementedError(
                "TensorTransform(backend='fused') needs the fused_transform_2d "
                "kernel, not yet ported (ROADMAP B7, A14)")
        if backend != "numpy":
            raise ValueError(f"unknown TensorTransform backend {backend!r}")
        self.add_sink_pad()
        self.add_src_pad()
        self.ops = parse_chain(option)
        self.backend = backend

    def transform(self, pad: Pad, buf: Buffer) -> Optional[Buffer]:
        return buf.with_chunks(apply_chain_numpy(np.asarray(buf.data),
                                                 self.ops))
