"""Stream data types — the `other/tensor(s)` caps of NNStreamer.

A ``TensorSpec`` is the capability ("caps") of a single tensor stream:
element dtype, dimensions, and a nominal frame rate.  A ``TensorsSpec``
bundles up to ``MAX_TENSORS`` specs with a synchronized frame rate
(NNStreamer's ``other/tensors``).  Rank is *not* semantically significant:
``640:480`` and ``640:480:1:1`` negotiate as equivalent, exactly as the
paper describes, unless a filter explicitly pins the rank
(``require_rank=True`` — the TensorRT-style escape hatch).

A ``Buffer`` is one frame travelling through the pipeline: a tuple of
array chunks (each tensor its own memory chunk, so mux/demux never copy),
a presentation timestamp, and a metadata dict.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Sequence, Tuple

import numpy as np

MAX_TENSORS = 16  # default limit of memory chunks in a frame (paper §III)

_DTYPE_ALIASES = {
    "float32": "float32", "f32": "float32",
    "float16": "float16", "f16": "float16",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "float64": "float64", "f64": "float64",
    "int8": "int8", "uint8": "uint8",
    "int16": "int16", "uint16": "uint16",
    "int32": "int32", "uint32": "uint32",
    "int64": "int64", "uint64": "uint64",
    "bool": "bool",
}


def canonical_dtype(name: str) -> str:
    key = str(name).lower()
    if key not in _DTYPE_ALIASES:
        raise ValueError(f"unsupported tensor element type: {name!r}")
    return _DTYPE_ALIASES[key]


def _strip_rank(dims: Sequence[int]) -> Tuple[int, ...]:
    """Canonical dims: drop trailing 1s (rank-agnostic negotiation)."""
    dims = tuple(int(d) for d in dims)
    while len(dims) > 1 and dims[-1] == 1:
        dims = dims[:-1]
    return dims


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Caps of one tensor stream: ``other/tensor``."""

    dims: Tuple[int, ...]            # innermost-first, gst style "640:480:3"
    dtype: str = "float32"
    framerate: Optional[float] = None  # Hz; None = variable/don't-care
    require_rank: bool = False         # pin exact rank (TensorRT-style NNFWs)

    def __post_init__(self):
        object.__setattr__(self, "dims", tuple(int(d) for d in self.dims))
        object.__setattr__(self, "dtype", canonical_dtype(self.dtype))
        if len(self.dims) == 0:
            raise ValueError("TensorSpec needs at least one dimension")
        if len(self.dims) > 8:
            raise ValueError("TensorSpec supports at most rank 8")
        if any(d <= 0 for d in self.dims):
            raise ValueError(f"dims must be positive, got {self.dims}")

    # -- negotiation ------------------------------------------------------
    def canonical_dims(self) -> Tuple[int, ...]:
        return _strip_rank(self.dims)

    def compatible(self, other: "TensorSpec") -> bool:
        if self.dtype != other.dtype:
            return False
        if self.require_rank or other.require_rank:
            if self.dims != other.dims:
                return False
        elif self.canonical_dims() != other.canonical_dims():
            return False
        if (self.framerate is not None and other.framerate is not None
                and abs(self.framerate - other.framerate) > 1e-9):
            return False
        return True

    # -- conversions ------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        """numpy-style shape (outermost first)."""
        return tuple(reversed(self.dims))

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.dims)) * np.dtype(self.dtype).itemsize

    @classmethod
    def from_array(cls, arr, framerate: Optional[float] = None) -> "TensorSpec":
        return cls(dims=tuple(reversed(arr.shape)) or (1,),
                   dtype=str(np.asarray(arr).dtype), framerate=framerate)

    @classmethod
    def parse(cls, text: str, dtype: str = "float32",
              framerate: Optional[float] = None) -> "TensorSpec":
        """Parse gst-style "640:480:3" dimension strings."""
        dims = tuple(int(tok) for tok in text.split(":"))
        return cls(dims=dims, dtype=dtype, framerate=framerate)

    def __str__(self) -> str:
        fr = f",framerate={self.framerate}" if self.framerate else ""
        return f"other/tensor,dims={':'.join(map(str, self.dims))},type={self.dtype}{fr}"


@dataclasses.dataclass(frozen=True)
class TensorsSpec:
    """Caps of a bundled multi-tensor stream: ``other/tensors``."""

    tensors: Tuple[TensorSpec, ...]
    framerate: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "tensors", tuple(self.tensors))
        if not (1 <= len(self.tensors) <= MAX_TENSORS):
            raise ValueError(
                f"other/tensors bundles 1..{MAX_TENSORS} tensors, got {len(self.tensors)}")

    @property
    def num_tensors(self) -> int:
        return len(self.tensors)

    def compatible(self, other: "TensorsSpec") -> bool:
        if self.num_tensors != other.num_tensors:
            return False
        if (self.framerate is not None and other.framerate is not None
                and abs(self.framerate - other.framerate) > 1e-9):
            return False
        return all(a.compatible(b) for a, b in zip(self.tensors, other.tensors))

    def __str__(self) -> str:
        inner = ";".join(str(t) for t in self.tensors)
        return f"other/tensors,n={self.num_tensors}[{inner}]"


AnySpec = Any  # TensorSpec | TensorsSpec | MediaSpec


@dataclasses.dataclass(frozen=True)
class MediaSpec:
    """Conventional media caps (video/audio/text) — inputs to TensorConverter."""

    media: str                      # "video/x-raw", "audio/x-raw", "text/x-raw"
    format: str = "RGB"             # video: RGB/GRAY8; audio: S16LE/F32LE
    width: int = 0
    height: int = 0
    channels: int = 0
    rate: Optional[float] = None    # fps or sample rate

    def compatible(self, other: "MediaSpec") -> bool:
        return (self.media == other.media and self.format == other.format
                and self.width == other.width and self.height == other.height
                and self.channels == other.channels)


def specs_compatible(a: AnySpec, b: AnySpec) -> bool:
    """Run-time caps negotiation between two pads."""
    if a is None or b is None:  # ANY caps
        return True
    if isinstance(a, TensorSpec) and isinstance(b, TensorSpec):
        return a.compatible(b)
    if isinstance(a, TensorsSpec) and isinstance(b, TensorsSpec):
        return a.compatible(b)
    # promote single tensor <-> 1-element bundle
    if isinstance(a, TensorSpec) and isinstance(b, TensorsSpec) and b.num_tensors == 1:
        return a.compatible(b.tensors[0])
    if isinstance(a, TensorsSpec) and isinstance(b, TensorSpec) and a.num_tensors == 1:
        return a.tensors[0].compatible(b)
    if isinstance(a, MediaSpec) and isinstance(b, MediaSpec):
        return a.compatible(b)
    return False


class Buffer:
    """One frame: chunked arrays + pts + metadata.

    Each tensor lives in its own chunk so TensorMux/Demux are zero-copy
    (they only re-bundle the chunk tuple).
    """

    __slots__ = ("chunks", "pts", "meta", "eos")

    def __init__(self, chunks, pts: Optional[float] = None, meta=None, eos=False):
        if not isinstance(chunks, (tuple, list)):
            chunks = (chunks,)
        self.chunks: Tuple[Any, ...] = tuple(chunks)
        self.pts: float = time.monotonic() if pts is None else float(pts)
        self.meta: dict = dict(meta) if meta else {}
        self.eos: bool = bool(eos)

    @classmethod
    def eos_buffer(cls, pts: Optional[float] = None) -> "Buffer":
        return cls((), pts=pts, eos=True)

    @property
    def data(self):
        """The sole chunk (single-tensor streams)."""
        if len(self.chunks) != 1:
            raise ValueError(f"Buffer holds {len(self.chunks)} chunks, not 1")
        return self.chunks[0]

    def with_chunks(self, chunks) -> "Buffer":
        return Buffer(chunks, pts=self.pts, meta=self.meta)

    def spec(self) -> AnySpec:
        if len(self.chunks) == 1:
            return TensorSpec.from_array(np.asarray(self.chunks[0]))
        return TensorsSpec(tuple(TensorSpec.from_array(np.asarray(c))
                                 for c in self.chunks))

    def __repr__(self) -> str:
        if self.eos:
            return f"Buffer(EOS, pts={self.pts:.4f})"
        shapes = ",".join(str(tuple(np.asarray(c).shape)) for c in self.chunks)
        return f"Buffer([{shapes}], pts={self.pts:.4f})"
