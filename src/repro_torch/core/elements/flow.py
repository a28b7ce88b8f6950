"""Value-based flow control and recurrence.

``TensorIf`` routes buffers by a predicate over tensor *values* without
application-thread intervention (paper §III).  Compound conditions over
reductions of the tensor are supported.

``TensorRepoSink`` / ``TensorRepoSrc`` share a named repository slot,
constructing a recurring data path *without* a stream cycle (GStreamer
prohibits graph cycles; the paper's E4 discussion explains why).  The
repo is a 1-deep mailbox per name: sink overwrites, src reads
most-recent (or a seed value before the first write).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import numpy as np

from ..element import Element, Pad
from ..stream import Buffer


class TensorIf(Element):
    """Route to src_true / src_false by a predicate on the tensor.

    Built-in compare ops on a reduction of the tensor:
      reduction: "mean" | "max" | "min" | "sum" | "elem:<i>"
      compare:   "gt" | "ge" | "lt" | "le" | "eq" | "ne"
    or pass ``predicate=callable(Buffer)->bool``.
    behavior for the false branch: "route" (to src_false) or "drop".
    """

    def __init__(self, name: str, reduction: str = "mean", compare: str = "gt",
                 value: float = 0.0, behavior: str = "route",
                 predicate: Optional[Callable[[Buffer], bool]] = None):
        super().__init__(name)
        self.add_sink_pad()
        self.add_src_pad("src_true")
        if behavior == "route":
            self.add_src_pad("src_false")
        self.reduction = reduction
        self.compare = compare
        self.value = value
        self.behavior = behavior
        self.predicate = predicate

    def _reduce(self, arr: np.ndarray) -> float:
        r = self.reduction
        if r == "mean":
            return float(arr.mean())
        if r == "max":
            return float(arr.max())
        if r == "min":
            return float(arr.min())
        if r == "sum":
            return float(arr.sum())
        if r.startswith("elem:"):
            return float(arr.reshape(-1)[int(r.split(":")[1])])
        raise ValueError(f"unknown reduction {r!r}")

    def _test(self, buf: Buffer) -> bool:
        if self.predicate is not None:
            return bool(self.predicate(buf))
        x = self._reduce(np.asarray(buf.data))
        v = self.value
        return {"gt": x > v, "ge": x >= v, "lt": x < v,
                "le": x <= v, "eq": x == v, "ne": x != v}[self.compare]

    def chain(self, pad: Pad, buf: Buffer) -> None:
        if buf.eos:
            self.handle_eos(pad, buf)
            return
        if self._test(buf):
            self.srcpads["src_true"].push(buf)
        elif self.behavior == "route":
            self.srcpads["src_false"].push(buf)
        # behavior == "drop": discard


class TensorRepo:
    """Process-wide named repository (mailbox per slot)."""

    _slots: Dict[str, "._Slot"] = {}
    _lock = threading.Lock()

    class _Slot:
        def __init__(self):
            self.lock = threading.Lock()
            self.value: Optional[Buffer] = None

    @classmethod
    def slot(cls, name: str) -> "_Slot":
        with cls._lock:
            if name not in cls._slots:
                cls._slots[name] = cls._Slot()
            return cls._slots[name]

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._slots.clear()


class TensorRepoSink(Element):
    """Write buffers into a named repo slot (terminates a branch)."""

    def __init__(self, name: str, slot: str):
        super().__init__(name)
        self.add_sink_pad()
        self._slot = TensorRepo.slot(slot)
        self.eos_seen = threading.Event()

    def chain(self, pad: Pad, buf: Buffer) -> None:
        if buf.eos:
            self.eos_seen.set()
            return
        with self._slot.lock:
            self._slot.value = buf


class TensorRepoSrc(Element):
    """On each input ("tick") emit {input, latest repo value}.

    NNStreamer's tensor_reposrc is a pure source; for deterministic tests
    we implement the common recurrent pattern: it has a sink pad (the
    driving stream) and bundles the repo value with each driving frame,
    seeding with zeros of ``seed_shape`` before the first write.
    """

    def __init__(self, name: str, slot: str, seed_shape=None, seed_dtype="float32"):
        super().__init__(name)
        self.add_sink_pad()
        self.add_src_pad()
        self._slot = TensorRepo.slot(slot)
        self.seed_shape = tuple(seed_shape) if seed_shape else None
        self.seed_dtype = seed_dtype

    def transform(self, pad: Pad, buf: Buffer) -> Optional[Buffer]:
        with self._slot.lock:
            latest = self._slot.value
        if latest is None:
            if self.seed_shape is None:
                raise ValueError(f"{self.name}: repo empty and no seed_shape")
            state = np.zeros(self.seed_shape, dtype=self.seed_dtype)
        else:
            state = latest.chunks[0]
        return Buffer(tuple(buf.chunks) + (state,), pts=buf.pts, meta=buf.meta)
