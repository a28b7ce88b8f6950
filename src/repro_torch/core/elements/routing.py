"""Stream-path control elements.

  * Tee            — duplicate a stream to N branches (functional parallelism)
  * TensorMux      — bundle N ``other/tensor`` streams -> one ``other/tensors``
  * TensorDemux    — unbundle ``other/tensors`` -> N ``other/tensor``
  * TensorMerge    — combine N tensors into ONE tensor (concat / stack)
  * TensorSplit    — slice one tensor into N tensors along an axis
  * InputSelector / OutputSelector / Valve — dynamic flow control

Mux/Demux are zero-copy: they only re-bundle the chunk tuple.  Merge and
Split follow the paper's dimension algebra: from two 3x4 streams, Merge
creates 6x4 (concat dim0), 3x8 (concat dim1) or 3x4x2 (stack); Mux
creates {3x4, 3x4}.  NB dims are gst innermost-first; numpy shapes are
reversed, which these elements handle internally.
"""
from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np

from ..element import Element, Pad
from ..stream import Buffer
from ..sync import SyncCollector, SyncPolicy, stamp_latest


class Tee(Element):
    def __init__(self, name: str, num_src_pads: int = 0):
        super().__init__(name)
        self.add_sink_pad()
        for i in range(num_src_pads):
            self.add_src_pad(f"src_{i}")

    def request_src_pad(self) -> Pad:
        return self.add_src_pad(f"src_{len(self.srcpads)}")

    def link(self, downstream, srcpad=None, sinkpad=None):
        if srcpad is None:
            free = [p for p in self.srcpads.values() if p.peer is None]
            src = free[0] if free else self.request_src_pad()
            srcpad = src.name
        return super().link(downstream, srcpad=srcpad, sinkpad=sinkpad)

    def chain(self, pad: Pad, buf: Buffer) -> None:
        for p in self.srcpads.values():
            p.push(buf)


class _SyncedNToOne(Element):
    """Shared machinery for Mux and Merge (sync policies + EOS)."""

    def __init__(self, name: str, num_sinks: int, sync: str = "slowest"):
        super().__init__(name)
        policy, base = SyncPolicy.parse(sync)
        for i in range(num_sinks):
            self.add_sink_pad(f"sink_{i}")
        self.add_src_pad()
        self._indices = {f"sink_{i}": i for i in range(num_sinks)}
        self.collector = SyncCollector(num_sinks, policy=policy, base_index=base)
        self._eos_sent = False
        self._eos_lock = threading.Lock()

    def request_sink_pad(self) -> Pad:
        raise ValueError(f"{self.name}: fixed sink pads; set num_sinks at creation")

    def combine(self, bufs: List[Buffer]) -> Buffer:
        raise NotImplementedError

    def chain(self, pad: Pad, buf: Buffer) -> None:
        idx = self._indices[pad.name]
        if buf.eos:
            self.collector.offer(idx, buf)
            self._maybe_eos()
            return
        ready = self.collector.offer(idx, buf)
        if ready is not None:
            out = self.combine(ready)
            self.srcpad.push(out)
        # a collection may have drained the queue of an already-ended pad
        self._maybe_eos()

    def _maybe_eos(self) -> None:
        """Forward EOS as soon as no further output is possible — e.g.
        the base pad ended under ``base:<idx>`` sync, even if other
        pads are still live."""
        with self._eos_lock:
            if self._eos_sent:
                return
            if self.collector.all_eos() or self.collector.exhausted():
                self._eos_sent = True
                self.srcpad.push(Buffer.eos_buffer())


class TensorMux(_SyncedNToOne):
    """N x other/tensor -> other/tensors (zero-copy bundle)."""

    def combine(self, bufs: List[Buffer]) -> Buffer:
        chunks = tuple(c for b in bufs for c in b.chunks)
        meta: dict = {}
        for b in bufs:
            meta.update(b.meta)
        return Buffer(chunks, pts=stamp_latest(bufs), meta=meta)


class TensorDemux(Element):
    """other/tensors -> N x other/tensor (zero-copy unbundle).

    ``tensorpick`` optionally selects a subset, mirroring NNStreamer.
    """

    def __init__(self, name: str, num_src_pads: int, tensorpick: Optional[List[int]] = None):
        super().__init__(name)
        self.add_sink_pad()
        for i in range(num_src_pads):
            self.add_src_pad(f"src_{i}")
        self.tensorpick = tensorpick

    def chain(self, pad: Pad, buf: Buffer) -> None:
        if buf.eos:
            self.handle_eos(pad, buf)
            return
        picks = self.tensorpick or range(len(buf.chunks))
        for out_idx, chunk_idx in enumerate(picks):
            p = self.srcpads.get(f"src_{out_idx}")
            if p is None:
                break
            p.push(Buffer((buf.chunks[chunk_idx],), pts=buf.pts, meta=buf.meta))


class TensorMerge(_SyncedNToOne):
    """N tensors -> ONE tensor.  mode: concat:<gst_dim> | stack."""

    def __init__(self, name: str, num_sinks: int, mode: str = "concat:0",
                 sync: str = "slowest"):
        super().__init__(name, num_sinks, sync=sync)
        if mode == "stack":
            self.mode, self.gst_dim = "stack", None
        elif mode.startswith("concat"):
            self.mode = "concat"
            self.gst_dim = int(mode.split(":", 1)[1]) if ":" in mode else 0
        else:
            raise ValueError(f"unknown merge mode {mode!r}")

    def combine(self, bufs: List[Buffer]) -> Buffer:
        arrays = [np.asarray(b.data) for b in bufs]
        if self.mode == "stack":
            out = np.stack(arrays, axis=-1)  # new innermost-last np == gst new dim
        else:
            rank = arrays[0].ndim
            np_axis = rank - 1 - self.gst_dim  # gst dims are innermost-first
            out = np.concatenate(arrays, axis=np_axis)
        return Buffer(out, pts=stamp_latest(bufs))


class TensorSplit(Element):
    """ONE tensor -> N tensors, slicing along gst dim with given sizes."""

    def __init__(self, name: str, tensorseg: List[int], gst_dim: int = 0):
        super().__init__(name)
        self.add_sink_pad()
        self.tensorseg = list(tensorseg)
        self.gst_dim = gst_dim
        for i in range(len(tensorseg)):
            self.add_src_pad(f"src_{i}")

    def chain(self, pad: Pad, buf: Buffer) -> None:
        if buf.eos:
            self.handle_eos(pad, buf)
            return
        arr = np.asarray(buf.data)
        np_axis = arr.ndim - 1 - self.gst_dim
        offs = 0
        for i, seg in enumerate(self.tensorseg):
            sl = [slice(None)] * arr.ndim
            sl[np_axis] = slice(offs, offs + seg)
            self.srcpads[f"src_{i}"].push(
                Buffer(arr[tuple(sl)], pts=buf.pts, meta=buf.meta))
            offs += seg


class InputSelector(Element):
    """N sink pads, forward only the active one."""

    def __init__(self, name: str, num_sinks: int, active: int = 0):
        super().__init__(name)
        for i in range(num_sinks):
            self.add_sink_pad(f"sink_{i}")
        self.add_src_pad()
        self.active = active
        self._eos = [False] * num_sinks

    def chain(self, pad: Pad, buf: Buffer) -> None:
        idx = int(pad.name.split("_")[1])
        if buf.eos:
            self._eos[idx] = True
            if all(self._eos):
                self.srcpad.push(buf)
            return
        if idx == self.active:
            self.srcpad.push(buf)


class OutputSelector(Element):
    """One sink pad, forward to the active src pad only."""

    def __init__(self, name: str, num_srcs: int, active: int = 0):
        super().__init__(name)
        self.add_sink_pad()
        for i in range(num_srcs):
            self.add_src_pad(f"src_{i}")
        self.active = active

    def chain(self, pad: Pad, buf: Buffer) -> None:
        if buf.eos:
            self.handle_eos(pad, buf)
            return
        self.srcpads[f"src_{self.active}"].push(buf)


class Valve(Element):
    """drop=True discards buffers (dynamic flow control)."""

    def __init__(self, name: str, drop: bool = False):
        super().__init__(name)
        self.add_sink_pad()
        self.add_src_pad()
        self.drop = drop

    def chain(self, pad: Pad, buf: Buffer) -> None:
        if buf.eos or not self.drop:
            self.srcpad.push(buf)
