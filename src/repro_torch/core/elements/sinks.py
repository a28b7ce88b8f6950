"""Sink elements: AppSink (pull queue), TensorSink (callback), FakeSink."""
from __future__ import annotations

import queue as _queue
import threading
from typing import Callable, List, Optional

from ..element import Element, Pad
from ..stream import Buffer


class AppSink(Element):
    """Buffers are pulled by the application: ``sink.pull(timeout)``."""

    def __init__(self, name: str, max_size: int = 0, drop: bool = False):
        super().__init__(name)
        self.add_sink_pad()
        self._q: _queue.Queue = _queue.Queue(maxsize=max_size)
        self.drop = drop
        self.n_received = 0
        self.eos_seen = threading.Event()

    def chain(self, pad: Pad, buf: Buffer) -> None:
        if buf.eos:
            self.eos_seen.set()
            self._q.put(buf)
            return
        self.n_received += 1
        if self.drop:
            try:
                self._q.put_nowait(buf)
            except _queue.Full:
                pass
        else:
            self._q.put(buf)

    def pull(self, timeout: Optional[float] = 5.0) -> Optional[Buffer]:
        try:
            return self._q.get(timeout=timeout)
        except _queue.Empty:
            return None


class TensorSink(Element):
    """Invoke a callback per buffer (NNStreamer tensor_sink new-data signal)."""

    def __init__(self, name: str, callback: Optional[Callable[[Buffer], None]] = None,
                 keep: bool = False):
        super().__init__(name)
        self.add_sink_pad()
        self.callback = callback
        self.keep = keep
        self.buffers: List[Buffer] = []
        self.n_received = 0
        self.eos_seen = threading.Event()

    def chain(self, pad: Pad, buf: Buffer) -> None:
        if buf.eos:
            self.eos_seen.set()
            return
        self.n_received += 1
        if self.keep:
            self.buffers.append(buf)
        if self.callback is not None:
            self.callback(buf)


class FakeSink(Element):
    """Discard everything (counts frames)."""

    def __init__(self, name: str):
        super().__init__(name)
        self.add_sink_pad()
        self.n_received = 0
        self.eos_seen = threading.Event()

    def chain(self, pad: Pad, buf: Buffer) -> None:
        if buf.eos:
            self.eos_seen.set()
            return
        self.n_received += 1
