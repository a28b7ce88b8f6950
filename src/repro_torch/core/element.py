"""Element/Pad graph primitives — the GStreamer skeleton of the framework.

Scheduling model (faithful to GStreamer's push model):
  * Sources run in their own thread (started by the Pipeline).
  * ``push`` on a source pad synchronously invokes the peer element's
    ``chain`` in the caller's thread — *unless* the peer is a Queue,
    which enqueues and lets its own worker thread continue downstream.
    Queues are therefore the thread (pipeline-parallelism) boundaries,
    exactly as in the paper's E1/E3 discussions.
  * Caps ("specs") are negotiated at link time and re-checked at the
    first buffer.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from .stream import AnySpec, Buffer, specs_compatible


class PadDirection:
    SRC = "src"
    SINK = "sink"


class Pad:
    def __init__(self, element: "Element", name: str, direction: str,
                 spec: Optional[AnySpec] = None):
        self.element = element
        self.name = name
        self.direction = direction
        self.spec = spec            # None = ANY
        self.peer: Optional["Pad"] = None

    # -- linking ----------------------------------------------------------
    def link(self, other: "Pad") -> None:
        if self.direction != PadDirection.SRC or other.direction != PadDirection.SINK:
            raise ValueError(f"can only link src->sink pads "
                             f"({self.qualname()} -> {other.qualname()})")
        if self.peer is not None or other.peer is not None:
            raise ValueError(f"pad already linked: {self.qualname()} or {other.qualname()}")
        if not specs_compatible(self.spec, other.spec):
            raise ValueError(
                f"caps negotiation failed: {self.qualname()}({self.spec}) !~ "
                f"{other.qualname()}({other.spec})")
        self.peer = other
        other.peer = self

    def qualname(self) -> str:
        return f"{self.element.name}.{self.name}"

    # -- dataflow ---------------------------------------------------------
    def push(self, buf: Buffer) -> None:
        """Push a buffer downstream (src pads only)."""
        if self.peer is None:
            return  # unlinked src pad: drop (like gst fakesink-less leaf)
        self.peer.element.chain(self.peer, buf)


class Element:
    """Base pipeline element."""

    def __init__(self, name: str):
        self.name = name
        self.sinkpads: Dict[str, Pad] = {}
        self.srcpads: Dict[str, Pad] = {}
        self.pipeline = None          # set by Pipeline.add
        self._lock = threading.Lock()

    # -- pad management ---------------------------------------------------
    def add_sink_pad(self, name: str = "sink", spec: Optional[AnySpec] = None) -> Pad:
        pad = Pad(self, name, PadDirection.SINK, spec)
        self.sinkpads[name] = pad
        return pad

    def add_src_pad(self, name: str = "src", spec: Optional[AnySpec] = None) -> Pad:
        pad = Pad(self, name, PadDirection.SRC, spec)
        self.srcpads[name] = pad
        return pad

    @property
    def sinkpad(self) -> Pad:
        if len(self.sinkpads) != 1:
            raise ValueError(f"{self.name} has {len(self.sinkpads)} sink pads")
        return next(iter(self.sinkpads.values()))

    @property
    def srcpad(self) -> Pad:
        if len(self.srcpads) != 1:
            raise ValueError(f"{self.name} has {len(self.srcpads)} src pads")
        return next(iter(self.srcpads.values()))

    def link(self, downstream: "Element", srcpad: Optional[str] = None,
             sinkpad: Optional[str] = None) -> "Element":
        src = self.srcpads[srcpad] if srcpad else self.srcpad
        # auto-pick first unlinked sink pad
        if sinkpad:
            snk = downstream.sinkpads[sinkpad]
        else:
            free = [p for p in downstream.sinkpads.values() if p.peer is None]
            if not free:
                snk = downstream.request_sink_pad()
            else:
                snk = free[0]
        src.link(snk)
        return downstream

    def request_sink_pad(self) -> Pad:
        """Elements with request pads (mux, merge) override this."""
        raise ValueError(f"{self.name}: no free sink pad and no request pads")

    def request_src_pad(self) -> Pad:
        raise ValueError(f"{self.name}: no request src pads")

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Transition READY->PLAYING (allocate threads/state)."""

    def stop(self) -> None:
        """Transition PLAYING->NULL (join threads, free state)."""

    # -- dataflow ----------------------------------------------------------
    def chain(self, pad: Pad, buf: Buffer) -> None:
        """Receive a buffer on a sink pad.  Default: transform + push."""
        if buf.eos:
            self.handle_eos(pad, buf)
            return
        out = self.transform(pad, buf)
        if out is not None:
            self.srcpad.push(out)

    def transform(self, pad: Pad, buf: Buffer) -> Optional[Buffer]:
        raise NotImplementedError(f"{type(self).__name__}.transform")

    def handle_eos(self, pad: Pad, buf: Buffer) -> None:
        """Default EOS: forward on all src pads."""
        for p in self.srcpads.values():
            p.push(buf)

    def post_error(self, exc: BaseException) -> None:
        if self.pipeline is not None:
            self.pipeline.post_error(self.name, exc)
        else:
            raise exc

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"
