"""Pipeline — element container, state machine, and message bus.

States follow GStreamer: NULL -> READY -> PLAYING -> NULL.  ``start``
launches queue workers first (downstream threads must be live before
sources push), then sources.  The bus collects errors posted by elements
running in any thread; ``run_until_eos`` re-raises them.
"""
from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Dict, List, Optional

from .element import Element
from .elements.queue import Queue
from .elements.sources import SourceElement


class PipelineError(RuntimeError):
    pass


class Pipeline:
    NULL, READY, PLAYING = "NULL", "READY", "PLAYING"

    def __init__(self, name: str = "pipeline"):
        self.name = name
        self.elements: Dict[str, Element] = {}
        self.state = self.NULL
        self.bus: _queue.Queue = _queue.Queue()

    # -- construction -------------------------------------------------------
    def add(self, *elements: Element) -> "Pipeline":
        for el in elements:
            if el.name in self.elements:
                raise ValueError(f"duplicate element name {el.name!r}")
            self.elements[el.name] = el
            el.pipeline = self
        return self

    def __getitem__(self, name: str) -> Element:
        return self.elements[name]

    def link(self, *names: str) -> "Pipeline":
        """Link a chain of elements by name."""
        for up, down in zip(names, names[1:]):
            self.elements[up].link(self.elements[down])
        return self

    # -- bus ------------------------------------------------------------------
    def post_error(self, element_name: str, exc: BaseException) -> None:
        self.bus.put(("error", element_name, exc))

    def check_bus(self) -> None:
        try:
            kind, el, exc = self.bus.get_nowait()
        except _queue.Empty:
            return
        raise PipelineError(f"element {el!r} failed: {exc!r}") from exc

    # -- state ------------------------------------------------------------------
    def start(self) -> "Pipeline":
        if self.state == self.PLAYING:
            return self
        # non-source elements first (queues spawn workers), sources last
        for el in self.elements.values():
            if not isinstance(el, SourceElement):
                el.start()
        for el in self.elements.values():
            if isinstance(el, SourceElement):
                el.start()
        self.state = self.PLAYING
        return self

    def stop(self) -> "Pipeline":
        for el in self.elements.values():
            if isinstance(el, SourceElement):
                el.stop()
        for el in self.elements.values():
            if not isinstance(el, SourceElement):
                el.stop()
        self.state = self.NULL
        return self

    # -- execution helpers -------------------------------------------------------
    def sinks(self) -> List[Element]:
        return [el for el in self.elements.values()
                if el.srcpads == {} and hasattr(el, "eos_seen")]

    def run_until_eos(self, timeout: float = 60.0) -> "Pipeline":
        """start(), wait for EOS on every sink (or error), stop()."""
        self.start()
        deadline = time.monotonic() + timeout
        try:
            sinks = self.sinks()
            if not sinks:
                raise PipelineError("pipeline has no sinks with EOS tracking")
            for sink in sinks:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not sink.eos_seen.wait(timeout=max(remaining, 0.01)):
                    self.check_bus()
                    raise PipelineError(
                        f"timeout waiting for EOS on {sink.name!r} "
                        f"(received so far: {getattr(sink, 'n_received', '?')})")
                self.check_bus()
        finally:
            self.stop()
        self.check_bus()
        return self
