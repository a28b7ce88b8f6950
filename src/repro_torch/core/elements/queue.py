"""Queue — the thread boundary that creates pipeline parallelism.

Matches GStreamer queue semantics that matter for the paper's results:
a queue decouples the upstream thread from downstream processing, so
stages before and after it execute concurrently (pipeline parallelism,
E1/E3).  Supports bounded capacity with either blocking or leaky
behaviour (``leaky=downstream`` drops the newest, ``leaky=upstream``
drops the oldest — used for QoS like the paper's live pipelines).

``workers`` > 1 runs multiple downstream worker threads pulling from
the same queue, so a *blocking* downstream stage (e.g. a tensor_filter
mounted on ``ServeEngine.as_pipeline_filter``, which parks until its
whole micro-batch finishes) can process several buffers concurrently.
Ordering across workers is not preserved — downstream must route by
metadata, as the tensor-query elements do.  EOS is forwarded exactly
once, after every in-flight buffer has fully drained downstream.
"""
from __future__ import annotations

import queue as _queue
import threading
from typing import Optional

from ..element import Element, Pad
from ..stream import Buffer


class Queue(Element):
    def __init__(self, name: str, max_size: int = 16, leaky: str = "no",
                 workers: int = 1):
        super().__init__(name)
        if leaky not in ("no", "upstream", "downstream"):
            raise ValueError(f"leaky must be no|upstream|downstream, got {leaky!r}")
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.max_size = int(max_size)
        self.leaky = leaky
        self.num_workers = int(workers)
        self.add_sink_pad()
        self.add_src_pad()
        self._q: _queue.Queue = _queue.Queue(maxsize=self.max_size)
        self._workers: list = []
        self._running = False
        self.n_dropped = 0
        # buffers enqueued but not yet fully pushed downstream; EOS waits
        # until this hits zero so it can never overtake an in-flight buffer
        self._outstanding = 0
        self._drain_cv = threading.Condition()

    # -- upstream side ------------------------------------------------------
    def chain(self, pad: Pad, buf: Buffer) -> None:
        if not self._running:
            return
        if buf.eos:
            self._q.put(buf)  # EOS always enqueues (blocks if full)
            return
        if self.leaky == "downstream":
            try:
                self._track(buf)
                self._q.put_nowait(buf)
            except _queue.Full:
                self._untrack()
                self.n_dropped += 1  # drop newest
        elif self.leaky == "upstream":
            self._track(buf)
            while True:
                try:
                    self._q.put_nowait(buf)
                    return
                except _queue.Full:
                    try:
                        self._q.get_nowait()  # drop oldest
                        self._untrack()
                        self.n_dropped += 1
                    except _queue.Empty:
                        pass
        else:
            self._track(buf)
            self._q.put(buf)  # block upstream (backpressure)

    def _track(self, buf: Buffer) -> None:
        with self._drain_cv:
            self._outstanding += 1

    def _untrack(self) -> None:
        with self._drain_cv:
            self._outstanding -= 1
            self._drain_cv.notify_all()

    # -- downstream side ------------------------------------------------------
    def _run(self) -> None:
        while self._running:
            try:
                buf = self._q.get(timeout=0.1)
            except _queue.Empty:
                continue
            if buf.eos:
                # exactly-once EOS: wait for every in-flight buffer (other
                # workers may still be blocked downstream), then forward
                with self._drain_cv:
                    while self._outstanding > 0 and self._running:
                        self._drain_cv.wait(timeout=0.1)
                try:
                    self.srcpad.push(buf)
                except BaseException as exc:  # noqa: BLE001 - bus-reported
                    self.post_error(exc)
                return
            try:
                self.srcpad.push(buf)
            except BaseException as exc:  # noqa: BLE001 - bus-reported
                self._untrack()
                self.post_error(exc)
                return
            self._untrack()

    def start(self) -> None:
        self._running = True
        self._workers = [
            threading.Thread(target=self._run,
                             name=f"queue:{self.name}:{i}", daemon=True)
            for i in range(self.num_workers)]
        for w in self._workers:
            w.start()

    def stop(self) -> None:
        self._running = False
        for w in self._workers:
            w.join(timeout=2.0)
        self._workers = []
        # drain
        while True:
            try:
                self._q.get_nowait()
            except _queue.Empty:
                break
