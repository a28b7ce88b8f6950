"""TensorBatcher / TensorUnbatcher — adaptive micro-batching elements.

``TensorBatcher`` accumulates stream frames and emits one *batched*
buffer whose chunks gained a new leading batch axis.  A batch closes
when either cap is hit (NNStreamer-style "whichever first" semantics):

  * ``max_batch``    — the batch is full, or
  * ``max_wait_ms``  — the oldest queued frame has waited this long
                       (rate-adaptive: light traffic still gets bounded
                       latency, heavy traffic gets full batches).

Per-frame ``pts`` and ``meta`` are preserved in the batch metadata under
``meta["batch"]`` so a downstream ``TensorUnbatcher`` can reconstruct
the original per-frame buffers exactly.  EOS flushes any partial batch
before being forwarded, so no frame is ever lost at stream end.

The unbatch side is zero-copy: splitting along the leading axis yields
numpy views into the batched chunk, never copies.
"""
from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np

from ..element import Element, Pad
from ..stream import Buffer

BATCH_META_KEY = "batch"


class TensorBatcher(Element):
    def __init__(self, name: str, max_batch: int = 8,
                 max_wait_ms: Optional[float] = None):
        super().__init__(name)
        self.add_sink_pad()
        self.add_src_pad()
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = int(max_batch)
        self.max_wait_s = None if max_wait_ms is None else float(max_wait_ms) / 1e3
        # serializes batch close + downstream push across the upstream
        # thread and the timeout thread, so batches leave in order, never
        # after EOS, and downstream elements see no concurrency from here
        self._flush_lock = threading.RLock()
        self._pending: List[Buffer] = []
        self._deadline: Optional[float] = None   # monotonic flush deadline
        self._timer: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._running = False
        self.n_batches = 0
        self.n_timeout_flushes = 0
        self.n_eos_flushes = 0

    # -- accumulation -------------------------------------------------------
    def chain(self, pad: Pad, buf: Buffer) -> None:
        if buf.eos:
            with self._flush_lock:
                with self._lock:
                    out = self._close_batch() if self._pending else None
                    if out is not None:
                        self.n_eos_flushes += 1
                if out is not None:
                    self.srcpad.push(out)
                self.handle_eos(pad, buf)
            return
        with self._flush_lock:
            with self._lock:
                if self._pending and len(buf.chunks) != len(self._pending[0].chunks):
                    raise ValueError(
                        f"{self.name}: frame chunk arity changed mid-batch "
                        f"({len(self._pending[0].chunks)} -> {len(buf.chunks)})")
                self._pending.append(buf)
                if len(self._pending) == 1 and self.max_wait_s is not None:
                    import time
                    self._deadline = time.monotonic() + self.max_wait_s
                    self._wake.set()
                out = (self._close_batch()
                       if len(self._pending) >= self.max_batch else None)
            if out is not None:
                self.srcpad.push(out)

    def _close_batch(self) -> Optional[Buffer]:
        """Stack pending frames; caller must hold self._lock."""
        if not self._pending:
            return None
        frames, self._pending = self._pending, []
        self._deadline = None
        n_chunks = len(frames[0].chunks)
        stacked = tuple(
            np.stack([np.asarray(f.chunks[i]) for f in frames], axis=0)
            for i in range(n_chunks))
        meta = {BATCH_META_KEY: {
            "size": len(frames),
            "pts": [f.pts for f in frames],
            "meta": [dict(f.meta) for f in frames],
        }}
        self.n_batches += 1
        # batch pts = latest input, like every merging element (paper §III)
        return Buffer(stacked, pts=max(f.pts for f in frames), meta=meta)

    # -- timeout flush ------------------------------------------------------
    def _watch(self) -> None:
        import time
        while self._running:
            with self._lock:
                deadline = self._deadline
            if deadline is None:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            delay = deadline - time.monotonic()
            if delay > 0:
                self._wake.wait(timeout=delay)
                self._wake.clear()
                continue
            with self._flush_lock:
                with self._lock:
                    # re-check under lock: chain() may have just flushed
                    out = None
                    if (self._deadline is not None
                            and time.monotonic() >= self._deadline):
                        out = self._close_batch()
                        if out is not None:
                            self.n_timeout_flushes += 1
                if out is not None:
                    try:
                        self.srcpad.push(out)
                    except BaseException as exc:  # noqa: BLE001 - bus-reported
                        self.post_error(exc)
                        return

    def start(self) -> None:
        if self.max_wait_s is None:
            return
        self._running = True
        self._timer = threading.Thread(target=self._watch,
                                       name=f"batcher:{self.name}", daemon=True)
        self._timer.start()

    def stop(self) -> None:
        self._running = False
        self._wake.set()
        if self._timer is not None:
            self._timer.join(timeout=2.0)
            self._timer = None
        with self._lock:
            self._pending.clear()
            self._deadline = None


class TensorUnbatcher(Element):
    """Split a batched buffer back into per-frame buffers (zero-copy).

    With ``meta["batch"]`` present (produced by TensorBatcher), original
    per-frame ``pts``/``meta`` are restored.  Otherwise the leading axis
    is treated as the batch axis and frames inherit the batch pts/meta.
    """

    def __init__(self, name: str):
        super().__init__(name)
        self.add_sink_pad()
        self.add_src_pad()
        self.n_frames = 0

    def chain(self, pad: Pad, buf: Buffer) -> None:
        if buf.eos:
            self.handle_eos(pad, buf)
            return
        info = buf.meta.get(BATCH_META_KEY)
        chunks = [np.asarray(c) for c in buf.chunks]
        if info is not None:
            n = int(info["size"])
            pts_list, meta_list = info["pts"], info["meta"]
        else:
            n = chunks[0].shape[0]
            pts_list = [buf.pts] * n
            meta_list = [buf.meta] * n
        for j in range(n):
            # chunk[j] is a view into the batched array — no copy
            self.srcpad.push(Buffer(tuple(c[j] for c in chunks),
                                    pts=pts_list[j], meta=meta_list[j]))
            self.n_frames += 1
