"""Synchronization policies for TensorMux / TensorMerge (paper §III).

  * ``slowest`` — emit at the rate of the slowest source; faster sources
    drop stale frames (keep the one closest to the chosen timestamp).
  * ``fastest`` — emit at the rate of the fastest source; slower sources
    duplicate their most recent frame.
  * ``base(i)`` — lock the output rate to designated source *i*.

All merging elements stamp the output with the *latest* input timestamp,
as the paper specifies.
"""
from __future__ import annotations

import collections
import threading
from typing import Deque, List, Optional

from .stream import Buffer


class SyncPolicy:
    SLOWEST = "slowest"
    FASTEST = "fastest"
    BASE = "base"

    @classmethod
    def parse(cls, text: str):
        """Parse "slowest" | "fastest" | "base:<idx>"."""
        if text.startswith(cls.BASE):
            idx = int(text.split(":", 1)[1]) if ":" in text else 0
            return cls.BASE, idx
        if text in (cls.SLOWEST, cls.FASTEST):
            return text, 0
        raise ValueError(f"unknown sync policy {text!r}")


class SyncCollector:
    """Aligns N input streams into synchronized frame sets.

    Thread-safe: mux inputs arrive from different upstream threads.
    ``offer`` returns a list of per-pad buffers when a synchronized set
    is ready, else None.
    """

    def __init__(self, num_pads: int, policy: str = SyncPolicy.SLOWEST,
                 base_index: int = 0, max_queue: int = 32):
        self.num_pads = num_pads
        self.policy = policy
        self.base_index = base_index
        self.queues: List[Deque[Buffer]] = [collections.deque() for _ in range(num_pads)]
        self.latest: List[Optional[Buffer]] = [None] * num_pads
        self.max_queue = max_queue
        self.lock = threading.Lock()
        self.eos = [False] * num_pads

    def offer(self, index: int, buf: Buffer) -> Optional[List[Buffer]]:
        with self.lock:
            if buf.eos:
                self.eos[index] = True
                return None
            self.latest[index] = buf
            self.queues[index].append(buf)
            if len(self.queues[index]) > self.max_queue:
                self.queues[index].popleft()  # leaky: drop oldest
            return self._try_collect()

    def all_eos(self) -> bool:
        with self.lock:
            return all(self.eos)

    def exhausted(self) -> bool:
        """True when no future ``offer`` can ever complete a frame set,
        so the owning element may forward EOS early.

          * BASE    — the base pad ended and its queue drained; other
                      pads alone can never trigger an emission.
          * SLOWEST — any pad ended with an empty queue (every set needs
                      one frame from every pad).
          * FASTEST — a pad that ended without ever producing can never
                      supply a latest frame to duplicate; otherwise only
                      when every pad ended.
        """
        with self.lock:
            if self.policy == SyncPolicy.BASE:
                return (self.eos[self.base_index]
                        and not self.queues[self.base_index])
            if self.policy == SyncPolicy.SLOWEST:
                return any(e and not q for e, q in zip(self.eos, self.queues))
            return all(self.eos) or any(
                e and latest is None
                for e, latest in zip(self.eos, self.latest))

    # -- policy engines ----------------------------------------------------
    def _try_collect(self) -> Optional[List[Buffer]]:
        if self.policy == SyncPolicy.SLOWEST:
            return self._collect_slowest()
        if self.policy == SyncPolicy.FASTEST:
            return self._collect_fastest()
        return self._collect_base()

    def _collect_slowest(self) -> Optional[List[Buffer]]:
        # need at least one frame on every pad; pick target = min of heads'
        # newest available, drop frames older than target on faster pads
        if any(not q for q in self.queues):
            return None
        target = max(q[0].pts for q in self.queues)  # slowest source's head
        out: List[Buffer] = []
        for q in self.queues:
            # drop frames clearly older than target (faster sources)
            while len(q) > 1 and abs(q[1].pts - target) <= abs(q[0].pts - target):
                q.popleft()
            out.append(q.popleft())
        return out

    def _collect_fastest(self) -> Optional[List[Buffer]]:
        # fire whenever any pad has a fresh frame, provided all pads have
        # seen at least one frame; slower pads duplicate their latest
        if any(b is None for b in self.latest):
            return None
        out: List[Buffer] = []
        for q, latest in zip(self.queues, self.latest):
            out.append(q.popleft() if q else latest)
        return out

    def _collect_base(self) -> Optional[List[Buffer]]:
        # fire only when the base pad has a frame; others use nearest/latest
        base_q = self.queues[self.base_index]
        if not base_q or any(b is None for b in self.latest):
            return None
        base = base_q.popleft()
        out: List[Buffer] = []
        for i, (q, latest) in enumerate(zip(self.queues, self.latest)):
            if i == self.base_index:
                out.append(base)
                continue
            # choose queued frame with pts closest to base, else latest
            best = latest
            while q:
                cand = q[0]
                if len(q) > 1 and abs(q[1].pts - base.pts) <= abs(cand.pts - base.pts):
                    q.popleft()
                    continue
                best = cand
                q.popleft()
                break
            out.append(best)
        return out


def stamp_latest(buffers: List[Buffer]) -> float:
    """Merging filters choose the latest timestamp (paper §III)."""
    return max(b.pts for b in buffers)
