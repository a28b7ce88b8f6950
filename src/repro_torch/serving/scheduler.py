"""Priority-aware request scheduler for the serving engine.

``ServeEngine``'s original queue was a single FIFO deque with
head-of-line admission: a queued request whose worst-case block
reservation did not fit blocked every smaller request behind it, and
all requests were equal — a latency-sensitive probe waited behind a
bulk batch job.  This module replaces it with a small two-lane
scheduler:

  * **lanes** — ``interactive`` and ``batch``.  Candidates are offered
    to the engine interactive-first, FIFO within a lane, so a short
    interactive request admits ahead of any amount of queued batch
    work.
  * **size-aware admission** — the scheduler yields *all* queued
    requests in priority order; the engine admits any candidate whose
    block + state-slab reservation fits and simply skips past the ones
    that do not, so a too-large request can never starve a smaller one
    behind it (the head-of-line fix).
  * **deadlines** — a request may carry an absolute TTFT deadline
    (monotonic seconds).  ``expire`` pops queued requests whose
    deadline has passed before they started; the engine fails them
    with status ``"expired"`` instead of burning pool space on output
    nobody is waiting for.
  * **preemption support** — a preempted request re-enters *the front*
    of its lane (``push(front=True)``) carrying its generated tokens,
    page digests, and the host-side spill of its KV pages / state slab
    so the engine can re-admit it bit-identically.

The scheduler is plain host-side bookkeeping: no thread owns it, the
engine guards it with its submission lock.
"""
from __future__ import annotations

import dataclasses
import collections
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

LANES = ("interactive", "batch")

__all__ = ["LANES", "SchedRequest", "Scheduler"]


@dataclasses.dataclass(eq=False)     # identity semantics: queue membership
class SchedRequest:
    """One queued generation request (or a preempted one re-queued).

    ``deadline`` is absolute ``time.monotonic()`` seconds (None = no
    deadline) and bounds *time to first token*: a request that has not
    been admitted by its deadline is expired, one that has started is
    allowed to finish.  The restore fields are empty for fresh
    requests; a preempted request carries everything needed to rebuild
    its slot exactly: the tokens generated so far, the number of cache
    positions it had filled, its per-page chain digests, and the spill
    payload (host copy of its KV pages + recurrent state slab).
    """
    rid: int
    prompt: np.ndarray
    lane: str = "interactive"
    deadline: Optional[float] = None
    tag: Any = None
    t_submit: float = 0.0
    # -- preemption restore state --
    tokens: List[int] = dataclasses.field(default_factory=list)
    length: int = 0                  # cache positions filled at spill time
    digests: List[bytes] = dataclasses.field(default_factory=list)
    spill: Any = None                # host pytree of page/slab data
    # speculative-decode restore state: {"rounds", "deficit", "prev"}
    # (None when the engine is not speculative or the request is fresh)
    spec: Any = None
    # -- memoized prefix match (valid while allocator.epoch unchanged) --
    match: Optional[Tuple[List[int], List[bytes], int]] = None
    match_epoch: int = -1

    @property
    def preempted(self) -> bool:
        return self.spill is not None or self.length > 0


class Scheduler:
    """Two-lane priority queue over ``SchedRequest``s."""

    def __init__(self, lanes: Tuple[str, ...] = LANES):
        if not lanes:
            raise ValueError("need at least one lane")
        self.lanes = tuple(lanes)
        self._queues: Dict[str, collections.deque] = {
            lane: collections.deque() for lane in self.lanes}

    # -- occupancy ----------------------------------------------------------
    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def pending(self) -> bool:
        return any(self._queues.values())

    def n_queued(self, lane: Optional[str] = None) -> int:
        if lane is not None:
            return len(self._queues[lane])
        return len(self)

    def stats(self) -> Dict[str, int]:
        return {f"queued_{lane}": len(q) for lane, q in self._queues.items()}

    # -- queue ops ----------------------------------------------------------
    def push(self, req: SchedRequest, *, front: bool = False) -> None:
        """Enqueue ``req`` on its lane; ``front=True`` re-queues a
        preempted request ahead of its lane's FIFO order."""
        if req.lane not in self._queues:
            raise ValueError(
                f"unknown lane {req.lane!r}; have {self.lanes}")
        q = self._queues[req.lane]
        q.appendleft(req) if front else q.append(req)

    def candidates(self) -> Iterator[SchedRequest]:
        """All queued requests in admission-priority order: lanes in
        declared order (interactive first), FIFO within a lane.  The
        engine admits what fits and leaves the rest queued — iteration
        is over a snapshot, so ``remove`` during the scan is safe."""
        for lane in self.lanes:
            yield from list(self._queues[lane])

    def remove(self, req: SchedRequest) -> bool:
        """Dequeue ``req`` (admitted or cancelled); False if absent."""
        try:
            self._queues[req.lane].remove(req)
            return True
        except ValueError:
            return False

    def pop_rid(self, rid: int) -> Optional[SchedRequest]:
        """Dequeue the request with id ``rid`` (None if not queued)."""
        for q in self._queues.values():
            for req in q:
                if req.rid == rid:
                    q.remove(req)
                    return req
        return None

    def expire(self, now: float) -> List[SchedRequest]:
        """Pop every queued request whose deadline has passed.  Only
        *unstarted* requests expire — a preempted request already holds
        generated tokens its client has streamed, so it is exempt."""
        out: List[SchedRequest] = []
        for q in self._queues.values():
            kept, dead = [], []
            for req in q:
                is_dead = (req.deadline is not None and now > req.deadline
                           and not req.preempted)
                (dead if is_dead else kept).append(req)
            if dead:
                out.extend(dead)
                q.clear()
                q.extend(kept)
        return out
