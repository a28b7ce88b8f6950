"""Fault injection for the serving stack (chaos harness).

A :class:`FaultPlan` is a declarative list of :class:`Fault` points the
serving seams consult at runtime: the network writer loop before each
socket send, the engine at the top of each step, the admission fit
check, and the pipeline worker after a batch's requests have entered
the engine.  Every seam is behind a no-op default (``plan=None`` or a
plan with no matching fault costs one ``None`` check), so production
paths pay nothing; tests thread plans through
``ServeEngine(fault_plan=)`` / ``TensorQueryServer(fault_plan=)`` to
prove the stack degrades request-by-request instead of wedging.  (A
copy of ``repro/serving/faults.py``: the port imports nothing of the
JAX package.)

Fault points (the ``point`` strings the seams fire):

``server_send``
    In ``QueryConnection``'s writer thread, per outbound frame.
    Actions: ``close`` (socket torn down mid-conversation), ``stall``
    (writer sleeps ``stall_s`` — a consumer that stopped reading),
    ``partial`` (``cut_at`` bytes of the frame hit the wire, then the
    socket dies — the client sees a desynced/truncated stream).
``engine_step``
    Top of ``ServeEngine.step()``.  Action ``raise`` throws ``exc`` —
    a *non-attributable* failure: the engine must spill survivors,
    restart its pools, and keep serving (bounded restarts).
``admit``
    Top of the per-request fit check.  Action ``raise`` with
    ``CacheFullError`` simulates an allocator storm: the candidate
    stays queued (never failed) until the storm passes.
``worker``
    In the pipeline filter, after a batch's rows were submitted to the
    engine.  Action ``raise`` kills that worker's batch — request-level
    isolation must fail exactly those rows with ERROR frames and free
    their pool resources.
``submit``
    In the pipeline filter, per row, before ``engine.submit`` — a
    malformed/poison request; only that row may fail.

Counting: each ``Fault`` fires on its ``nth`` arrival at its point
(1-based) and keeps firing for ``times`` consecutive arrivals; with
``every=k`` it instead fires on every k-th arrival forever (rate-style
injection for the chaos benchmark).  Counters are per (plan, point)
and thread-safe.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence

__all__ = ["Fault", "FaultPlan"]


@dataclasses.dataclass
class Fault:
    """One injectable fault: where, when, and what happens."""
    point: str                       # seam name (see module docstring)
    nth: int = 1                     # fire on the nth arrival (1-based)
    times: int = 1                   # consecutive arrivals that fire
    every: int = 0                   # alternative: fire on every k-th arrival
    action: str = "raise"            # "raise" | "close" | "stall" | "partial"
    exc: type = RuntimeError         # exception type for action="raise"
    msg: str = "injected fault"      # exception message
    stall_s: float = 0.0             # action="stall": writer sleep
    cut_at: int = 4                  # action="partial": bytes sent before cut

    def hits(self, n: int) -> bool:
        """Does this fault fire on the ``n``-th arrival at its point?"""
        if self.every > 0:
            return n % self.every == 0
        return self.nth <= n < self.nth + self.times

    def make_exc(self) -> BaseException:
        return self.exc(self.msg)


class FaultPlan:
    """Thread-safe fault schedule consulted by the serving seams.

    ``fire(point)`` bumps the point's arrival counter and returns the
    matching :class:`Fault` (or None).  Seams interpret the returned
    action themselves — the plan never raises, so a seam can honour
    only the actions that make sense for it.  ``n_fired`` counts the
    faults actually delivered (for benchmark reporting)."""

    def __init__(self, faults: Sequence[Fault] = ()):
        self.faults: List[Fault] = list(faults)
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.n_fired = 0

    def add(self, fault: Fault) -> "FaultPlan":
        self.faults.append(fault)
        return self

    def fire(self, point: str) -> Optional[Fault]:
        with self._lock:
            n = self._counts.get(point, 0) + 1
            self._counts[point] = n
            for f in self.faults:
                if f.point == point and f.hits(n):
                    self.n_fired += 1
                    return f
        return None

    def arrivals(self, point: str) -> int:
        with self._lock:
            return self._counts.get(point, 0)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self.n_fired = 0

    def __repr__(self) -> str:
        return f"FaultPlan({self.faults!r})"


def fire(plan: Optional[FaultPlan], point: str) -> Optional[Fault]:
    """No-op-safe firing helper: seams call this with a possibly-None
    plan so the production path is a single ``is None`` check."""
    if plan is None:
        return None
    return plan.fire(point)
