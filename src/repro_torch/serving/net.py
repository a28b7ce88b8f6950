"""Tensor-query networking: the serving stack's front door (a copy of
``repro/serving/net.py`` over the port's own ``core`` copies; the port
imports nothing of the JAX package).

``TensorQueryServer`` mounts a :class:`~repro_torch.serving.engine.ServeEngine`
behind the ``tensor_query_serversrc`` / ``tensor_query_serversink``
pipeline elements (wire format in :mod:`repro_torch.core.elements.query`,
re-exported here):

    serversrc ! tensor_batcher ! queue(workers=N) !
        tensor_filter(pass_meta, engine.as_pipeline_filter) !
        tensor_unbatcher ! serversink

The batcher closes a micro-batch on size or ``max_wait_ms``; the
multi-worker queue lets several batches block inside the engine filter
*concurrently* (the engine's ``wait`` protocol elects one stepping
thread among them), which is what allows an interactive request to be
submitted — and to preempt batch-lane slots — while earlier batches are
still generating.  Tokens stream back per-request through the engine's
``stream_cb`` as they are drained from the decode burst ring buffer;
the DONE frame from the serversink carries the authoritative full
sequence plus terminal status, so a TOKENS delta lost to the
registration race (a token emitted between ``submit`` and the
``on_submit`` route registration) costs an increment, never data.

Fault tolerance (protocol v2): the server resolves MSG_CANCEL frames to
engine request ids (including cancels racing the batcher — they are
parked and land the moment the request registers) and kills
credit-starved routes with ``status="overrun"`` off the drain path; the
client can ``cancel(qid)``, grant flow-control credit, and — with
``reconnect=True`` — survive a dropped socket by reconnecting with
exponential backoff + jitter and idempotently resubmitting every query
the server never started streaming.  ``TensorQueryServer.drain`` stops
admission and sees every in-flight request to a terminal frame, which
is what the launcher's SIGTERM handler calls.

``TensorQueryClient`` is the matching client: ``submit`` returns a
connection-scoped query id immediately; a reader thread folds TOKENS
deltas into per-request state (recording time-to-first-token on
arrival) and ``result(qid)`` blocks for the DONE frame.
"""
from __future__ import annotations

import random
import socket
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..core.elements.query import (CONN_QID, HDR, LANE_CODES, LANE_NAMES,
                                   MAGIC, MSG_CANCEL, MSG_CREDIT, MSG_DONE,
                                   MSG_ERROR, MSG_REQUEST, MSG_TOKENS,
                                   STATUS_CODES, STATUS_NAMES, VERSION,
                                   ProtocolError, pack_credit, pack_frame,
                                   pack_tensor, read_frame, unpack_tensor)

__all__ = ["TensorQueryClient", "TensorQueryServer",
           "HDR", "MAGIC", "VERSION", "CONN_QID",
           "MSG_REQUEST", "MSG_TOKENS", "MSG_DONE", "MSG_ERROR",
           "MSG_CANCEL", "MSG_CREDIT", "LANE_CODES", "LANE_NAMES",
           "STATUS_CODES", "STATUS_NAMES", "ProtocolError",
           "pack_frame", "pack_tensor", "pack_credit",
           "read_frame", "unpack_tensor"]


class QueryResult:
    """Client-side per-request state, filled in by the reader thread.

    The submission parameters (prompt/lane/deadline/credit) are kept so
    a reconnecting client can idempotently resubmit a query the server
    never started streaming."""

    def __init__(self, qid: int, prompt: Optional[np.ndarray] = None,
                 lane: str = "interactive", deadline: Optional[float] = None,
                 credit: Optional[int] = None):
        self.qid = qid
        self.prompt = prompt
        self.lane = lane
        self.deadline = deadline
        self.credit = credit
        self.t_submit = time.monotonic()
        self.t_first: Optional[float] = None    # first TOKENS/DONE arrival
        self.t_done: Optional[float] = None
        self.stream: List[int] = []             # TOKENS deltas (best-effort)
        self.tokens: Optional[np.ndarray] = None  # authoritative, from DONE
        self.status: Optional[str] = None
        self.error: Optional[str] = None
        self.done = threading.Event()

    @property
    def ttft_s(self) -> Optional[float]:
        return None if self.t_first is None else self.t_first - self.t_submit

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit


class TensorQueryClient:
    """Blocking client for one tensor-query server connection.

    ``retries``/``backoff``/``reconnect`` make the client survive a
    dropped socket: with ``reconnect=True`` a dead connection is redialed
    up to ``retries`` times with exponential backoff (base ``backoff``
    seconds, full jitter), and every query the server never *started*
    (no TOKENS/DONE received) is resubmitted idempotently under its
    original qid; queries already mid-stream fail with a connection
    error — replaying half a stream would double tokens."""

    def __init__(self, host: str, port: int, connect_timeout: float = 10.0,
                 retries: int = 3, backoff: float = 0.05,
                 reconnect: bool = False):
        self.host, self.port = host, int(port)
        self.connect_timeout = float(connect_timeout)
        self.retries = max(1, int(retries))
        self.backoff = float(backoff)
        self.reconnect = bool(reconnect)
        self.n_reconnects = 0
        self.n_resubmitted = 0
        self.sock = self._dial()
        self._send_lock = threading.Lock()
        self._lock = threading.Lock()
        self._reconnect_lock = threading.Lock()
        self._next_qid = 0
        self._requests: Dict[int, QueryResult] = {}
        self._collected: set = set()    # qids result() already returned
        self._closed = False            # close() was called
        self._broken = False            # reader thread exited: socket dead
        self._conn_error: Optional[str] = None  # connection-scoped ERROR text
        self._reader = threading.Thread(target=self._read_loop,
                                        name="tq-client-reader", daemon=True)
        self._reader.start()

    def _dial(self) -> socket.socket:
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.connect_timeout)
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    # -- submission ---------------------------------------------------------
    def submit(self, prompt, lane: str = "interactive",
               deadline: Optional[float] = None,
               credit: Optional[int] = None) -> int:
        """Send one prompt; returns its query id without blocking.

        ``credit`` switches the query's token stream to credited flow
        control: the server will send at most ``credit`` TOKENS frames
        until :meth:`grant` refills (pausing, not dropping, at zero).
        Raises ``ConnectionError`` if the connection is closed or the
        socket is dead (instead of surfacing an opaque OS error)."""
        self._ensure_usable()
        arr = np.asarray(prompt, np.int32).reshape(-1)
        with self._lock:
            qid = self._next_qid
            self._next_qid += 1
            self._requests[qid] = QueryResult(qid, prompt=arr, lane=lane,
                                              deadline=deadline, credit=credit)
        try:
            self._send_request(qid, arr, lane, deadline, credit)
        except OSError as exc:
            if self.reconnect and not self._closed:
                # the resubmission path owns this query now: reconnect
                # replays every not-yet-started query, this one included
                self._broken = True
                try:
                    self._reconnect()
                    return qid
                except ConnectionError:
                    pass
            with self._lock:
                self._requests.pop(qid, None)   # never submitted
            raise ConnectionError(
                f"tensor_query connection is closed or broken, cannot "
                f"submit query {qid}: {exc}") from exc
        return qid

    def _ensure_usable(self) -> None:
        if self._closed:
            raise ConnectionError(
                "tensor_query client is closed — cannot submit new queries")
        if self._broken:
            if self.reconnect:
                self._reconnect()       # raises ConnectionError on failure
            else:
                raise ConnectionError(
                    "tensor_query connection is dead (socket closed or "
                    "broken, reader thread exited) — cannot submit new "
                    "queries")

    def _send_request(self, qid: int, arr: np.ndarray, lane: str,
                      deadline: Optional[float],
                      credit: Optional[int]) -> None:
        frame = pack_frame(MSG_REQUEST, qid, pack_tensor(arr),
                           lane=LANE_CODES[lane],
                           deadline=0.0 if deadline is None
                           else float(deadline))
        if credit is not None:
            frame += pack_frame(MSG_CREDIT, qid, pack_credit(credit))
        with self._send_lock:
            self.sock.sendall(frame)

    def cancel(self, qid: int) -> None:
        """Ask the server to abandon ``qid``.  Its terminal frame will
        be ``DONE(status="cancelled")`` carrying whatever tokens were
        generated before the cancel landed — keep waiting on
        :meth:`result` to collect it."""
        with self._lock:
            if qid not in self._requests and qid not in self._collected:
                raise ValueError(
                    f"unknown query id {qid}: not submitted on this "
                    "connection")
        try:
            with self._send_lock:
                self.sock.sendall(pack_frame(MSG_CANCEL, qid))
        except OSError as exc:
            raise ConnectionError(
                f"cannot send CANCEL for query {qid}: {exc}") from exc

    def grant(self, qid: int, n: int) -> None:
        """Grant the server ``n`` more TOKENS frames for ``qid``
        (credit-based flow control; see ``submit(credit=)``)."""
        try:
            with self._send_lock:
                self.sock.sendall(pack_frame(MSG_CREDIT, qid,
                                             pack_credit(n)))
        except OSError as exc:
            raise ConnectionError(
                f"cannot send CREDIT for query {qid}: {exc}") from exc

    def result(self, qid: int, timeout: Optional[float] = 60.0,
               cancel_on_timeout: bool = False) -> QueryResult:
        """Block until ``qid``'s DONE/ERROR frame arrives.  Raises
        ``ValueError`` for a qid this connection never submitted.

        Each ``QueryResult`` is returned exactly once: collecting it
        drops the client's own reference (a long-lived connection would
        otherwise retain every result's token arrays forever), leaving
        a tombstone so a second collection attempt is a clear
        ``ValueError`` rather than a silent unknown-qid one.  A timeout
        does *not* collect — the query can still be retrieved once it
        finishes — unless ``cancel_on_timeout`` is set, in which case
        the deadline is enforced *server-side*: a CANCEL is sent and the
        terminal ``DONE(cancelled)`` (with partial tokens) is returned
        instead of raising."""
        with self._lock:
            res = self._requests.get(qid)
            if res is None and qid in self._collected:
                raise ValueError(
                    f"query id {qid} already collected: result() returns "
                    "each query exactly once — keep the returned "
                    "QueryResult if you need it again")
        if res is None:
            raise ValueError(
                f"unknown query id {qid}: not submitted on this connection")
        if not res.done.wait(timeout=timeout):
            if cancel_on_timeout and not (self._closed or self._broken):
                try:
                    self.cancel(qid)
                except ConnectionError:
                    pass
                else:
                    grace = 5.0 if timeout is None \
                        else max(0.5, min(5.0, timeout))
                    if res.done.wait(timeout=grace):
                        with self._lock:
                            self._requests.pop(qid, None)
                            self._collected.add(qid)
                        return res
            raise TimeoutError(f"query {qid} not finished in {timeout}s")
        with self._lock:
            self._requests.pop(qid, None)
            self._collected.add(qid)
        return res

    # -- reader -------------------------------------------------------------
    def _read_loop(self) -> None:
        try:
            while not self._closed:
                frame = read_frame(self.sock)
                if frame is None:
                    break
                msg_type, qid, _lane, status, _deadline, payload = frame
                if qid == CONN_QID and msg_type == MSG_ERROR:
                    # connection-scoped failure (protocol desync, version
                    # mismatch): the server closes right after — record
                    # why so pending queries fail with the real reason
                    self._conn_error = payload.decode("utf-8", "replace")
                    continue
                with self._lock:
                    res = self._requests.get(qid)
                if res is None or res.done.is_set():
                    continue            # unknown, or duplicate terminal
                now = time.monotonic()
                if msg_type == MSG_TOKENS:
                    if res.t_first is None:
                        res.t_first = now
                    res.stream.extend(
                        int(t) for t in unpack_tensor(payload).reshape(-1))
                elif msg_type == MSG_DONE:
                    if res.t_first is None:
                        res.t_first = now
                    res.t_done = now
                    res.tokens = np.asarray(unpack_tensor(payload), np.int32)
                    res.status = STATUS_NAMES.get(status, "error")
                    res.done.set()
                elif msg_type == MSG_ERROR:
                    # ERROR is as terminal as DONE: stamp both
                    # timestamps so ttft_s/latency_s stay measurable
                    # for failed queries (percentile aggregation must
                    # count them, not silently drop them)
                    if res.t_first is None:
                        res.t_first = now
                    res.t_done = now
                    res.status = "error"
                    res.error = payload.decode("utf-8", "replace")
                    res.done.set()
        except (OSError, ConnectionError, ValueError):
            pass
        self._on_disconnect()

    def _on_disconnect(self) -> None:
        """The reader exited — server EOF, socket error, or close().
        With ``reconnect`` enabled (and no explicit close) try to
        resurrect the connection first: success resubmits every
        not-yet-started query and a fresh reader takes over.  Otherwise
        mark the client broken so ``submit`` fails fast, and complete
        everything still in flight with a connection error (connection
        death is a terminal path too — waiters must never sit out their
        full timeout)."""
        self._broken = True
        if self.reconnect and not self._closed:
            try:
                self._reconnect()
                return
            except ConnectionError:
                pass
        self._fail_pending(self._conn_error or "connection closed")

    def _fail_pending(self, msg: str) -> None:
        now = time.monotonic()
        with self._lock:
            pending = [r for r in self._requests.values()
                       if not r.done.is_set()]
        for res in pending:
            if res.t_first is None:
                res.t_first = now
            res.t_done = now
            res.status = "error"
            res.error = res.error or msg
            res.done.set()

    # -- reconnection -------------------------------------------------------
    def _reconnect(self) -> None:
        """Redial with exponential backoff + full jitter; on success,
        restart the reader and resubmit every not-yet-started query.
        Raises ``ConnectionError`` after ``retries`` failed dials."""
        with self._reconnect_lock:
            if self._closed:
                raise ConnectionError("tensor_query client is closed")
            if not self._broken:
                return                  # another thread already redialed
            delay = max(0.001, self.backoff)
            last: Optional[Exception] = None
            for attempt in range(self.retries):
                try:
                    sock = self._dial()
                except OSError as exc:
                    last = exc
                    time.sleep(delay * (1.0 + random.random()))
                    delay = min(delay * 2.0, 2.0)
                    continue
                old, self.sock = self.sock, sock
                try:
                    old.close()
                except OSError:
                    pass
                self._broken = False
                self.n_reconnects += 1
                # fresh reader BEFORE resubmitting, so replies on the
                # new socket are consumed from the first frame
                self._reader = threading.Thread(
                    target=self._read_loop, name="tq-client-reader",
                    daemon=True)
                self._reader.start()
                self._resubmit_unstarted()
                return
            self._fail_pending(f"reconnect to {self.host}:{self.port} "
                               f"failed after {self.retries} attempts: {last}")
            raise ConnectionError(
                f"reconnect to {self.host}:{self.port} failed after "
                f"{self.retries} attempts: {last}") from last

    def _resubmit_unstarted(self) -> None:
        """Replay queries the dead connection never started streaming
        (idempotent: the server never saw — or never admitted — them
        under this socket, and qids keep their values).  Queries already
        mid-stream cannot be replayed without double-counting tokens:
        they fail with a connection error."""
        with self._lock:
            pending = [r for r in self._requests.values()
                       if not r.done.is_set()]
        unstarted = [r for r in pending
                     if r.t_first is None and r.prompt is not None]
        started = [r for r in pending if r not in unstarted]
        now = time.monotonic()
        for res in started:
            if res.t_first is None:
                res.t_first = now
            res.t_done = now
            res.status = "error"
            res.error = res.error or "connection lost mid-stream"
            res.done.set()
        for res in unstarted:
            try:
                self._send_request(res.qid, res.prompt, res.lane,
                                   res.deadline, res.credit)
                self.n_resubmitted += 1
            except OSError:
                return    # fresh socket died; its reader handles the rest

    def close(self) -> None:
        """Close the connection.  Every outstanding query is completed
        immediately with a connection error — a waiter blocked in
        ``result()`` returns now, not after its full timeout."""
        self._closed = True
        try:
            # shutdown (not just close) unblocks a reader parked in
            # recv(); without it the reader — and every waiter — would
            # hang until the OS noticed the dead fd
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        if self._reader is not threading.current_thread():
            self._reader.join(timeout=2.0)
        # belt and braces: even a wedged reader must not leave waiters
        # blocked past close()
        self._fail_pending("connection closed")


class TensorQueryServer:
    """Serve a ``ServeEngine`` over TCP through the stream pipeline.

    ``pause_limit`` bounds each credited route's paused-TOKENS buffer
    (overflow kills the request with ``status="overrun"``);
    ``fault_plan`` threads a :class:`repro_torch.serving.faults.FaultPlan`
    into the per-connection writer loops (``server_send`` seam)."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 max_batch: Optional[int] = None, max_wait_ms: float = 5.0,
                 pad_to: Optional[int] = None, workers: int = 4,
                 queue_size: int = 64, stream: bool = True,
                 filter_timeout_s: Optional[float] = None,
                 pause_limit: int = 64, fault_plan=None):
        from ..core import elements as E
        from ..core.pipeline import Pipeline
        self.engine = engine
        if max_batch is None:
            max_batch = engine.batch_size
        if pad_to is None:
            pad_to = max(8, engine.capacity - engine.max_new_tokens)
        self.stream = bool(stream)
        self._routes: Dict[int, tuple] = {}     # engine rid -> (conn, qid)
        self._rev: Dict[tuple, int] = {}        # (id(conn), qid) -> rid
        self._pending_cancels: Dict[tuple, float] = {}  # arrived pre-register
        self._killing: set = set()              # rids with an async kill out
        self._routes_lock = threading.Lock()
        self.n_overrun_kills = 0

        self.src = E.TensorQueryServerSrc("qsrc", host=host, port=port,
                                          pad_to=pad_to,
                                          on_cancel=self._on_cancel,
                                          pause_limit=pause_limit,
                                          fault_plan=fault_plan)
        batcher = E.TensorBatcher("batch", max_batch=max_batch,
                                  max_wait_ms=max_wait_ms)
        q = E.Queue("dispatch", max_size=queue_size, workers=workers)
        filt = E.TensorFilter(
            "llm", framework="python", max_batch=max_batch, pass_meta=True,
            fn=engine.as_pipeline_filter(use_meta=True,
                                         on_submit=self._register,
                                         timeout_s=filter_timeout_s))
        unbatch = E.TensorUnbatcher("unbatch")
        self.sink = E.TensorQueryServerSink("qsink", on_done=self._unroute)
        self.pipeline = (Pipeline("tensor-query-server")
                         .add(self.src, batcher, q, filt, unbatch, self.sink)
                         .link("qsrc", "batch", "dispatch", "llm",
                               "unbatch", "qsink"))

    # -- routing ------------------------------------------------------------
    def _register(self, rid: int, meta) -> None:
        q = meta.get("query") if isinstance(meta, dict) else None
        if not (isinstance(q, dict) and q.get("conn") is not None):
            return
        key = (id(q["conn"]), int(q["qid"]))
        now = time.monotonic()
        with self._routes_lock:
            self._routes[rid] = (q["conn"], int(q["qid"]))
            self._rev[key] = rid
            cancelled = self._pending_cancels.pop(key, None) is not None
            # bound the parking lot: a CANCEL whose REQUEST never
            # arrives (bogus qid) must not pin memory forever
            stale = [k for k, t in self._pending_cancels.items()
                     if now - t > 60.0]
            for k in stale:
                del self._pending_cancels[k]
        if cancelled:
            # the cancel raced the batcher and lost: land it now that
            # the request exists engine-side
            self.engine.cancel(rid)

    def _unroute(self, meta) -> None:
        """Drop a request's route once its terminal frame was sent (or
        its connection died) — routes must never outlive the request."""
        rid = meta.get("rid") if isinstance(meta, dict) else None
        q = meta.get("query") if isinstance(meta, dict) else None
        with self._routes_lock:
            if rid is not None:
                self._routes.pop(int(rid), None)
            if isinstance(q, dict) and q.get("conn") is not None:
                self._rev.pop((id(q["conn"]), int(q["qid"])), None)

    def _on_cancel(self, conn, qid: int) -> None:
        """A MSG_CANCEL arrived on ``conn``.  Resolve it to an engine
        rid and cancel; a cancel racing the batcher (REQUEST pushed but
        not yet submitted) is parked and lands at registration.  A qid
        the server has never seen gets an immediate empty
        DONE(cancelled) so the client always receives a terminal
        frame."""
        key = (id(conn), qid)
        with self._routes_lock:
            rid = self._rev.get(key)
            if rid is None:
                self._pending_cancels[key] = time.monotonic()
        if rid is not None:
            self.engine.cancel(rid)
        else:
            # either mid-batcher (the parked cancel lands at register,
            # which then answers through the pipeline) or unknown/already
            # finished — answer directly so the client never hangs;
            # duplicate terminal frames are ignored client-side
            conn.send_frame(MSG_DONE, qid,
                            pack_tensor(np.zeros((0,), np.int32)),
                            status=STATUS_CODES["cancelled"])

    def _on_tokens(self, rid: int, new_tokens) -> None:
        with self._routes_lock:
            route = self._routes.get(rid)
        if route is None:
            return
        conn, qid = route
        # enqueue-only (the connection's writer thread does the socket
        # I/O) so a stalled client cannot block the engine's drain path
        outcome = conn.send_tokens(
            qid, pack_tensor(np.asarray(new_tokens, np.int32)))
        if outcome == "overrun":
            # the client never refilled this route's credit and its
            # pause buffer is full: kill the request.  Deferred to a
            # helper thread because this callback fires from inside the
            # stepping thread, which holds the step lock cancel() needs.
            self._kill_async(rid, "overrun")
        if not conn.alive:
            with self._routes_lock:
                self._routes.pop(rid, None)

    def _kill_async(self, rid: int, status: str) -> None:
        with self._routes_lock:
            if rid in self._killing:
                return
            self._killing.add(rid)
        self.n_overrun_kills += 1

        def kill() -> None:
            try:
                self.engine.cancel(rid, status)
            finally:
                with self._routes_lock:
                    self._killing.discard(rid)
        threading.Thread(target=kill, name=f"tq-kill:{rid}",
                         daemon=True).start()

    # -- lifecycle ----------------------------------------------------------
    @property
    def port(self) -> int:
        return self.src.port

    def start(self) -> "TensorQueryServer":
        if self.stream:
            self.engine.stream_cb = self._on_tokens
        self.pipeline.start()
        return self

    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful drain: stop admitting (listener closed, further
        REQUESTs rejected with an ERROR frame), then wait for every
        in-flight request to reach a terminal frame.  Past ``timeout``
        whatever is left is cancelled with ``status="timeout"`` so no
        client is ever left without an answer.  Returns True if
        everything finished naturally.  Call :meth:`stop` afterwards to
        tear the pipeline down."""
        self.src.stop_accepting()
        deadline = time.monotonic() + max(0.0, timeout)
        settled = 0
        while time.monotonic() < deadline:
            with self._routes_lock:
                n_routes = len(self._routes)
            if n_routes == 0 and not self.engine.has_work:
                # require the quiet state to hold across a few polls:
                # a request can sit in the batcher/queue where neither
                # the route table nor the engine sees it yet
                settled += 1
                if settled >= 3:
                    return True
            else:
                settled = 0
            time.sleep(0.05)
        for rid in self.engine.inflight_rids():
            self.engine.cancel(rid, "timeout")
        flush_deadline = time.monotonic() + 2.0
        while time.monotonic() < flush_deadline:
            with self._routes_lock:
                if not self._routes:
                    break
            time.sleep(0.02)
        return False

    def stop(self) -> None:
        self.pipeline.stop()
        if self.engine.stream_cb == self._on_tokens:
            self.engine.stream_cb = None
        with self._routes_lock:
            self._routes.clear()
            self._rev.clear()
            self._pending_cancels.clear()
