"""tensor_query — network-transparent pipeline edges (paper §III-C).

NNStreamer's ``tensor_query_serversrc``/``tensor_query_serversink``
let a pipeline serve requests from *other* processes/devices: tensors
arrive over a socket, flow through the pipeline like any local stream,
and results return to the requesting peer.  This module reproduces the
pair for the LLM serving path: prompts come in as int32 token tensors,
per-request token deltas stream back as they are generated, and a DONE
frame carries the final sequence plus terminal status.

Wire format (one TCP connection per client, frames in both directions)::

    header  := !2sBBIBBdI   (network byte order, 22 bytes)
               magic "TQ" | version | msg_type | qid | lane | status
               | deadline (f64 relative seconds, 0 = none) | payload_len
    payload := dtype_code u8 | ndim u8 | ndim * dim u32 | raw bytes (LE)
               (MSG_ERROR carries a UTF-8 message instead of a tensor)

Message types: ``REQUEST`` client->server (prompt tensor; lane +
deadline honoured), ``TOKENS`` server->client (incremental new-token
delta), ``DONE`` server->client (full token tensor + terminal status),
``ERROR`` (malformed/oversized request, or a request-level failure; an
ERROR with qid 0xFFFFFFFF is connection-scoped — protocol desync, the
peer closes after sending it), ``CANCEL`` client->server (abandon a
request: the server evicts it and answers ``DONE(status=cancelled)``
with whatever tokens it generated), ``CREDIT`` client->server (u32
payload: grant N more TOKENS frames for this qid — credit-based flow
control; at zero credit the server *pauses* that route's TOKENS in a
bounded per-request buffer instead of dropping them, and a route whose
buffer overflows is killed with ``status=overrun``).  ``qid`` is
chosen by the client and is scoped to its connection, so the server
routes responses by (connection, qid) while the engine schedules by its
own request id.

Version 2 added CANCEL/CREDIT and the credit semantics.  A frame whose
version does not match is answered with a connection-scoped ERROR and
the connection is closed — after a header disagreement the stream can
never be resynchronized, so failing loudly beats silently desyncing.

``TensorQueryServerSrc`` pushes one buffer per request: a ``(pad_to,)``
int32 row, left-padded with zeros (the engine treats leading zeros as
padding), with ``meta["query"]`` carrying the transport routing fields
consumed by ``ServeEngine.as_pipeline_filter(use_meta=True)`` and
``TensorQueryServerSink``.  The client side lives in
``repro.serving.net``.
"""
from __future__ import annotations

import collections
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..element import Element, Pad
from ..stream import Buffer
from .sources import SourceElement

MAGIC = b"TQ"
VERSION = 2                         # v2: CANCEL/CREDIT + credit flow control
HDR = struct.Struct("!2sBBIBBdI")   # magic, ver, type, qid, lane, status,
                                    # deadline, payload_len
MSG_REQUEST, MSG_TOKENS, MSG_DONE, MSG_ERROR = 1, 2, 3, 4
MSG_CANCEL, MSG_CREDIT = 5, 6
CONN_QID = 0xFFFFFFFF               # qid of connection-scoped ERROR frames
# absurd-length guard: a corrupted/hostile header must fail the parse,
# not commit the reader to a multi-GB recv
MAX_PAYLOAD = 64 * 1024 * 1024

LANE_CODES = {"interactive": 0, "batch": 1}
LANE_NAMES = {v: k for k, v in LANE_CODES.items()}
STATUS_CODES = {"ok": 0, "timeout": 1, "expired": 2, "cancelled": 3,
                "oom": 4, "error": 5, "overrun": 6}
STATUS_NAMES = {v: k for k, v in STATUS_CODES.items()}
_DTYPE_CODES = {"int32": 1, "float32": 2, "int64": 3, "uint8": 4}
_DTYPE_NAMES = {v: k for k, v in _DTYPE_CODES.items()}


class ProtocolError(ValueError):
    """Unrecoverable framing error (bad magic, version mismatch, absurd
    payload length): the byte stream cannot be resynchronized, so the
    peer must answer with a connection-scoped ERROR and close."""


def pack_tensor(arr: np.ndarray) -> bytes:
    """dtype code, ndim, dims (u32 each), then little-endian raw bytes."""
    arr = np.asarray(arr)
    name = str(arr.dtype)
    if name not in _DTYPE_CODES:
        raise ValueError(f"unsupported wire dtype {name!r}")
    head = struct.pack("!BB", _DTYPE_CODES[name], arr.ndim)
    dims = struct.pack(f"!{arr.ndim}I", *arr.shape)
    return head + dims + arr.astype(arr.dtype.newbyteorder("<")).tobytes()


def unpack_tensor(payload: bytes) -> np.ndarray:
    code, ndim = struct.unpack_from("!BB", payload, 0)
    if code not in _DTYPE_NAMES:
        raise ValueError(f"unknown wire dtype code {code}")
    shape = struct.unpack_from(f"!{ndim}I", payload, 2)
    dtype = np.dtype(_DTYPE_NAMES[code]).newbyteorder("<")
    raw = payload[2 + 4 * ndim:]
    n = int(np.prod(shape)) if ndim else 1
    if len(raw) != n * dtype.itemsize:
        raise ValueError(f"tensor payload size mismatch: {len(raw)} bytes "
                         f"for shape {shape} {dtype}")
    return np.frombuffer(raw, dtype=dtype).reshape(shape).astype(
        _DTYPE_NAMES[code])


def pack_frame(msg_type: int, qid: int, payload: bytes = b"", *,
               lane: int = 0, status: int = 0, deadline: float = 0.0) -> bytes:
    return HDR.pack(MAGIC, VERSION, msg_type, qid, lane, status,
                    deadline, len(payload)) + payload


def pack_credit(n: int) -> bytes:
    """CREDIT payload: a single u32 grant."""
    return struct.pack("!I", int(n))


def unpack_credit(payload: bytes) -> int:
    if len(payload) != 4:
        raise ValueError(f"CREDIT payload must be 4 bytes, got {len(payload)}")
    return struct.unpack("!I", payload)[0]


def recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly ``n`` bytes; None on orderly EOF at a frame edge."""
    chunks: List[bytes] = []
    got = 0
    while got < n:
        part = sock.recv(n - got)
        if not part:
            if got == 0:
                return None
            raise ConnectionError("peer closed mid-frame")
        chunks.append(part)
        got += len(part)
    return b"".join(chunks)


def read_frame(sock: socket.socket
               ) -> Optional[Tuple[int, int, int, int, float, bytes]]:
    """-> (msg_type, qid, lane, status, deadline, payload) or None on EOF."""
    hdr = recv_exact(sock, HDR.size)
    if hdr is None:
        return None
    magic, ver, msg_type, qid, lane, status, deadline, plen = HDR.unpack(hdr)
    if magic != MAGIC:
        raise ProtocolError(f"bad frame magic {magic!r}")
    if ver != VERSION:
        raise ProtocolError(
            f"unsupported tensor_query version {ver} (this peer speaks "
            f"{VERSION}); refusing to parse further — the stream cannot "
            "be resynchronized across a header disagreement")
    if plen > MAX_PAYLOAD:
        raise ProtocolError(
            f"frame payload length {plen} exceeds the {MAX_PAYLOAD}-byte "
            "cap — corrupted or hostile header")
    payload = recv_exact(sock, plen) if plen else b""
    if plen and payload is None:
        raise ConnectionError("peer closed mid-frame")
    return msg_type, qid, lane, status, deadline, payload


class QueryConnection:
    """One accepted client connection with a bounded, non-blocking
    outbound path.

    ``send_frame`` only *enqueues*: a dedicated writer thread drains the
    per-connection queue into the socket, so a slow or dead client can
    never stall the caller — in particular the engine's streaming
    callback, which fires from inside the decode/drain path and must
    return immediately for every other resident slot's sake.  The queue
    is bounded: best-effort TOKENS deltas are dropped on overflow
    (``n_dropped`` counts them; the DONE frame carries the authoritative
    full sequence), while terminal DONE/ERROR frames always enqueue
    (their number is bounded by requests in flight).  A failed socket
    write marks the connection dead and discards the backlog; frame
    order is preserved because the writer is the sole sender.

    **Credit-based flow control** (protocol v2): once a client sends a
    CREDIT frame for a qid, that route switches from best-effort to
    credited — each TOKENS frame spends one credit, and at zero credit
    frames *pause* in a bounded per-qid buffer instead of dropping.
    ``grant_credit`` refills and flushes in order.  A route whose pause
    buffer overflows (the client never refilled) reports ``"overrun"``
    to the caller, which kills the request with ``status=overrun``.
    The terminal DONE/ERROR frame flushes any still-paused TOKENS ahead
    of itself — bounded by ``pause_limit`` — so a credited route never
    *loses* tokens, it only defers them.
    """

    def __init__(self, sock: socket.socket, addr, max_outbound: int = 256,
                 pause_limit: int = 64, fault_plan=None):
        self.sock = sock
        self.addr = addr
        self.alive = True
        self.max_outbound = int(max_outbound)
        self.pause_limit = int(pause_limit)
        self.n_dropped = 0
        self.n_paused = 0               # TOKENS frames ever paused
        self.n_overruns = 0             # routes killed by pause overflow
        self._credit: Dict[int, int] = {}        # qid -> remaining credit
        self._paused: Dict[int, collections.deque] = {}
        self._faults = fault_plan
        self._q: collections.deque = collections.deque()
        self._q_lock = threading.Lock()
        self._q_event = threading.Event()
        self._sending = False           # writer mid-sendall (close() flush)
        self._writer = threading.Thread(
            target=self._write_loop, name=f"qconn:{addr}:writer", daemon=True)
        self._writer.start()

    def send_frame(self, msg_type: int, qid: int, payload: bytes = b"", *,
                   status: int = 0) -> bool:
        """Enqueue one frame for the writer thread; never blocks.
        Returns False if the connection is dead or a best-effort TOKENS
        frame was dropped on queue overflow.  Terminal DONE/ERROR
        frames flush the qid's paused TOKENS ahead of themselves and
        retire its credit state — the route is over either way."""
        if not self.alive:
            return False
        frame = pack_frame(msg_type, qid, payload, status=status)
        with self._q_lock:
            if msg_type in (MSG_DONE, MSG_ERROR):
                for paused in self._paused.pop(qid, ()):
                    self._q.append(paused)
                self._credit.pop(qid, None)
            elif len(self._q) >= self.max_outbound and msg_type == MSG_TOKENS:
                self.n_dropped += 1
                return False
            self._q.append(frame)
        self._q_event.set()
        return True

    def send_tokens(self, qid: int, payload: bytes):
        """Enqueue a TOKENS delta under the route's flow-control mode.

        Returns True (sent), False (dead connection, or dropped on
        overflow in legacy best-effort mode), ``"paused"`` (zero
        credit: buffered until the client refills), or ``"overrun"``
        (pause buffer overflow: the caller must kill the request)."""
        if not self.alive:
            return False
        with self._q_lock:
            credit = self._credit.get(qid)
            if credit is None:               # legacy best-effort route
                pass
            elif credit > 0:
                self._credit[qid] = credit - 1
            else:
                buf = self._paused.setdefault(qid, collections.deque())
                if len(buf) >= self.pause_limit:
                    self.n_overruns += 1
                    return "overrun"
                buf.append(pack_frame(MSG_TOKENS, qid, payload))
                self.n_paused += 1
                return "paused"
            frame = pack_frame(MSG_TOKENS, qid, payload)
            if len(self._q) >= self.max_outbound:
                self.n_dropped += 1
                return False
            self._q.append(frame)
        self._q_event.set()
        return True

    def grant_credit(self, qid: int, n: int) -> None:
        """Refill a route's TOKENS credit (switches it to credited mode
        on first grant) and flush its paused frames in order."""
        flushed = False
        with self._q_lock:
            credit = self._credit.get(qid, 0) + max(0, int(n))
            buf = self._paused.get(qid)
            while credit > 0 and buf:
                self._q.append(buf.popleft())
                credit -= 1
                flushed = True
            if buf is not None and not buf:
                self._paused.pop(qid, None)
            self._credit[qid] = credit
        if flushed:
            self._q_event.set()

    def n_paused_for(self, qid: int) -> int:
        with self._q_lock:
            return len(self._paused.get(qid, ()))

    @property
    def n_outbound(self) -> int:
        """Frames queued but not yet written to the socket."""
        with self._q_lock:
            return len(self._q)

    def _kill_socket(self) -> None:
        """Tear the transport down from the writer side.  ``shutdown``
        before ``close`` matters: the reader thread is blocked in
        ``recv`` holding a reference to the open file description, so a
        bare ``close`` would neither send FIN to the peer nor unblock
        the reader — the peer would hang instead of seeing EOF."""
        self.alive = False
        with self._q_lock:
            self._q.clear()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass

    def _write_loop(self) -> None:
        while True:
            with self._q_lock:
                frame = self._q.popleft() if self._q else None
                if frame is None:
                    self._q_event.clear()
                else:
                    self._sending = True
            if frame is None:
                if not self.alive:
                    return
                self._q_event.wait(timeout=0.5)
                continue
            # fault seam: chaos plans inject send-side failures here (the
            # plan is duck-typed so the core layer needs no serving import)
            fault = self._faults.fire("server_send") if self._faults else None
            if fault is not None:
                if fault.action == "stall":
                    time.sleep(fault.stall_s)
                elif fault.action in ("close", "partial"):
                    if fault.action == "partial":
                        try:
                            self.sock.sendall(frame[:fault.cut_at])
                        except OSError:
                            pass
                    self._kill_socket()
                    return
            try:
                self.sock.sendall(frame)
            except OSError:
                self._kill_socket()
                return
            finally:
                with self._q_lock:
                    self._sending = False

    def close(self, flush_timeout: float = 1.0) -> None:
        # bounded flush: frames already queued (e.g. the protocol-error
        # ERROR the reader posted just before closing) must reach the
        # wire before the socket is torn down under the writer
        deadline = time.monotonic() + max(0.0, flush_timeout)
        while self.alive and time.monotonic() < deadline:
            with self._q_lock:
                idle = not self._q and not self._sending
            if idle:
                break
            time.sleep(0.005)
        self.alive = False
        self._q_event.set()             # wake the writer so it can exit
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class TensorQueryServerSrc(SourceElement):
    """Accept tensor-query clients and push one buffer per request.

    Each REQUEST frame becomes a ``(pad_to,)`` int32 row (left-padded
    with zeros so a downstream ``tensor_batcher`` can stack rows of
    different prompt lengths) with routing metadata::

        meta["query"] = {"conn": QueryConnection, "qid": int,
                         "lane": "interactive"|"batch",
                         "deadline": float|None,   # relative seconds
                         "prompt_len": int, "t_arrival": float}

    Oversized or malformed requests are answered with an ERROR frame and
    never enter the pipeline.

    ``on_cancel(conn, qid)`` — if given — receives MSG_CANCEL frames
    (the server resolves the route and evicts the request); without it
    a CANCEL is answered directly with an empty ``DONE(cancelled)``.
    CREDIT frames are absorbed locally (``conn.grant_credit``).  During
    a drain (``stop_accepting()``) new REQUESTs are rejected with an
    ERROR while open connections keep streaming their in-flight work.
    """

    def __init__(self, name: str, host: str = "127.0.0.1", port: int = 0,
                 pad_to: int = 64, backlog: int = 16,
                 on_cancel: Optional[
                     Callable[[QueryConnection, int], None]] = None,
                 pause_limit: int = 64, fault_plan=None):
        super().__init__(name)
        self.host, self.port = host, int(port)
        self.pad_to = int(pad_to)
        self.backlog = int(backlog)
        self.on_cancel = on_cancel
        self.pause_limit = int(pause_limit)
        self.fault_plan = fault_plan
        self.draining = False
        self._listener: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self.connections: List[QueryConnection] = []
        self.n_requests = 0
        self.n_rejected = 0
        self.n_cancels = 0
        self.n_conn_errors = 0          # connections dropped during setup/read
        self._eos_sent = False

    @property
    def address(self) -> Tuple[str, int]:
        return self.host, self.port

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self._running = True
        self._eos_sent = False
        lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lst.bind((self.host, self.port))
        lst.listen(self.backlog)
        self.port = lst.getsockname()[1]
        self._listener = lst
        t = threading.Thread(target=self._accept_loop,
                             name=f"qsrc:{self.name}:accept", daemon=True)
        t.start()
        self._threads.append(t)

    def stop_accepting(self) -> None:
        """Enter drain mode: close the listener and reject any further
        REQUEST frames; open connections keep flowing.  ``shutdown``
        before ``close``: the accept thread blocked in ``accept()``
        holds a reference to the open file description, so a bare
        ``close`` would leave the kernel socket listening (and the
        thread happily accepting) until that syscall returned."""
        self.draining = True
        if self._listener is not None:
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None

    def stop(self) -> None:
        self._running = False
        if self._listener is not None:
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None
        for conn in list(self.connections):
            conn.close()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads = []
        # flush any partial batch downstream exactly once
        if not self._eos_sent:
            self._eos_sent = True
            self.srcpad.push(Buffer.eos_buffer())

    # -- network side -------------------------------------------------------
    def _accept_loop(self) -> None:
        while self._running and self._listener is not None:
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return                     # listener closed by stop()/drain
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn = QueryConnection(sock, addr,
                                       pause_limit=self.pause_limit,
                                       fault_plan=self.fault_plan)
                self.connections.append(conn)
                t = threading.Thread(
                    target=self._reader, args=(conn,),
                    name=f"qsrc:{self.name}:{addr}", daemon=True)
                t.start()
                self._threads.append(t)
            except Exception:              # one bad socket, not the loop
                self.n_conn_errors += 1
                try:
                    sock.close()
                except OSError:
                    pass

    def _reader(self, conn: QueryConnection) -> None:
        while self._running and conn.alive:
            try:
                frame = read_frame(conn.sock)
            except ProtocolError as exc:
                # the stream cannot be resynchronized: tell the peer why
                # (connection-scoped qid), then drop only this connection
                self.n_conn_errors += 1
                conn.send_frame(MSG_ERROR, CONN_QID, str(exc).encode(),
                                status=STATUS_CODES["error"])
                break
            except (OSError, ConnectionError, ValueError):
                self.n_conn_errors += 1
                break
            if frame is None:
                break
            msg_type, qid, lane, _status, deadline, payload = frame
            if msg_type == MSG_CANCEL:
                self.n_cancels += 1
                try:
                    if self.on_cancel is not None:
                        self.on_cancel(conn, qid)
                    else:
                        conn.send_frame(
                            MSG_DONE, qid,
                            pack_tensor(np.zeros((0,), np.int32)),
                            status=STATUS_CODES["cancelled"])
                except Exception as exc:   # cancel must never kill the conn
                    conn.send_frame(MSG_ERROR, qid,
                                    f"cancel failed: {exc}".encode(),
                                    status=STATUS_CODES["error"])
                continue
            if msg_type == MSG_CREDIT:
                try:
                    conn.grant_credit(qid, unpack_credit(payload))
                except ValueError as exc:
                    conn.send_frame(MSG_ERROR, qid, str(exc).encode(),
                                    status=STATUS_CODES["error"])
                continue
            if msg_type != MSG_REQUEST:
                conn.send_frame(MSG_ERROR, qid,
                                f"unexpected message type {msg_type}".encode(),
                                status=STATUS_CODES["error"])
                continue
            try:
                self._handle_request(conn, qid, lane, deadline, payload)
            except Exception as exc:       # request-level isolation: fail
                self.n_rejected += 1       # this qid, keep the connection
                conn.send_frame(MSG_ERROR, qid,
                                f"request failed: {exc}".encode(),
                                status=STATUS_CODES["error"])
                continue
        conn.close()

    def _handle_request(self, conn: QueryConnection, qid: int, lane: int,
                        deadline: float, payload: bytes) -> None:
        if self.draining:
            self.n_rejected += 1
            conn.send_frame(MSG_ERROR, qid, b"server draining",
                            status=STATUS_CODES["error"])
            return
        try:
            prompt = np.asarray(unpack_tensor(payload), np.int32).reshape(-1)
        except ValueError as exc:
            self.n_rejected += 1
            conn.send_frame(MSG_ERROR, qid, str(exc).encode(),
                            status=STATUS_CODES["error"])
            return
        if prompt.size == 0 or prompt.size > self.pad_to:
            self.n_rejected += 1
            conn.send_frame(
                MSG_ERROR, qid,
                f"prompt length {prompt.size} outside (0, {self.pad_to}]"
                .encode(), status=STATUS_CODES["error"])
            return
        row = np.zeros((self.pad_to,), np.int32)
        row[self.pad_to - prompt.size:] = prompt
        now = time.monotonic()
        meta = {"query": {
            "conn": conn, "qid": qid,
            "lane": LANE_NAMES.get(lane, "interactive"),
            "deadline": deadline if deadline > 0 else None,
            "prompt_len": int(prompt.size), "t_arrival": now,
        }}
        self.n_requests += 1
        self.srcpad.push(Buffer(row, pts=now, meta=meta))


class TensorQueryServerSink(Element):
    """Send each finished request back to its client as a DONE frame.

    Expects per-request buffers (downstream of ``tensor_unbatcher``)
    whose meta carries the ``query`` routing dict from
    ``TensorQueryServerSrc`` plus the ``status`` / ``n_tokens`` fields
    the engine filter wrote back.  Buffers without routing metadata are
    counted and dropped (e.g. locally injected test traffic).

    ``on_done(meta)`` — if given — fires after the terminal frame is
    handed to the connection, whether or not the send succeeded; the
    server uses it to drop its (request -> connection) route the moment
    a request reaches a terminal state."""

    def __init__(self, name: str,
                 on_done: Optional[Callable[[Dict[str, Any]], None]] = None):
        super().__init__(name)
        self.add_sink_pad()
        self.on_done = on_done
        self.n_sent = 0
        self.n_errors = 0
        self.n_unroutable = 0
        self.eos_seen = threading.Event()

    def chain(self, pad: Pad, buf: Buffer) -> None:
        if buf.eos:
            self.eos_seen.set()
            return
        q = buf.meta.get("query") if isinstance(buf.meta, dict) else None
        conn = q.get("conn") if isinstance(q, dict) else None
        if conn is None:
            self.n_unroutable += 1
            return
        status_name = buf.meta.get("status", "ok")
        status = STATUS_CODES.get(status_name, STATUS_CODES["error"])
        # count before the send: a client that acts on the DONE frame
        # (and e.g. reads this counter) must never observe it lagging
        self.n_sent += 1
        if status_name == "error":
            # request-level failure: the client gets an ERROR frame with
            # the failure message instead of a token tensor
            self.n_errors += 1
            msg = str(buf.meta.get("error", "request failed")).encode()
            ok = conn.send_frame(MSG_ERROR, int(q["qid"]), msg, status=status)
        else:
            tokens = np.asarray(buf.chunks[0], np.int32).reshape(-1)
            n = buf.meta.get("n_tokens")
            if n is not None:
                tokens = tokens[:int(n)]
            ok = conn.send_frame(MSG_DONE, int(q["qid"]), pack_tensor(tokens),
                                 status=status)
        if not ok:
            self.n_sent -= 1          # connection died under the send
        if self.on_done is not None:
            self.on_done(buf.meta)    # terminal: the route is dead either way
