"""The port's tensor-query front door over loopback TCP, on the CPU.

A ``TensorQueryServer`` over the port's paged engine (tiny transformer,
weights from the reference's ``init`` through the bridge) must answer
with the tokens the JAX package's server gives for the same prompts,
across lanes and clients; reject an oversized prompt with an error
frame; return the partial tokens of a request cancelled mid-stream;
pause a credited stream without dropping it; finish in-flight work on
``drain`` and reject what comes after; and the launcher's ``--listen``
must serve its smoke client over lanes, and drain and exit 0 on
SIGTERM as a standing server.  No assertion depends on timing:
waits poll with a bound, and the one race (a cancel against the engine
finishing) is closed by holding the engine until the cancel lands.
Every socket binds 127.0.0.1:0.
"""
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from conftest import TINY_SERVE
from repro.models import build_model as jax_build_model
from repro.serving import ServeEngine as JaxEngine
from repro.serving import TensorQueryClient as JaxClient
from repro.serving import TensorQueryServer as JaxServer
from repro_torch import bridge
from repro_torch.core.elements.query import (MSG_TOKENS, QueryConnection,
                                             pack_tensor, read_frame,
                                             unpack_tensor)
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.serving import (ServeEngine, TensorQueryClient,
                                 TensorQueryServer)

REPO = Path(__file__).resolve().parents[1]
ENGINE = dict(batch_size=4, capacity=64, max_new_tokens=6, block_size=8)
_rng = np.random.default_rng(31)
PROMPTS = [_rng.integers(1, TINY_SERVE.vocab_size, n).astype(np.int32)
           for n in (3, 7, 12, 5, 9, 16, 4)]


@pytest.fixture(scope="module")
def models():
    jm = jax_build_model(TINY_SERVE)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(TINY_SERVE, device="cpu")
    return jm, jp, tm, bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def want(models):
    """PROMPTS' tokens through the JAX package's server."""
    jm, jp, _, _ = models
    srv = JaxServer(JaxEngine(jm, jp, **ENGINE), max_wait_ms=5.0,
                    pad_to=16).start()
    try:
        cli = JaxClient("127.0.0.1", srv.port)
        try:
            qids = [cli.submit(p) for p in PROMPTS]
            res = [cli.result(q, timeout=120) for q in qids]
        finally:
            cli.close()
    finally:
        srv.stop()
    assert [r.status for r in res] == ["ok"] * len(PROMPTS)
    return [list(r.tokens) for r in res]


def _engine(models, **kw):
    _, _, tm, tp = models
    return ServeEngine(tm, tp, device="cpu", **dict(ENGINE, **kw))


@pytest.fixture()
def server(models):
    eng = _engine(models)
    srv = TensorQueryServer(eng, max_wait_ms=5.0, pad_to=16).start()
    yield eng, srv
    srv.stop()


def _wait_until(cond, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def test_loopback_round_trip_matches_the_reference_server(server, want):
    eng, srv = server
    cli = TensorQueryClient("127.0.0.1", srv.port)
    try:
        qids = [cli.submit(p) for p in PROMPTS]
        for q, tokens in zip(qids, want):
            r = cli.result(q, timeout=120)
            assert r.status == "ok"
            assert list(r.tokens) == tokens
            # streamed deltas reassemble to the DONE sequence
            assert r.stream == tokens
            assert r.ttft_s is not None and r.ttft_s <= r.latency_s
    finally:
        cli.close()
    assert srv.src.n_requests == len(PROMPTS)
    _wait_until(lambda: not srv._routes, "routes to drain")
    s = eng.pool_stats()
    assert s["n_live"] == s["n_reserved"] == 0


def test_lanes_and_many_clients(server, want):
    """Three clients, lanes alternating, every query id 0 on its own
    connection: each gets the reference server's tokens."""
    eng, srv = server
    clients = [TensorQueryClient("127.0.0.1", srv.port) for _ in range(3)]
    try:
        subs = []
        for i, cli in enumerate(clients):
            for j in (i, i + 3):
                lane = "batch" if j % 2 else "interactive"
                subs.append((cli, j, cli.submit(PROMPTS[j], lane=lane)))
        for cli, j, q in subs:
            r = cli.result(q, timeout=120)
            assert r.status == "ok" and list(r.tokens) == want[j]
        assert [q for _, _, q in subs] == [0, 1] * 3
    finally:
        for cli in clients:
            cli.close()


def test_oversized_prompt_gets_an_error_frame(server, want):
    eng, srv = server
    cli = TensorQueryClient("127.0.0.1", srv.port)
    try:
        r = cli.result(cli.submit(np.ones(17, np.int32)), timeout=30)
        assert r.status == "error" and "outside" in r.error
        assert r.ttft_s is not None and r.latency_s is not None
        ok = cli.result(cli.submit(PROMPTS[0]), timeout=120)
        assert ok.status == "ok" and list(ok.tokens) == want[0]
    finally:
        cli.close()
    assert srv.src.n_rejected == 1


def test_cancel_mid_stream_returns_the_partial_tokens(models, want):
    """Once the first token is out, the engine is held until the cancel
    has landed, so the cancelled result carries exactly the tokens made
    before it: a prefix of the reference's, status "cancelled"."""
    eng = _engine(models, max_new_tokens=24)
    landed = threading.Event()
    real_step, real_cancel = eng.step, eng.cancel

    def step():
        if not landed.is_set() and any(s is not None and s.tokens
                                       for s in eng._slots):
            return []
        return real_step()

    def cancel(rid, status="cancelled"):
        try:
            return real_cancel(rid, status)
        finally:
            landed.set()
    eng.step, eng.cancel = step, cancel
    srv = TensorQueryServer(eng, max_wait_ms=5.0, pad_to=16).start()
    try:
        cli = TensorQueryClient("127.0.0.1", srv.port)
        try:
            qid = cli.submit(PROMPTS[1])
            _wait_until(lambda: cli._requests[qid].stream, "a token")
            cli.cancel(qid)
            r = cli.result(qid, timeout=60)
        finally:
            cli.close()
        assert r.status == "cancelled"
        assert 0 < len(r.tokens) < 24
        assert list(r.tokens) == want[1][:len(r.tokens)]
        assert eng.n_cancelled == 1
        s = eng.pool_stats()
        assert s["n_live"] == s["n_reserved"] == 0
    finally:
        srv.stop()


def test_credit_pauses_and_grant_flushes_in_order():
    """The port's connection: a credited route sends what its credit
    allows, pauses (never drops) the rest, and a grant flushes the paused
    frames in order."""
    a, b = socket.socketpair()
    conn = QueryConnection(a, ("unit", 0))
    try:
        conn.grant_credit(5, 1)
        tok = [pack_tensor(np.asarray([v], np.int32)) for v in (10, 11, 12)]
        assert conn.send_tokens(5, tok[0]) is True
        assert conn.send_tokens(5, tok[1]) == "paused"
        assert conn.send_tokens(5, tok[2]) == "paused"
        assert conn.n_paused_for(5) == 2 and conn.n_dropped == 0
        conn.grant_credit(5, 10)
        assert conn.n_paused_for(5) == 0
        got = [read_frame(b) for _ in range(3)]
        assert [f[0] for f in got] == [MSG_TOKENS] * 3
        assert [int(unpack_tensor(f[5])[0]) for f in got] == [10, 11, 12]
    finally:
        conn.close()
        b.close()


def test_credited_stream_over_the_wire_never_drops(server, want):
    """Credit 2 on the wire: the server pauses the rest of the stream,
    and the DONE frame flushes the paused tail ahead of itself, so the
    client sees every token without granting more."""
    eng, srv = server
    cli = TensorQueryClient("127.0.0.1", srv.port)
    try:
        _wait_until(lambda: len(srv.src.connections) == 1, "the connection")
        sconn = srv.src.connections[0]
        r = cli.result(cli.submit(PROMPTS[2], credit=2), timeout=120)
        assert r.status == "ok"
        assert r.stream == list(r.tokens) == want[2]
        assert sconn.n_paused >= 1 and sconn.n_dropped == 0
    finally:
        cli.close()


def test_drain_finishes_inflight_work_then_rejects(server, want):
    eng, srv = server
    cli = TensorQueryClient("127.0.0.1", srv.port)
    try:
        qids = [cli.submit(p) for p in PROMPTS[:3]]
        _wait_until(lambda: srv.src.n_requests == 3, "the requests")
        assert srv.drain(timeout=120.0) is True
        for q, tokens in zip(qids, want):
            r = cli.result(q, timeout=30)
            assert r.status == "ok" and list(r.tokens) == tokens
        late = cli.result(cli.submit(PROMPTS[3]), timeout=30)
        assert late.status == "error" and "draining" in late.error
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", srv.port), timeout=1.0)
    finally:
        cli.close()


def test_launcher_listen_smoke_with_lanes_on_cpu():
    """``--listen 0 --lanes interactive,batch``: every request served
    over loopback, ok and full length, each preempted request restored,
    the pool clean."""
    out = tserve.main(["--smoke", "--device", "cpu", "--listen", "0",
                       "--lanes", "interactive,batch"])
    eng, res = out["engine"], out["results"]
    assert out["n_results"] == 8 and out["total_tokens"] == 8 * 16
    assert [r.status for r in res] == ["ok"] * 8
    assert [r.lane for r in res] == ["interactive", "batch"] * 4
    assert eng.n_restores == eng.n_preemptions
    s = eng.pool_stats()
    assert s["n_live"] == s["n_reserved"] == 0


def test_launcher_standing_server_drains_on_sigterm():
    """``--listen 0`` without ``--smoke`` (a demo-size model) serves until
    SIGTERM, then
    drains: a request sent before the signal is answered, the process
    says "drain complete" and exits 0."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--family",
         "transformer", "--device", "cpu", "--listen", "0", "--max-new",
         "4"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True)
    reader.start()
    try:
        port = None
        while port is None:
            ln = lines.get(timeout=120)
            if "listening on 127.0.0.1:" in ln:
                port = int(ln.split("127.0.0.1:")[1].split()[0])
        cli = TensorQueryClient("127.0.0.1", port)
        try:
            r = cli.result(cli.submit(np.arange(1, 9, dtype=np.int32)),
                           timeout=120)
        finally:
            cli.close()
        assert r.status == "ok" and len(r.tokens) == 4
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
        reader.join(timeout=10)
        rest = []
        while not lines.empty():
            rest.append(lines.get())
        assert any("drain complete" in ln for ln in rest), rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
