"""Fault plans, the paged restart, cancellation and per-request
isolation in the port, against the JAX reference, on the CPU.

Each scenario runs the same prompts and the same ``FaultPlan`` (faults
fire by arrival count, never by time) through the JAX engine and the
port's, and holds the port to the reference's tokens, statuses, error
prefixes, counters and pool accounting: after the run no block, no
reservation and no state slab is left over.  Weights come from the
reference's ``init`` through the bridge; prompts from a seeded numpy
generator.
"""
import time

import jax
import numpy as np
import pytest

from conftest import FAMILY_CFGS
from repro.models import build_model as jax_build_model
from repro.serving import CacheFullError as JaxCacheFull
from repro.serving import Fault as JaxFault
from repro.serving import FaultPlan as JaxPlan
from repro.serving import ServeEngine as JaxEngine
from repro_torch import bridge
from repro_torch.models import build_model
from repro_torch.serving import (CacheFullError, Fault, FaultPlan,
                                 ServeEngine, TensorQueryClient,
                                 TensorQueryServer)
from test_torch_dense import _port_cfg

COUNTERS = ("n_restarts", "n_step_failures", "n_preemptions", "n_restores",
            "n_expired", "n_cancelled", "n_evictions", "n_prefills")
_PAIRS = {}


def _pair(family):
    if family not in _PAIRS:
        cfg = FAMILY_CFGS[family]
        jm = jax_build_model(cfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(_port_cfg(cfg), device="cpu")
        _PAIRS[family] = (jm, jp, tm,
                          bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu"))
    return _PAIRS[family]


def _plans(*faults):
    """The same plan for each package: faults as (point, kwargs), with
    ``exc="cachefull"`` naming each package's CacheFullError."""
    out = []
    for fault_cls, plan_cls, full in ((JaxFault, JaxPlan, JaxCacheFull),
                                      (Fault, FaultPlan, CacheFullError)):
        fs = []
        for point, kw in faults:
            kw = dict(kw)
            if kw.get("exc") == "cachefull":
                kw["exc"] = full
            fs.append(fault_cls(point=point, **kw))
        out.append(plan_cls(fs))
    return out


def _engines(family="transformer", faults=(), **kw):
    jm, jp, tm, tp = _pair(family)
    kw = dict(dict(batch_size=2, capacity=32, max_new_tokens=4,
                   block_size=4, num_blocks=8, prefill_chunk=16), **kw)
    jplan, tplan = _plans(*faults) if faults else (None, None)
    return (JaxEngine(jm, jp, fault_plan=jplan, **kw),
            ServeEngine(tm, tp, device="cpu", fault_plan=tplan, **kw))


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    vocab = FAMILY_CFGS["transformer"].vocab_size
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lengths]


def _run(eng, timeout=120.0):
    """Step until the engine drains; every result it recorded, by rid
    (requests failed at admission or expired are not in ``step()``'s
    return, only in the engine's results)."""
    deadline = time.monotonic() + timeout
    while eng.has_work and time.monotonic() < deadline:
        eng.step()
    assert not eng.has_work, "engine did not drain in time"
    with eng._results_cv:
        out = dict(sorted(eng._results.items()))
        eng._results.clear()
    return out


def _pool(eng):
    s = eng.pool_stats()
    return {k: s.get(k) for k in ("n_free", "n_live", "n_reserved",
                                  "n_retained", "n_table", "n_state_live")}


def _assert_clean(eng):
    s = eng.pool_stats()
    assert s["n_free"] + s["n_live"] == s["num_blocks"], s
    assert s["n_live"] == s["n_reserved"] == 0, s
    assert s.get("n_state_live", 0) == 0, s


def _assert_same(je, jr, te, tr):
    assert sorted(tr) == sorted(jr)
    for rid in jr:
        a, b = jr[rid], tr[rid]
        assert (b.status, b.error) == (a.status, a.error), rid
        np.testing.assert_array_equal(b.tokens, a.tokens)
    for name in COUNTERS:
        assert getattr(te, name) == getattr(je, name), name
    assert _pool(te) == _pool(je)


@pytest.mark.parametrize("family,kv_dtype", [
    ("transformer", None), ("hybrid", None), ("transformer", "int8")])
def test_engine_step_fault_restarts_and_respills_survivors(family, kv_dtype):
    """The 6th step raises mid-decode: survivors are spilled through the
    preemption path, the pools rebuilt, and both requests finish with the
    tokens of a run without the fault, as in the reference."""
    kw = dict(max_new_tokens=6, capacity=48, num_blocks=12,
              kv_dtype=kv_dtype)
    je, te = _engines(family, [("engine_step", dict(nth=6))], **kw)
    prompts = _prompts(5, (6, 9))
    outs = []
    for eng in (je, te):
        for p in prompts:
            eng.submit(p)
        outs.append(_run(eng))
    _assert_same(je, outs[0], te, outs[1])
    assert te.n_restarts == te.n_step_failures == 1
    assert te.n_preemptions == 2 and te.n_restores == 2
    _assert_clean(te)
    _, clean = _engines(family, **kw)
    plain = clean.serve(prompts)
    for r in plain:
        assert outs[1][r.request_id].status == "ok"
        np.testing.assert_array_equal(outs[1][r.request_id].tokens, r.tokens)


def test_failed_step_with_slabs_ahead_fails_recurrent_slots_alone():
    """A paged step that fails after the mamba slabs were updated in place
    leaves them ahead of the host mirror: the restart fails those
    decoding slots with "lost in engine restart" (their spill would not
    restore them) and still serves the queued request."""
    _, te = _engines("hybrid", max_new_tokens=6, capacity=48, num_blocks=12,
                     batch_size=1)
    a, b = _prompts(7, (6, 5))
    rid_a, rid_b = te.submit(a), te.submit(b)
    while not (te._slots[0] is not None and te._slots[0].tokens):
        te.step()
    real = te._burst_fn

    def fail_after(*args, **kw):
        real(*args, **kw)
        te._burst_fn = real
        raise RuntimeError("injected after the slab update")
    te._burst_fn = fail_after
    res = _run(te)
    assert res[rid_a].status == "error"
    assert res[rid_a].error == "lost in engine restart"
    assert res[rid_b].status == "ok" and len(res[rid_b].tokens) == 6
    assert te.n_restarts == 1 and te.n_preemptions == 0
    _assert_clean(te)


def test_engine_wedged_past_restart_budget_fails_everything_and_recovers():
    """Two consecutive step faults with max_restarts=1: the first is
    absorbed, the second fails every request with "engine wedged ..."
    and re-raises; once the storm passes the engine serves again."""
    je, te = _engines(faults=[("engine_step",
                               dict(nth=1, times=2, msg="hbm parity storm"))],
                      max_restarts=1)
    first, later = _prompts(8, (5, 7))
    outs = []
    for eng in (je, te):
        rid = eng.submit(first)
        assert eng.step() == []
        with pytest.raises(RuntimeError, match="hbm parity storm"):
            eng.step()
        res = {rid: eng._results.pop(rid)}
        assert res[rid].status == "error"
        assert res[rid].error == "engine wedged after 1 restarts: " \
                                 "hbm parity storm"
        eng.submit(later)
        res.update(_run(eng))
        outs.append(res)
    _assert_same(je, outs[0], te, outs[1])
    assert [r.status for r in outs[1].values()] == ["error", "ok"]
    _assert_clean(te)


def test_admission_cachefull_storm_keeps_candidate_queued():
    """Three CacheFullError trips of the fit check park the candidate;
    it admits once the storm passes and completes as in the reference."""
    je, te = _engines(faults=[("admit", dict(nth=1, times=3, exc="cachefull",
                                             msg="injected storm"))])
    (prompt,) = _prompts(6, (6,))
    outs = []
    for eng in (je, te):
        eng.submit(prompt)
        outs.append(_run(eng))
    _assert_same(je, outs[0], te, outs[1])
    assert te.fault_plan.arrivals("admit") == je.fault_plan.arrivals("admit")
    assert te.fault_plan.arrivals("admit") > 3
    assert outs[1][0].status == "ok"
    _assert_clean(te)


@pytest.mark.parametrize("inject", ["fault_plan", "match"])
def test_admission_failure_fails_only_its_candidate(inject, monkeypatch):
    """A fit that raises anything but CacheFullError is the candidate's
    own fault: it ends with status "error" and "admission failed: ...",
    and the scan goes on, so the other requests are served with the
    tokens of the reference.  Injected through the ``admit`` seam, or as
    an exception from the prefix match of one request."""
    faults = [("admit", dict(nth=2, exc=ValueError, msg="poison fit"))] \
        if inject == "fault_plan" else []
    je, te = _engines(faults=faults, batch_size=3, num_blocks=24)
    prompts = _prompts(9, (5, 6, 7))
    outs = []
    for eng in (je, te):
        if inject == "match":
            real = eng._match_prefix_cached

            def match(req, real=real):
                if req.rid == 1:
                    raise ValueError("poison fit")
                return real(req)
            monkeypatch.setattr(eng, "_match_prefix_cached", match)
        for p in prompts:
            eng.submit(p)
        outs.append(_run(eng))
    _assert_same(je, outs[0], te, outs[1])
    assert [r.status for r in outs[1].values()] == ["ok", "error", "ok"]
    assert outs[1][1].error == "admission failed: poison fit"
    assert te.n_step_failures == 0
    _assert_clean(te)


def test_cancel_queued_and_mid_decode():
    """One request cancelled while queued (no tokens), one mid-decode
    after two tokens (its partial tokens kept): both engines end them as
    "cancelled", free every block and retire the registrations of the
    cancelled request's full pages."""
    je, te = _engines(max_new_tokens=8, capacity=48, num_blocks=10,
                      batch_size=1)
    prompts = _prompts(4, (8, 6))
    outs = []
    for eng in (je, te):
        rid, queued = eng.submit(prompts[0]), eng.submit(prompts[1])
        while not any(s is not None and len(s.tokens) >= 2
                      for s in eng._slots):
            eng.step()
        assert eng.cancel(queued) and eng.cancel(rid)
        assert not eng.cancel(rid)
        res = {r: eng._results.pop(r) for r in (rid, queued)}
        assert not eng.has_work
        outs.append(res)
        s = eng.pool_stats()
        assert s["n_live"] == s["n_retained"] == s["n_table"] == 0
    _assert_same(je, outs[0], te, outs[1])
    assert [r.status for r in outs[1].values()] == ["cancelled"] * 2
    assert 2 <= len(outs[1][0].tokens) < 8 and len(outs[1][1].tokens) == 0
    _assert_clean(te)


def _meta_rows(prompts, lanes):
    """A pipeline micro-batch: prompts left-padded to the longest, with
    the tensor-query metas the server's pass_meta filter forwards."""
    width = max(len(p) for p in prompts)
    rows = np.stack([np.pad(p, (width - len(p), 0)) for p in prompts])
    metas = [{"query": {"prompt_len": len(p), "lane": lane}}
             for p, lane in zip(prompts, lanes)]
    return rows, metas


@pytest.mark.parametrize("point", ["submit", "worker"])
def test_submit_and_worker_faults_fail_only_their_rows(point):
    """Through ``as_pipeline_filter(use_meta=True)``: a ``submit`` fault
    fails its row alone, a ``worker`` fault fails the batch it hit; the
    metas carry status, error and n_tokens as in the reference, the next
    batch is served, and the pool is clean."""
    je, te = _engines(faults=[(point, dict(nth=2 if point == "submit" else 1,
                                           msg="poison"))], batch_size=3,
                      num_blocks=24)
    batches = [_prompts(10, (5, 7, 4)), _prompts(11, (6, 3))]
    outs = []
    for eng in (je, te):
        fn = eng.as_pipeline_filter(use_meta=True, timeout_s=120)
        got = []
        for prompts in batches:
            rows, metas = _meta_rows(prompts, ["interactive", "batch",
                                               "interactive"])
            out = fn(rows, metas)
            got.append((out, [{k: m[k] for k in ("status", "n_tokens",
                                                  "error") if k in m}
                              for m in metas]))
        outs.append(got)
    for (jo, jm), (to, tm) in zip(*outs):
        np.testing.assert_array_equal(to, jo)
        assert tm == jm
    first = [m["status"] for m in outs[1][0][1]]
    assert first == (["ok", "error", "ok"] if point == "submit"
                     else ["error"] * 3)
    assert all(m["error"] == "poison" for m in outs[1][0][1]
               if m["status"] == "error")
    assert [m["status"] for m in outs[1][1][1]] == ["ok", "ok"]
    _assert_clean(te)


def test_chaos_storm_keeps_the_pool_invariant():
    """Poison rows (every 5th submit) and cancels land between healthy
    requests on the port's server: every query ends ok, error or
    cancelled, errors are the poison's, ok rows that were not cancelled
    carry the reference engine's tokens, and afterwards the pool
    balances and the route table is empty."""
    _, _, tm, tp = _pair("transformer")
    plan = FaultPlan([Fault(point="submit", every=5, msg="storm poison")])
    eng = ServeEngine(tm, tp, device="cpu", batch_size=2, capacity=32,
                      max_new_tokens=4, block_size=4, num_blocks=10,
                      prefill_chunk=16, fault_plan=plan)
    rng = np.random.default_rng(11)
    vocab = FAMILY_CFGS["transformer"].vocab_size
    prompts = [rng.integers(1, vocab, int(rng.integers(4, 10)))
               .astype(np.int32) for _ in range(12)]
    jm, jp, _, _ = _pair("transformer")
    want = JaxEngine(jm, jp, batch_size=2, capacity=32, max_new_tokens=4,
                     block_size=4, num_blocks=10).serve(prompts)
    srv = TensorQueryServer(eng, max_wait_ms=5.0, pad_to=16,
                            workers=2).start()
    try:
        cli = TensorQueryClient("127.0.0.1", srv.port)
        try:
            qids = [cli.submit(p) for p in prompts]
            cancelled = set(qids[::4])
            for q in cancelled:
                cli.cancel(q)
            results = {q: cli.result(q, timeout=120) for q in qids}
        finally:
            cli.close()
        assert all(r.status in ("ok", "error", "cancelled")
                   for r in results.values())
        assert sum(r.status == "error" for r in results.values()) >= 1
        for q, r in results.items():
            if r.status == "error":
                assert "storm poison" in r.error
            elif r.status == "ok" and q not in cancelled:
                np.testing.assert_array_equal(r.tokens, want[q].tokens)
        deadline = time.monotonic() + 30
        while (srv._routes or eng.has_work) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not srv._routes and not srv._rev
        _assert_clean(eng)
    finally:
        srv.stop()
