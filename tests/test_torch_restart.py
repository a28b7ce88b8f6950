"""The port's bounded restart, ``cancel`` and ``inflight_rids`` against
the JAX reference, on the CPU.

The fault: a hybrid (mamba + attention) stack on the dense engine whose
prefill wave is shorter than ``d_conv - 1`` tokens seeds its conv window
with too few rows, and the first decode step fails, in both packages.
The reference's engine restarts (the wave's requests end with "lost in
engine restart", queued work is served) and, past ``max_restarts``
consecutive failures, fails everything with "engine wedged" and
re-raises; the port must end every request the same way.  Paged mode
restarts by spilling its survivors (``tests/test_torch_faults.py``) and,
past ``max_restarts``, raises as the dense mode does.
Weights come from the reference's ``init`` through the bridge; prompts
from a seeded numpy generator.
"""
import jax
import numpy as np
import pytest

from conftest import FAMILY_CFGS
from repro.models import build_model as jax_build_model
from repro.serving import ServeEngine as JaxEngine
from repro_torch import bridge
from repro_torch.models import build_model
from repro_torch.serving import ServeEngine
from test_torch_dense import _port_cfg

WEDGED = "engine wedged after 0 restarts: "


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params): the tiny hybrid
    stack (d_conv = 4), one weight set."""
    cfg = FAMILY_CFGS["hybrid"]
    assert cfg.ssm.d_conv == 4
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(_port_cfg(cfg), device="cpu")
    return jm, jp, tm, bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, FAMILY_CFGS["hybrid"].vocab_size, n)
            .astype(np.int32) for n in lengths]


def _engines(pair, **kw):
    jm, jp, tm, tp = pair
    kw = dict(batch_size=2, capacity=40, max_new_tokens=5, paged=False,
              **kw)
    return JaxEngine(jm, jp, **kw), ServeEngine(tm, tp, device="cpu", **kw)


def _assert_same_results(jr, tr):
    assert [r.request_id for r in tr] == [r.request_id for r in jr]
    for a, b in zip(jr, tr):
        assert (b.status, b.error) == (a.status, a.error), a.request_id
        np.testing.assert_array_equal(b.tokens, a.tokens)


def test_short_prefill_wave_restarts_like_the_reference(pair):
    """A wave of 1- and 2-token prompts fails its first decode step; both
    engines fail that wave's requests with "lost in engine restart",
    restart once, and serve the three queued prompts to the same tokens."""
    prompts = _prompts((2, 1, 7, 9, 6))
    je, te = _engines(pair)
    jr, tr = je.serve(prompts), te.serve(prompts)
    _assert_same_results(jr, tr)
    assert [r.status for r in tr] == ["error"] * 2 + ["ok"] * 3
    assert {r.error for r in tr[:2]} == {"lost in engine restart"}
    for attr in ("n_restarts", "n_step_failures", "_consec_failures",
                 "n_prefills", "n_evictions"):
        assert getattr(te, attr) == getattr(je, attr), attr
    assert te.n_restarts == te.n_step_failures == 1
    assert te._cache is not None and te.inflight_rids() == []


def test_past_the_restart_budget_everything_fails_and_raises(pair):
    """max_restarts=0: the first failure fails the in-flight wave and the
    queued prompts with "engine wedged after 0 restarts: <exception>"
    and re-raises, in both packages (the exception text is each
    framework's own)."""
    prompts = _prompts((2, 1, 7, 9, 6))
    je, te = _engines(pair, max_restarts=0)
    results = []
    for eng in (je, te):
        rids = [eng.submit(p) for p in prompts]
        with pytest.raises(Exception):
            eng.wait(rids)
        results.append([eng._results[r] for r in rids])
        assert eng.n_restarts == 0 and eng.n_step_failures == 1
        assert eng.inflight_rids() == [] and eng._cache is None
    for a, b in zip(*results):
        assert a.status == b.status == "error"
        assert a.error.startswith(WEDGED) and b.error.startswith(WEDGED)
        assert len(b.error) > len(WEDGED)
        np.testing.assert_array_equal(b.tokens, a.tokens)
    assert [len(r.tokens) for r in results[1]] == [1, 1, 0, 0, 0]


def test_paged_step_failure_still_raises(pair, monkeypatch):
    """Paged mode restarts a failing step (tests/test_torch_faults.py);
    past ``max_restarts`` it still raises, in both packages: max_restarts
    =0, a failing mixed step fails both in-flight requests with "engine
    wedged after 0 restarts: <exception>", re-raises, and leaves the
    pool clean."""
    jm, jp, tm, tp = pair
    kw = dict(batch_size=2, capacity=40, max_new_tokens=5, paged=True,
              max_restarts=0)
    out = []
    for eng in (JaxEngine(jm, jp, **kw),
                ServeEngine(tm, tp, device="cpu", **kw)):
        def fail(*a, **k):
            raise RuntimeError("injected step failure")
        monkeypatch.setattr(eng, "_mixed_fn", fail)
        rids = [eng.submit(p) for p in _prompts((6, 9))]
        with pytest.raises(RuntimeError, match="injected step failure"):
            eng.step()
        assert eng.n_step_failures == 1 and eng.n_restarts == 0
        assert eng.inflight_rids() == []
        stats = eng.pool_stats()
        assert stats["n_live"] == stats["n_reserved"] == 0
        assert stats["n_state_live"] == 0
        out.append([eng._results[r] for r in rids])
    for a, b in zip(*out):
        assert a.status == b.status == "error"
        assert (a.error == b.error
                == WEDGED + "injected step failure")
        np.testing.assert_array_equal(b.tokens, a.tokens)


def test_cancel_and_inflight_rids_match_the_reference(pair):
    """One queued and one in-flight request cancelled: both engines list
    the same live rids, cancel the same way (True, then False for a
    finished or unknown rid) and end with the same results."""
    prompts = _prompts((6, 8, 7), seed=3)
    je, te = _engines(pair)
    out = []
    for eng in (je, te):
        rids = [eng.submit(p) for p in prompts]
        eng.step()                       # admits two; the third queues
        live = eng.inflight_rids()
        flags = [eng.cancel(rids[2]), eng.cancel(rids[0]),
                 eng.cancel(rids[0]), eng.cancel(99)]
        after = eng.inflight_rids()
        res = eng.wait(rids)
        out.append((live, flags, after, res, eng.n_cancelled))
    (jl, jf, ja, jr, jn), (tl, tf, ta, tr, tn) = out
    assert tl == jl == [2, 0, 1]
    assert tf == jf == [True, True, False, False]
    assert ta == ja == [1]
    assert tn == jn == 2
    _assert_same_results(jr, tr)
    assert [r.status for r in tr] == ["cancelled", "ok", "cancelled"]
