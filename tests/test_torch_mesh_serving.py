"""Tensor-parallel paged serving in the port, on the CPU: every case of
``tests/test_mesh_serving.py`` over the four families of
``FAMILY_CFGS``, with meshes of repeated CPU devices.

The reference's contract: sharded decode is token-identical to the
single-device engine — greedy and seeded, through mid-decode joins,
prefix-shared COW forks and preemption spill/restore — and within one
mesh a preempted run's logits equal the undisturbed run's bit for bit.
That module skips where JAX sees one device, so here the port's mesh
engine is held to the reference's **single-device** tokens: the JAX
engine runs once per family (greedy), and every other case compares
against the port's ``mesh=None`` engine, which the other engine tests
hold to JAX.  Across mesh sizes the f32 logits may differ by rounding
(sharded sums reorder): within ``ATOL_MESH``.  Weights come from the
reference's ``init`` through the bridge, prompts from seeded numpy.
"""
import jax
import numpy as np
import pytest

from conftest import FAMILY_CFGS
from repro.models import build_model as jax_build_model
from repro.serving import ServeEngine as JaxEngine
from repro_torch import bridge, registry
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import build_model
from repro_torch.serving import ServeEngine
from repro_torch.single import SingleShot
from test_torch_dense import _port_cfg

# f32 logits, a mesh against no mesh: up to 2.5e-6 seen here, 9.1e-6 in
# test_torch_sharding.py (the smoke jamba over three ranks)
ATOL_MESH = 1e-5
TINY = FAMILY_CFGS["transformer"]
_PAIRS = {}


def _pair(family):
    """(jax model, jax params, port model, port params), built once."""
    if family not in _PAIRS:
        cfg = FAMILY_CFGS[family]
        jm = jax_build_model(cfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(_port_cfg(cfg), device="cpu")
        _PAIRS[family] = (jm, jp, tm,
                          bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu"))
    return _PAIRS[family]


def _mesh(n):
    return make_serving_mesh(model=n, devices=["cpu"] * n)


def _serve_all(make, prompts, *, preempt_rid=None, after_tokens=2):
    """The reference test's schedule: two prompts first, the rest two
    ticks in (so they join slots mid-decode), optionally preempting one
    request mid-decode.  ``make(**kw)`` builds the engine."""
    eng = make(batch_size=2, capacity=32, max_new_tokens=8, block_size=4,
               prefill_chunk=4)
    assert eng.paged
    for p in prompts[:2]:
        eng.submit(p, lane="batch")
    late, ticks = list(prompts[2:]), 0
    pending = preempt_rid is not None
    results = []
    while eng.has_work or late:
        ticks += 1
        if ticks == 3:
            for p in late:
                eng.submit(p, lane="batch")
            late = []
        if pending:
            for s in eng._slots:
                if s is None or s.rid != preempt_rid:
                    continue
                if (s.prefill_off >= len(s.prompt)
                        and len(s.tokens) >= after_tokens):
                    assert eng.preempt(preempt_rid)
                    pending = False
                break
        results += eng.step()
    assert not pending, "never caught the slot mid-decode"
    return eng, {r.request_id: r for r in results}


def _port(family, mesh=None, **kw):
    _, _, tm, tp = _pair(family)
    return lambda **k: ServeEngine(tm, tp, device="cpu", mesh=mesh,
                                   **k, **kw)


def _prompts(seed, n=5, vocab=TINY.vocab_size):
    rng = np.random.default_rng(seed)
    lengths = [4, 12, 6, 11, 8][:n]
    return [rng.integers(1, vocab, k).astype(np.int32) for k in lengths]


def _assert_same_results(ref, got, label):
    assert set(ref) == set(got)
    for rid in ref:
        assert got[rid].status == ref[rid].status == "ok", (label, rid)
        assert list(got[rid].tokens) == list(ref[rid].tokens), \
            f"{label}: rid {rid} tokens diverged"


def _assert_close_traces(ref_eng, eng, label):
    for rid, trace in ref_eng.logit_trace.items():
        other = eng.logit_trace[rid]
        assert len(trace) == len(other), (label, rid)
        for x, y in zip(trace, other):
            np.testing.assert_allclose(y, x, rtol=0, atol=ATOL_MESH,
                                       err_msg=f"{label}: rid {rid}")


# -- token identity: the four-family matrix ------------------------------

@pytest.mark.parametrize("family", list(FAMILY_CFGS))
def test_mesh2_token_identical_greedy(family):
    jm, jp, _, _ = _pair(family)
    prompts = _prompts(23)
    _, ref = _serve_all(lambda **k: JaxEngine(jm, jp, **k), prompts)
    eng, got = _serve_all(_port(family, _mesh(2)), prompts)
    _assert_same_results(ref, got, f"{family} mesh=2 greedy vs reference")
    assert eng.n_joins > 0          # identity held through mid-decode joins


@pytest.mark.parametrize("family", list(FAMILY_CFGS))
def test_mesh2_token_identical_sampled(family):
    """Sampler keys fold (seed, request, step): placement-independent,
    so seeded sampling matches across mesh sizes too."""
    prompts = _prompts(29)
    kw = dict(temperature=0.8, top_k=8, seed=3, trace_logits=True)
    ref_eng, ref = _serve_all(_port(family, **kw), prompts)
    eng, got = _serve_all(_port(family, _mesh(2), **kw), prompts)
    _assert_same_results(ref, got, f"{family} mesh=2 sampled")
    _assert_close_traces(ref_eng, eng, f"{family} mesh=2 sampled")


def test_mesh_sweep_transformer():
    """Every mesh size decodes the same tokens: N = 2 splits TINY's two
    KV heads, N = 4 gives each rank one q head over a replicated KV
    head."""
    prompts = _prompts(31)
    ref_eng, ref = _serve_all(_port("transformer", trace_logits=True),
                              prompts)
    for n in (2, 4):
        eng, got = _serve_all(_port("transformer", _mesh(n),
                                    trace_logits=True), prompts)
        _assert_same_results(ref, got, f"mesh={n}")
        _assert_close_traces(ref_eng, eng, f"mesh={n}")


@pytest.mark.parametrize("family,n", [(f, 2) for f in FAMILY_CFGS]
                         + [("transformer", 8)])
def test_mesh_generate_batch_matches_reference(family, n):
    """``generate_batch`` (one prefill, then dense decode steps) over the
    mesh gives the reference single-device engine's greedy tokens.  At
    N = 8 TINY's 4/2 heads leave four ranks without a head, which add a
    zero partial in prefill and decode."""
    jm, jp, tm, tp = _pair(family)
    prompts = np.random.default_rng(61).integers(
        1, FAMILY_CFGS[family].vocab_size, (2, 7)).astype(np.int32)
    kw = dict(batch_size=2, capacity=32, max_new_tokens=6)
    want = JaxEngine(jm, jp, **kw).generate_batch(prompts)
    eng = ServeEngine(tm, tp, device="cpu", mesh=_mesh(n), **kw)
    np.testing.assert_array_equal(eng.generate_batch(prompts),
                                  np.asarray(want))


# -- sharded engine behaviors --------------------------------------------

def test_mesh_prefix_share_cow_identity():
    """Prefix sharing and COW forks run unchanged over the mesh: block
    bookkeeping is the engine's, only the pool payload is per rank."""
    rng = np.random.default_rng(37)
    shared = rng.integers(1, TINY.vocab_size, 8).astype(np.int32)
    prompts = [np.concatenate(
                   [shared,
                    rng.integers(1, TINY.vocab_size, 3 + i).astype(np.int32)])
               for i in range(4)]
    _, ref = _serve_all(_port("transformer"), prompts)
    eng, got = _serve_all(_port("transformer", _mesh(2)), prompts)
    _assert_same_results(ref, got, "mesh=2 prefix-shared")
    assert eng.n_prefix_hits > 0 and eng.n_shared_tokens > 0
    # one slot that maps a retained partial tail page and forks it: the
    # fork copies the block on every rank
    a = rng.integers(0, TINY.vocab_size, 10).astype(np.int32)
    prompts = [a, a[:7].copy(), np.concatenate([a[:8], a[:3]])]
    _, _, tm, tp = _pair("transformer")
    kw = dict(batch_size=1, capacity=32, max_new_tokens=5, prefill_chunk=4,
              block_size=4, burst=2, device="cpu")
    ref = ServeEngine(tm, tp, **kw).serve(prompts)
    eng = ServeEngine(tm, tp, mesh=_mesh(2), **kw)
    got = eng.serve(prompts)
    assert [list(r.tokens) for r in got] == [list(r.tokens) for r in ref]
    assert eng.n_prefix_hits >= 2 and eng.n_cow_forks >= 1


@pytest.mark.parametrize("family", list(FAMILY_CFGS))
def test_mesh_preempt_restore(family):
    """Spill/restore takes every rank's part of the pages and slabs to
    host memory and back; the restored request matches the undisturbed
    run on the same mesh bit for bit and the single-device run in its
    tokens."""
    prompts = _prompts(41, n=2)
    mesh = _mesh(2)
    _, base = _serve_all(_port(family), prompts)
    ref_eng, ref = _serve_all(_port(family, mesh, trace_logits=True),
                              prompts)
    pre_eng, pre = _serve_all(_port(family, mesh, trace_logits=True),
                              prompts, preempt_rid=0)
    assert pre_eng.n_preemptions == 1 and pre_eng.n_restores == 1
    _assert_same_results(ref, pre, f"{family} mesh preempt")
    _assert_same_results(base, pre, f"{family} mesh-vs-single preempt")
    for rid, trace in ref_eng.logit_trace.items():
        other = pre_eng.logit_trace[rid]
        assert len(trace) == len(other), (family, rid)
        for step, (x, y) in enumerate(zip(trace, other)):
            assert np.array_equal(x, y), \
                f"{family}: rid {rid} logits diverged at step {step}"


@pytest.mark.parametrize("family", ["transformer", "hybrid"])
def test_mesh_params_and_pool_actually_sharded(family):
    """The mesh engine must not replicate everything: on every rank at
    least one weight leaf and one pool leaf are smaller than the whole
    model's, and the block budget counts one device's share."""
    _, _, tm, tp = _pair(family)
    ref_eng, _ = _serve_all(_port(family), _prompts(43, n=2))
    eng, _ = _serve_all(_port(family, _mesh(2)), _prompts(43, n=2))
    whole = dict(_leaves(tp))
    pool = dict(_leaves(ref_eng._paged_cache))
    for r in range(2):
        assert any(a.numel() < whole[k].numel()
                   for k, a in _leaves(eng.params[r])), r
        assert any(a.numel() < pool[k].numel()
                   for k, a in _leaves(eng._paged_cache[r])), r
    assert eng.kv_bytes_per_block() < ref_eng.kv_bytes_per_block()


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def test_mesh_steady_state_upload_parity():
    """Sharding must not degrade the decode loop: the mesh engine uploads
    slot state and runs device steps exactly as often as without."""
    prompts = _prompts(47)
    ref_eng, _ = _serve_all(_port("transformer"), prompts)
    mesh_eng, _ = _serve_all(_port("transformer", _mesh(2)), prompts)
    ref_ls, mesh_ls = ref_eng.loop_stats(), mesh_eng.loop_stats()
    assert mesh_ls["n_state_uploads"] == ref_ls["n_state_uploads"]
    assert mesh_ls["n_device_steps"] == ref_ls["n_device_steps"]


def test_mesh_requires_paged_mode_and_refuses_spec_and_int8():
    _, _, tm, tp = _pair("transformer")
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(tm, tp, device="cpu", batch_size=2, capacity=32,
                    max_new_tokens=4, paged=False, mesh=_mesh(2))
    with pytest.raises(NotImplementedError, match="int8' under mesh="):
        ServeEngine(tm, tp, device="cpu", kv_dtype="int8", mesh=_mesh(2))
    with pytest.raises(NotImplementedError, match="under mesh="):
        ServeEngine(tm, tp, device="cpu", spec_k=2, draft_model=tm,
                    draft_params=tp, mesh=_mesh(2))
    with pytest.raises(ValueError, match="have 1 device"):
        make_serving_mesh(model=2, devices=["cpu"])


def test_launcher_mesh2_on_cpu(capsys):
    out = tserve.main(["--smoke", "--device", "cpu", "--mesh", "2",
                       "--requests", "3",
                       "--batch", "2", "--max-new", "4", "--direct"])
    assert "serving over mesh {'data': 1, 'model': 2}" in capsys.readouterr().out
    assert out["engine"].model.mesh.size == 2
    assert out["n_results"] == 3


def test_singleshot_and_torch_sharded_equal_unsharded():
    """``SingleShot(framework="torch-sharded", mesh=)`` runs TINY's
    ``apply`` with its weights sharded over two and four CPU ranks (B2's
    contiguous entry per rank on the card): the logits equal the torch
    backend's within ``ATOL_MESH``, the aux loss exactly."""
    _, _, tm, tp = _pair("transformer")
    fwd = registry.ModelForward(tm, tp)
    tokens = np.random.default_rng(53).integers(
        0, TINY.vocab_size, (2, 12)).astype(np.int32)
    ref_logits, ref_aux = SingleShot(fn=fwd, framework="torch",
                                     device="cpu").invoke(tokens)
    for n in (2, 4):
        logits, aux = SingleShot(fn=fwd, framework="torch-sharded",
                                 mesh=_mesh(n)).invoke(tokens)
        np.testing.assert_allclose(logits, ref_logits, rtol=0,
                                   atol=ATOL_MESH)
        assert aux == ref_aux


def test_torch_sharded_callable_equals_unsharded_or_refuses():
    """A callable under ``torch-sharded`` computes what the reference's
    ``jit(fn, in_shardings, out_shardings)`` does, ``fn`` of the global
    arrays: over two and four ranks, functions that mix the rows a spec
    splits (a centring, a column sum, a product) equal the unsharded
    ``torch`` backend on the same inputs, with every output named or
    with ``out_shardings=None`` (a split input and no output axis, which
    ``jit`` accepts).  Shardings that do not fit the arrays or the mesh,
    a split dimension that the ranks do not divide included, raise
    ``ValueError`` as ``jit`` does."""
    rng = np.random.default_rng(59)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    w = rng.standard_normal((4, 8)).astype(np.float32)

    def fn(a, b):
        return a - a.mean(0), a.sum(0), a @ b
    want = SingleShot(fn=fn, framework="torch", device="cpu").invoke(x, w)
    for n in (2, 4):
        for out in (("model",), None, [("model", None), None,
                                       ("model",)]):
            got = SingleShot(fn=fn, framework="torch-sharded",
                             mesh=_mesh(n),
                             in_shardings=(("model", None), None),
                             out_shardings=out).invoke(x, w)
            for g, v in zip(got, want):
                np.testing.assert_array_equal(g, v)
    whole = SingleShot(fn=lambda a: a.sum(0), framework="torch-sharded",
                       mesh=_mesh(2)).invoke(x)
    np.testing.assert_array_equal(whole, want[1])
    for ins, out, match in (
            ((("model", None),) * 3, None, "3 in_shardings for 2 arrays"),
            ((("model", None, None), None), None, "rank 2"),
            (None, [None, None], "2 out_shardings for 3 arrays"),
            (None, [None, ("model", None), None], "rank 1")):
        with pytest.raises(ValueError, match=match):
            SingleShot(fn=fn, framework="torch-sharded", mesh=_mesh(2),
                       in_shardings=ins, out_shardings=out).invoke(x, w)
    for ins, out, args in (((("model", None), None), None, (x[:7], w)),
                           (None, [None, None, (None, "model")],
                            (x, w[:, :6]))):
        with pytest.raises(ValueError, match="not divisible by 4"):
            SingleShot(fn=fn, framework="torch-sharded", mesh=_mesh(4),
                       in_shardings=ins, out_shardings=out).invoke(*args)
    with pytest.raises(ValueError, match="not an axis of the mesh"):
        SingleShot(fn=fn, framework="torch-sharded", mesh=_mesh(2),
                   in_shardings=(("expert", None), None))
