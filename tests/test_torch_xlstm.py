"""The port's xLSTM blocks (mLSTM, sLSTM) and the xLSTM family through
the paged and dense engines, against the JAX reference, on the CPU.

Inputs come from a seeded numpy generator and weights from the
reference's ``init`` through the bridge, in f32.  The blocks' outputs
and carried states must match within 1e-5 (a few f32 ulps of values of
order 1: torch's and XLA's exp, log-sigmoid and reductions differ in
their last bits); the engines' greedy token streams, statuses,
scheduler and loop counters and pool statistics must be equal.  The
reference is not bitwise self-consistent for xLSTM (its paged and dense
logits differ in the last bits, ROADMAP Queue C), so logits are held to
a tolerance, never to bits.  The narrowed bf16 rule: a bf16 xLSTM
serves over the default f32 ``cache_dtype`` in both packages (its
carries are f32 whatever the cache type), and a bf16 attention stack
over an f32 pool is still refused by the port and fails in the
reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAMILY_CFGS, TINY_SERVE
from repro.models import build_model as jax_build_model
from repro.models import xlstm as JX
from repro.serving import ServeEngine as JaxEngine
from repro_torch import bridge
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models import xlstm as TX
from repro_torch.serving import ServeEngine
from test_torch_dense import _port_cfg

ATOL = 1e-5          # block outputs and states, f32
ATOL_LOGITS = 1e-4   # per-step logits through a 4-layer stack, f32
CFG = FAMILY_CFGS["xlstm"]          # d 32, 4 heads, mLSTM, sLSTM, x2
TCFG = _port_cfg(CFG)
COUNTERS = ("n_prefills", "n_joins", "n_evictions", "n_prefill_chunks",
            "n_requests", "n_batches")
LOOP = ("n_bursts", "n_device_steps", "n_host_syncs", "n_burst_early_exits",
        "n_state_uploads")
_PAIR = []


@pytest.fixture(scope="module")
def blocks():
    """One mLSTM and one sLSTM block's weights from the reference, as
    numpy (the reference's side) and tensors (the port's)."""
    pm = jax.tree.map(np.asarray, JX.mlstm_params(jax.random.PRNGKey(1),
                                                  CFG, jnp.float32))
    ps = jax.tree.map(np.asarray, JX.slstm_params(jax.random.PRNGKey(2),
                                                  CFG, jnp.float32))
    return {"mlstm": (pm, bridge.to_torch(pm, "cpu")),
            "slstm": (ps, bridge.to_torch(ps, "cpu"))}


def _pair():
    """(jax model, jax params, port model, port params), built once."""
    if not _PAIR:
        jm = jax_build_model(CFG)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(TCFG, device="cpu")
        _PAIR.extend([jm, jp, tm,
                      bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")])
    return _PAIR


def _x(seed, B, S):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, CFG.d_model)).astype(np.float32)


def _carry(seed, block, B):
    """A carried state as a served slab holds one: m finite, n > 0."""
    rng = np.random.default_rng(seed)
    di, H, dh = TX._dims(TCFG)
    if block == "mlstm":
        shapes = ((B, H, dh, dh), (B, H, dh), (B, H))
    else:
        shapes = ((B, di),) * 4
    out = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    out[-2] = np.abs(out[-2]) + 0.5          # n
    return tuple(out)


def _close(want, got, atol=ATOL):
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol,
                                   rtol=0)


@pytest.mark.parametrize("S", [1, 9, 64, 70])
@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_forward_matches_reference(blocks, block, S):
    """A whole prompt from zero state, S = 1, under a chunk, one chunk,
    and past it (70 = 64 + 6: the last chunk padded as the reference
    pads it, which the sLSTM state runs through)."""
    jp, tp = blocks[block]
    x = _x(S, 3, S)
    jfwd = JX.mlstm_forward if block == "mlstm" else JX.slstm_forward
    tfwd = TX.mlstm_forward if block == "mlstm" else TX.slstm_forward
    jy, js = jfwd(jp, CFG, jnp.asarray(x))
    ty, ts = tfwd(tp, TCFG, torch.from_numpy(x))
    _close((jy,) + tuple(js), (ty,) + tuple(ts))


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_paged_step_matches_reference(blocks, block, T):
    """From a carried state, rows consuming T, some and none (t_valid 0:
    the row's state must come back unchanged) of the step's T tokens."""
    jp, tp = blocks[block]
    B = 4
    x = _x(10 + T, B, T)
    state = _carry(T, block, B)
    t_valid = np.array([T, max(T - 2, 1), 0, 1], np.int32)
    jstep = JX.mlstm_paged_step if block == "mlstm" else JX.slstm_paged_step
    tstep = TX.mlstm_paged_step if block == "mlstm" else TX.slstm_paged_step
    jy, js = jstep(jp, CFG, jnp.asarray(x), tuple(map(jnp.asarray, state)),
                   jnp.asarray(t_valid))
    ty, ts = tstep(tp, TCFG, torch.from_numpy(x),
                   tuple(map(torch.from_numpy, state)),
                   torch.from_numpy(t_valid))
    _close(js, ts)
    for b in range(B):                       # outputs past t_valid: garbage
        n = int(t_valid[b])
        np.testing.assert_allclose(ty[b, :n].numpy(), np.asarray(jy)[b, :n],
                                   atol=ATOL, rtol=0)
    for a, s in zip(ts, state):
        np.testing.assert_array_equal(a[2].numpy(), s[2])


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_decode_matches_reference(blocks, block):
    """One token from a carried state: ``*_decode`` as the reference's."""
    jp, tp = blocks[block]
    x = _x(21, 3, 1)
    state = _carry(22, block, 3)
    jdec = JX.mlstm_decode if block == "mlstm" else JX.slstm_decode
    tdec = TX.mlstm_decode if block == "mlstm" else TX.slstm_decode
    jy, js = jdec(jp, CFG, jnp.asarray(x), tuple(map(jnp.asarray, state)))
    ty, ts = tdec(tp, TCFG, torch.from_numpy(x),
                  tuple(map(torch.from_numpy, state)))
    _close((jy,) + tuple(js), (ty,) + tuple(ts))


def test_init_tree_and_layer_pattern():
    """The port's init builds the reference's tree (f32 ``w_if``, ``b_if``,
    ``R`` and ``b`` inside a bf16 model, no ``norm2``/``mlp`` in an xLSTM
    sub-layer), and the pattern is (every-1) mLSTM then one sLSTM."""
    cfg = CFG.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = jax.tree.map(np.asarray,
                      jax_build_model(cfg).init(jax.random.PRNGKey(1)))
    tp = bridge.to_torch(jp, "cpu")
    tm = build_model(_port_cfg(cfg), device="cpu")
    own = tm.init(seed=0)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, tp))
    for o, t in zip(jax.tree.leaves(own), jax.tree.leaves(tp)):
        assert o.shape == t.shape and o.dtype == t.dtype
    assert tm.period_descs == [("mlstm", "none"), ("slstm", "none")]
    assert set(own["blocks"]["s0"]) == {"norm1", "mlstm"}
    for leaf in ("w_if", "b_if"):
        assert own["blocks"]["s0"]["mlstm"][leaf].dtype == torch.float32
    for leaf in ("R", "b"):
        assert own["blocks"]["s1"]["slstm"][leaf].dtype == torch.float32
    assert own["blocks"]["s0"]["mlstm"]["wq"].dtype == torch.bfloat16
    assert tm.supports_paged() and tm.has_recurrent_state()
    assert not tm.has_cache_typed_state()
    assert not tm.supports_prefix_sharing() and not tm.supports_speculative()


def test_paged_step_logits_and_slabs_match():
    """Chunked prefill then decode through the model's paged step, three
    slots on permuted slabs (one spare), a slot idle for a step and one
    starting late: logits and the owned slab rows within tolerance; the
    unowned slab stays zero, the dump row is the port's extra last row."""
    jm, jp, tm, tp = _pair()
    nb, bs, P, chunk, ns = 20, 4, 5, 4, 4
    jc = jm.init_paged_cache(nb, bs, dtype=jnp.float32, num_state_slots=ns)
    tc = tm.init_paged_cache(nb, bs, dtype=torch.float32, num_state_slots=ns)
    rng = np.random.default_rng(7)
    pt = np.stack([rng.permutation(nb)[:P] for _ in range(3)]).astype(np.int32)
    slabs = np.array([2, 0, 3], np.int32)
    prompts = [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
               for n in (9, 6, 5)]
    start = (0, 0, 2)
    lengths = np.zeros(3, np.int32)
    step = jax.jit(jm.paged_step)
    nxt = np.zeros(3, np.int64)
    for it in range(7):
        tokens = np.zeros((3, chunk), np.int32)
        t_valid = np.zeros(3, np.int32)
        for b, pr in enumerate(prompts):
            if it < start[b] or (it == 1 and b == 1):
                continue
            if lengths[b] < len(pr):
                n = min(chunk, len(pr) - lengths[b])
                tokens[b, :n] = pr[lengths[b]:lengths[b] + n]
                t_valid[b] = n
            else:
                tokens[b, 0] = nxt[b]
                t_valid[b] = 1
        if it >= 5:
            tokens = tokens[:, :1]
            assert (t_valid == 1).all()
        args = (tokens, pt, lengths, t_valid, slabs)
        jl, jc = step(jp, jc, *map(jnp.asarray, args))
        tl, tc = tm.paged_step(tp, tc, *map(torch.from_numpy, args))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=ATOL_LOGITS, rtol=0,
                                   err_msg=f"step {it}")
        nxt = np.asarray(jl).argmax(-1)
        lengths = lengths + t_valid
    for j in range(len(tm.period_descs)):
        for key, ja in jc["blocks"][f"s{j}"].items():
            ta = tc["blocks"][f"s{j}"][key].numpy()
            assert ta.dtype == np.float32 and ta.shape[1] == ns + 1
            np.testing.assert_allclose(ta[:, slabs], np.asarray(ja)[:, slabs],
                                       atol=ATOL_LOGITS, rtol=0)
            np.testing.assert_array_equal(ta[:, 1], 0)


def _serve_both(prompts, **kw):
    jm, jp, tm, tp = _pair()
    je = JaxEngine(jm, jp, **kw)
    te = ServeEngine(tm, tp, device="cpu", **kw)
    jr = je.serve(prompts)
    tr = te.serve(prompts)
    assert [r.status for r in tr] == [r.status for r in jr] \
        == ["ok"] * len(prompts)
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    for n in COUNTERS:
        assert getattr(te, n) == getattr(je, n), n
    jl, tl = je.loop_stats(), te.loop_stats()
    for n in LOOP:
        assert tl[n] == jl[n], n
    if te.paged:
        ts, js = te.pool_stats(), je.pool_stats()
        assert ts == js
    else:
        assert te.pool_stats() is je.pool_stats() is None
    return je, te


@pytest.mark.parametrize("burst", [1, 4])
@pytest.mark.parametrize("paged", [True, False])
def test_greedy_streams_match_reference(paged, burst):
    """Five requests on two slots (joins mid-decode), prompts longer than
    the prefill chunk, paged and dense, bursts of 1 and 4."""
    prompts = [np.random.default_rng(burst).integers(
        0, CFG.vocab_size, n).astype(np.int32) for n in (9, 3, 14, 6, 11)]
    kw = dict(batch_size=2, capacity=32, max_new_tokens=7, burst=burst,
              paged=paged)
    if paged:
        kw.update(prefill_chunk=4, block_size=4)
    _, te = _serve_both(prompts, **kw)
    assert te.paged == paged
    if paged:
        assert te.n_joins > 0 and not te.share_prefix
        assert te.pool_stats()["n_state_live"] == 0


def test_fewer_state_slabs_than_slots_queue_and_recycle():
    """Two slabs for three slots: admission waits for a slab and every
    recycled slab is blanked on its new owner's first step."""
    prompts = [np.random.default_rng(11).integers(
        0, CFG.vocab_size, n).astype(np.int32) for n in (7, 5, 9, 4, 6, 8)]
    _, te = _serve_both(prompts, batch_size=3, capacity=32,
                         max_new_tokens=5, prefill_chunk=4, block_size=4,
                         burst=2, num_state_slots=2)
    s = te.pool_stats()
    assert s["num_state_slots"] == 2 and s["n_state_free"] == 2


@pytest.mark.parametrize("paged", [True, False])
def test_bf16_xlstm_serves_over_an_f32_cache_dtype(paged):
    """The narrowed rule: a bf16 xLSTM over the default f32 cache_dtype
    serves in both packages (statuses ok, every request its tokens; the
    tokens themselves are not compared in bf16), its slabs stay f32; a
    bf16 attention stack over an f32 pool still raises in the port and
    fails in the reference."""
    cfg = CFG.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    prompts = [np.random.default_rng(3).integers(
        0, CFG.vocab_size, n).astype(np.int32) for n in (9, 3, 6)]
    kw = dict(batch_size=2, capacity=32, max_new_tokens=4, block_size=4,
              paged=paged)
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jr = JaxEngine(jm, jp, **kw).serve(prompts)
    tm = build_model(_port_cfg(cfg), device="cpu")
    te = ServeEngine(tm, bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu"),
                     device="cpu", **kw)
    assert te.cache_dtype == torch.float32
    tr = te.serve(prompts)
    for res in (jr, tr):
        assert [r.status for r in res] == ["ok"] * 3
        assert [len(r.tokens) for r in res] == [4] * 3
    cache = te._paged_cache if paged else te._cache
    assert all(a.dtype == torch.float32
               for st in cache["blocks"].values() for a in st.values())

    attn = TINY_SERVE.replace(param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    am = build_model(_port_cfg(attn), device="cpu")
    with pytest.raises(ValueError, match="kv_dtype='bf16'"):
        ServeEngine(am, am.init(seed=0), device="cpu", paged=paged)
    ajm = jax_build_model(attn)
    with pytest.raises(TypeError, match="carry"):
        JaxEngine(ajm, ajm.init(jax.random.PRNGKey(0)), max_restarts=0,
                  **kw).serve(prompts)


def test_launcher_refuses_speculation_for_xlstm():
    with pytest.raises(SystemExit, match="--family xlstm are incompatible"):
        tserve.main(["--device", "cpu", "--family", "xlstm", "--spec-k", "2"])
