"""Speculative draft-verify decoding in the port's paged engine, against
the JAX reference, on the CPU (the contracts of
``tests/test_speculative.py``, with its tiny target and 1-layer draft).

Weights come from the reference's ``init`` through the bridge (target
``PRNGKey(0)``, draft ``PRNGKey(1)``).  Token streams, statuses and the
speculative counters (rounds, proposals, acceptances, the accepted-length
histogram) are compared exactly; ``logits_to_probs`` within 1e-6 (a
softmax over 64 logits: f32 rounding of exp and of the sum, 6e-8 seen).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAMILY_CFGS, TINY_SERVE
from repro.launch import serve as jax_serve
from repro.models import build_model as jax_build_model
from repro.models.config import MoEConfig
from repro.serving import ServeEngine as JaxEngine
from repro.serving import logits_to_probs as jax_logits_to_probs
from repro.serving import spec_accept as jax_spec_accept
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.serving import ServeEngine, logits_to_probs, spec_accept
from repro_torch.serving.prng import fold_in, prng_key
from test_torch_sampling import port_cfg

PROBS_ATOL = 1e-6
TINY = TINY_SERVE.replace(arch_id="tiny-paged")
DRAFT = TINY.replace(arch_id="tiny-draft", n_layers=1, d_model=16,
                     n_heads=2, n_kv_heads=1, d_ff=32)
MOE = TINY.replace(arch_id="tiny-moe", family="moe",
                   moe=MoEConfig(n_experts=4, top_k=2, d_expert=48))
SPEC_STATS = ("spec_k", "n_spec_rounds", "n_spec_tokens",
              "n_draft_proposed", "n_draft_accepted", "spec_accept_hist",
              "spec_accept_rate", "n_bursts", "n_device_steps",
              "n_host_syncs", "n_burst_early_exits", "n_state_uploads")

_MODELS = {}


def models(cfg, seed):
    """(jax model, jax params, port model, port params), built once."""
    key = (cfg.arch_id, seed)
    if key not in _MODELS:
        jm = jax_build_model(cfg)
        jp = jm.init(jax.random.PRNGKey(seed))
        tm = build_model(port_cfg(cfg), device="cpu")
        _MODELS[key] = (jm, jp, tm,
                        bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu"))
    return _MODELS[key]


def _prompts(sizes=(5, 9, 3), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, TINY.vocab_size, n).astype(np.int32)
            for n in sizes]


def _engines(*, target=TINY, draft=DRAFT, spec_k=0, max_new=10, eos_id=None,
             temperature=0.0, top_k=None, seed=0, burst=4, batch_size=4,
             capacity=64):
    """The same engine on the reference and on the port."""
    jm, jp, tm, tp = models(target, 0)
    kw = dict(batch_size=batch_size, capacity=capacity,
              max_new_tokens=max_new, block_size=4, prefill_chunk=8,
              burst=burst, eos_id=eos_id, temperature=temperature,
              top_k=top_k, seed=seed, spec_k=spec_k)
    if spec_k:
        jd, jdp, td, tdp = models(draft, 1) if draft is not target \
            else models(draft, 0)
        je = JaxEngine(jm, jp, draft_model=jd, draft_params=jdp, **kw)
        te = ServeEngine(tm, tp, draft_model=td, draft_params=tdp,
                         device="cpu", **kw)
    else:
        je = JaxEngine(jm, jp, **kw)
        te = ServeEngine(tm, tp, device="cpu", **kw)
    return je, te


def _run(eng, prompts, *, join_after=None, preempt_at=None):
    """Submit on the batch lane and step until idle.  ``join_after``:
    submit every prompt but the first once request 0 holds that many
    tokens.  ``preempt_at``: preempt request 0 once it has decoded that
    many tokens.  The schedule depends on the step count alone, so both
    engines run the same one."""
    first = prompts[:1] if join_after else prompts
    for p in first:
        eng.submit(p, lane="batch")
    results, joined, preempted = [], not join_after, preempt_at is None
    while eng.has_work:
        for s in eng._slots:
            if s is None or s.rid != 0:
                continue
            if not joined and len(s.tokens) >= join_after:
                for p in prompts[1:]:
                    eng.submit(p, lane="batch")
                joined = True
            if not preempted and s.prefill_off >= len(s.prompt) \
                    and len(s.tokens) >= preempt_at:
                assert eng.preempt(0)
                preempted = True
        results += eng.step()
    assert joined and preempted
    out = {r.request_id: r for r in results}
    assert [out[i].status for i in range(len(prompts))] == \
        ["ok"] * len(prompts)
    return [list(map(int, out[i].tokens)) for i in range(len(prompts))]


def _both(prompts, run=None, **kw):
    """Run the reference and the port; tokens and loop stats equal."""
    je, te = _engines(**kw)
    run = run or {}
    want, got = _run(je, prompts, **run), _run(te, prompts, **run)
    assert got == want
    jl, tl = je.loop_stats(), te.loop_stats()
    for name in SPEC_STATS:
        assert tl.get(name) == jl.get(name), name
    for name in ("n_preemptions", "n_restores", "n_joins", "n_evictions"):
        assert getattr(te, name) == getattr(je, name), name
    return te, got


# -- the primitives ------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(temperature=0.0),
                                dict(temperature=0.7, top_k=5),
                                dict(temperature=1.3, top_k=None)])
def test_logits_to_probs_matches_reference(kw):
    rng = np.random.default_rng(3)
    logits = (np.round(rng.standard_normal((4, 6, 64)) * 4) / 4) \
        .astype(np.float32)
    want = np.asarray(jax_logits_to_probs(jnp.asarray(logits), **kw))
    got = logits_to_probs(torch.from_numpy(logits), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PROBS_ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=PROBS_ATOL)


@pytest.mark.parametrize("greedy", [False, True])
def test_spec_accept_matches_reference(greedy):
    """Fixed draft/target distributions, draft tokens drawn from the draft,
    per-row budgets in [0, G] and keys: ``emit`` and ``n_acc`` equal."""
    B, G, V = 512, 3, 16
    rng = np.random.default_rng(4)
    if greedy:
        p = np.eye(V, dtype=np.float32)[rng.integers(0, V, (B, G + 1))]
        q = np.eye(V, dtype=np.float32)[rng.integers(0, V, (B, G))]
        q[: B // 2] = p[: B // 2, :G]          # half the rows all agree
    else:
        p = rng.dirichlet(np.ones(V), size=(B, G + 1)).astype(np.float32)
        q = rng.dirichlet(np.ones(V), size=(B, G)).astype(np.float32)
    draft = np.stack([[rng.choice(V, p=q[b, j] / q[b, j].sum())
                       for j in range(G)] for b in range(B)]).astype(np.int32)
    budget = rng.integers(0, G + 1, B).astype(np.int32)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(7), i))(
        jnp.arange(B))
    emit_j, n_j = jax_spec_accept(jnp.asarray(draft), jnp.asarray(q),
                                  jnp.asarray(p), jnp.asarray(budget), keys,
                                  greedy=greedy)
    emit_t, n_t = spec_accept(
        torch.from_numpy(draft), torch.from_numpy(q), torch.from_numpy(p),
        torch.from_numpy(budget), fold_in(prng_key(7), torch.arange(B)),
        greedy=greedy)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(emit_t.numpy(), np.asarray(emit_j))
    assert 0 < int(n_t.sum()) < int(budget.sum())


def test_spec_accept_preserves_target_distribution():
    """The rejection rule itself: with proposals drawn from q, the emitted
    tokens are distributed as the target p (position 0 always, position 1
    over the rows that accepted their first draft)."""
    B, G, V = 20000, 3, 8
    rng = np.random.default_rng(0)
    p = rng.dirichlet(np.ones(V) * 1.5, size=G + 1)
    q = rng.dirichlet(np.ones(V) * 1.5, size=G)
    draft = np.stack([rng.choice(V, size=B, p=qj) for qj in q],
                     axis=1).astype(np.int32)
    emit, n_acc = spec_accept(
        torch.from_numpy(draft),
        torch.from_numpy(q.astype(np.float32))[None].expand(B, G, V),
        torch.from_numpy(p.astype(np.float32))[None].expand(B, G + 1, V),
        torch.full((B,), G, dtype=torch.int32),
        fold_in(prng_key(7), torch.arange(B)))
    emit, n_acc = emit.numpy(), n_acc.numpy()

    def tv(a, b):
        return 0.5 * float(np.abs(a - b).sum())
    assert tv(np.bincount(emit[:, 0], minlength=V) / B, p[0]) < 0.03
    sel = n_acc >= 1
    assert sel.sum() > 2000
    assert tv(np.bincount(emit[sel, 1], minlength=V) / sel.sum(),
              p[1]) < 0.05


# -- greedy token identity -----------------------------------------------------

@pytest.mark.parametrize("spec_k", [2, 4])
def test_spec_greedy_tokens_equal_nonspec_and_reference(spec_k):
    prompts = _prompts()
    _, ref = _both(prompts)
    te, got = _both(prompts, spec_k=spec_k)
    assert got == ref
    ls = te.loop_stats()
    assert ls["n_spec_rounds"] > 0 and ls["n_draft_proposed"] > 0


def test_spec_greedy_with_staggered_joins():
    """Requests join while request 0 is speculating (mixed prefill +
    in-flight rounds, the draft's deficit catch-up through the mixed
    step)."""
    prompts = _prompts((6, 9, 4), seed=5)
    _, ref = _both(prompts, run=dict(join_after=2))
    te, got = _both(prompts, run=dict(join_after=2), spec_k=3)
    assert got == ref and te.n_joins > 0


def test_spec_greedy_eos_truncation():
    """An eos inside the drafted prefix cuts the round where
    non-speculative decode stops."""
    prompts = _prompts((5, 7), seed=9)
    _, free = _both(prompts, max_new=12)
    eos = next(t[len(t) // 2] for t in free if len(t) > 2)
    _, ref = _both(prompts, max_new=12, eos_id=eos)
    _, got = _both(prompts, max_new=12, eos_id=eos, spec_k=4)
    assert got == ref and any(len(t) < 12 for t in got)


def test_spec_preempt_restore_mid_speculation():
    """A slot preempted mid-speculation spills both pools and the spec
    mirrors; its restored stream equals a never-preempted run."""
    prompts = _prompts((8, 6), seed=13)
    kw = dict(spec_k=3, max_new=8, batch_size=2, capacity=32, burst=2)
    _, ref = _both(prompts, **kw)
    te, got = _both(prompts, run=dict(preempt_at=2), **kw)
    assert got == ref
    assert te.n_preemptions == 1 and te.n_restores == 1
    assert te.allocator.n_free == te.allocator.num_blocks
    assert te._reserved == 0


def test_spec_self_draft_accepts_everything():
    prompts = _prompts((5, 8), seed=3)
    _, ref = _both(prompts)
    te, got = _both(prompts, draft=TINY, spec_k=4)
    assert got == ref
    ls = te.loop_stats()
    assert ls["n_draft_proposed"] > 0
    assert ls["n_draft_accepted"] == ls["n_draft_proposed"]
    assert ls["spec_accept_rate"] == 1.0


# -- sampled speculation -------------------------------------------------------

@pytest.mark.parametrize("target,draft", [(TINY, DRAFT), (MOE, MOE)],
                         ids=["dense", "moe_self_draft"])
def test_spec_sampled_tokens_equal_reference(target, draft):
    """Seeded speculative sampling: the draft draws, the accept uniforms
    and the resamples go through the same key streams as the reference's,
    so the tokens and counters are equal.  An MoE target gates
    T = spec_k + 1 tokens per row in its verify step (here it is its own
    draft, which routes T = 1 and 2 steps)."""
    prompts = _prompts((6, 9, 4, 7), seed=21)
    te, got = _both(prompts, target=target, draft=draft, spec_k=3,
                    temperature=0.7, top_k=4, seed=11, max_new=8)
    ls = te.loop_stats()
    assert 0 < ls["n_draft_accepted"] <= ls["n_draft_proposed"]
    assert sum(ls["spec_accept_hist"]) == ls["n_spec_rounds"]
    # the first token is drawn before any speculation, from the
    # (seed, rid, step) stream of the non-speculative sampler
    _, plain = _both(prompts, target=target, temperature=0.7, top_k=4,
                     seed=11, max_new=8)
    assert [t[0] for t in got] == [t[0] for t in plain]


def test_spec_loop_stats_keys():
    te, _ = _both(_prompts((5, 7), seed=2), spec_k=3)
    ls = te.loop_stats()
    assert ls["spec_k"] == 3 and len(ls["spec_accept_hist"]) == 4
    assert ls["n_spec_tokens"] >= ls["n_spec_rounds"]
    _, plain = _engines()
    assert "n_spec_rounds" not in plain.loop_stats()


# -- refusals ------------------------------------------------------------------

def _refusals(kw_jax, kw_port):
    with pytest.raises(Exception) as want:
        JaxEngine(**kw_jax)
    with pytest.raises(Exception) as got:
        ServeEngine(device="cpu", **kw_port)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["no_draft", "paged_off", "chunk_1",
                                  "share_prefix", "negative", "vocab"])
def test_spec_gating_errors_as_the_reference(case):
    jm, jp, tm, tp = models(TINY, 0)
    jd, jdp, td, tdp = models(DRAFT, 1)
    kw = {"no_draft": dict(spec_k=2),
          "paged_off": dict(paged=False, spec_k=2, draft=True),
          "chunk_1": dict(prefill_chunk=1, spec_k=2, draft=True),
          "share_prefix": dict(share_prefix=True, spec_k=2, draft=True),
          "negative": dict(spec_k=-1)}.get(case)
    if case == "vocab":
        odd = DRAFT.replace(arch_id="tiny-odd-vocab", vocab_size=32)
        _refusals(dict(model=jm, params=jp,
                       draft_model=jax_build_model(odd), draft_params={},
                       spec_k=2),
                  dict(model=tm, params=tp,
                       draft_model=build_model(port_cfg(odd), device="cpu"),
                       draft_params={}, spec_k=2))
        return
    d = kw.pop("draft", False)
    _refusals(dict(model=jm, params=jp, **kw,
                   **(dict(draft_model=jd, draft_params=jdp) if d else {})),
              dict(model=tm, params=tp, **kw,
                   **(dict(draft_model=td, draft_params=tdp) if d else {})))
    if case == "no_draft":
        eng = ServeEngine(tm, tp, device="cpu", draft_model=td,
                          draft_params=tdp, spec_k=2)
        assert eng.share_prefix is False


@pytest.mark.parametrize("family", ["mamba", "hybrid"])
@pytest.mark.parametrize("role", ["target", "draft"])
def test_spec_refused_for_recurrent_family(family, role):
    """Rollback is arithmetic on lengths; a recurrent slab advanced
    through rejected tokens cannot roll back.  Both roles are refused
    with the reference's message."""
    jm, jp, tm, tp = models(TINY, 0)
    jr = jax_build_model(FAMILY_CFGS[family])
    tr = build_model(port_cfg(FAMILY_CFGS[family]), device="cpu")
    if role == "target":
        jd, jdp, td, tdp = models(DRAFT, 1)
        _refusals(dict(model=jr, params={}, draft_model=jd,
                       draft_params=jdp, spec_k=2),
                  dict(model=tr, params={}, draft_model=td,
                       draft_params=tdp, spec_k=2))
    else:
        _refusals(dict(model=jm, params=jp, draft_model=jr,
                       draft_params={}, spec_k=2),
                  dict(model=tm, params=tp, draft_model=tr,
                       draft_params={}, spec_k=2))


@pytest.mark.parametrize("argv,match", [
    (["--spec-k", "2", "--mesh", "2"], "--spec-k and --mesh"),
    (["--spec-k", "2", "--share-prefix", "on"], "--spec-k and --share-prefix"),
    (["--spec-k", "2", "--family", "mamba"], "--spec-k and --family mamba"),
    (["--spec-k", "2", "--family", "hybrid"], "--spec-k and --family hybrid"),
    (["--spec-k", "2", "--family", "xlstm"], "--spec-k and --family xlstm"),
    (["--spec-k", "2", "--paged", "off"], "--spec-k and --paged off"),
    (["--kv-dtype", "int8", "--spec-k", "2", "--family", "transformer"],
     "--kv-dtype int8 and --spec-k")])
def test_launcher_refuses_spec_flag_pairs(argv, match):
    for mod in (jax_serve, tserve):
        with pytest.raises(SystemExit, match=match):
            mod.validate_args(mod.build_parser().parse_args(argv))
    tserve.validate_args(tserve.build_parser().parse_args(
        ["--spec-k", "2", "--family", "transformer"]))


def test_tiny_draft_of_smollm_heads_raises():
    """smollm-360m's 15 query heads over 5 KV heads halve to 7 over 5,
    which do not group (the reference fails that draft's first step with
    a reshape error); the port refuses it before making any weights."""
    with pytest.raises(ValueError, match="--draft-config"):
        tserve.draft_config(get_config("smollm-360m"), "tiny", smoke=False)
    with pytest.raises(ValueError, match="7 query heads over 5 KV heads"):
        tserve.main(["--device", "cpu", "--spec-k", "4"])
    # a tiny draft whose heads group is accepted
    assert tserve.draft_config(TINY, "tiny", smoke=False).n_heads == 2


def test_launcher_serves_spec_and_sampling_on_cpu(capsys):
    out = tserve.main(["--smoke", "--device", "cpu", "--direct",
                       "--requests", "4", "--batch", "2", "--max-new", "6",
                       "--prompt-len", "20", "--spec-k", "3",
                       "--temperature", "0.8", "--top-k", "50",
                       "--seed", "0"])
    assert out["n_results"] == 4 and out["total_tokens"] == 24
    text = capsys.readouterr().out
    assert "speculative decoding: K=3, draft" in text
    assert "speculative: K=3" in text
    eng = out["engine"]
    assert eng.loop_stats()["n_spec_rounds"] > 0 and not eng._greedy
