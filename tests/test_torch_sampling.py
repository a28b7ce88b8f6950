"""Seeded sampling in the port's engine, against the JAX reference, on
the CPU (the contracts of ``tests/test_sampling.py``, each held against
the reference on the same weights and prompts).

The key of slot ``b``'s ``t``-th token is ``fold_in(fold_in(
PRNGKey(seed), request_id), t)``, so a token stream is a function of
``(seed, request, step)`` only: paged == dense, any batch composition
or join timing, and the port == the reference (keys and uniforms are
bit for bit the reference's; its Gumbel noise differs by at most
4.8e-7, which flips a draw only where two perturbed logits lie that
close, and none of these streams has such a tie).  Token streams,
statuses and counters are compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAMILY_CFGS, TINY_SERVE
from repro.models import build_model as jax_build_model
from repro.models.config import MoEConfig
from repro.serving import ServeEngine as JaxEngine
from repro.serving import make_sampler_core as jax_sampler_core
from repro.serving import sample_logits as jax_sample_logits
from repro_torch import bridge
from repro_torch.models import build_model
from repro_torch.models import config as tconfig
from repro_torch.serving import (ServeEngine, make_sampler_core,
                                 sample_logits)
from repro_torch.serving.prng import fold_in, prng_key

CFGS = dict(FAMILY_CFGS, moe=TINY_SERVE.replace(
    arch_id="tiny-moe", family="moe",
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=48)))
SAMPLED = dict(temperature=0.8, top_k=16, seed=11)
COUNTERS = ("n_prefills", "n_joins", "n_evictions", "n_prefill_chunks",
            "n_requests")


def port_cfg(cfg):
    """The reference's configuration as the port's own dataclasses."""
    kw = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    for name, cls in (("ssm", tconfig.SSMConfig), ("moe", tconfig.MoEConfig),
                      ("mla", tconfig.MLAConfig)):
        if kw.get(name) is not None:
            kw[name] = cls(**vars(kw[name]))
    return tconfig.ModelConfig(**kw)


_PAIRS = {}


def pair(name):
    """(jax model, jax params, port model, port params), built once."""
    if name not in _PAIRS:
        jm = jax_build_model(CFGS[name])
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(port_cfg(CFGS[name]), device="cpu")
        _PAIRS[name] = (jm, jp, tm,
                        bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu"))
    return _PAIRS[name]


def _prompts(n=4, length=6, seed=2):
    # equal lengths: the dense engine then prefills one un-padded wave,
    # so both modes decode at the same true positions
    rng = np.random.default_rng(seed)
    return [rng.integers(1, TINY_SERVE.vocab_size, length).astype(np.int32)
            for _ in range(n)]


def _kw(paged, **kw):
    kw.setdefault("capacity", 32)
    kw.setdefault("max_new_tokens", 6)
    if paged:
        kw.update(block_size=4, prefill_chunk=8)
    return dict(kw, paged=paged)


def _serve(engine, prompts):
    res = engine.serve([p.copy() for p in prompts])
    assert [r.request_id for r in res] == list(range(len(prompts)))
    assert [r.status for r in res] == ["ok"] * len(prompts)
    return [list(map(int, r.tokens)) for r in res]


def _port(name, prompts, **kw):
    _, _, tm, tp = pair(name)
    kw.setdefault("batch_size", len(prompts))
    eng = ServeEngine(tm, tp, device="cpu", **kw)
    return eng, _serve(eng, prompts)


def _both(name, prompts, **kw):
    """Serve on the reference and the port; tokens and counters equal."""
    jm, jp, _, _ = pair(name)
    kw.setdefault("batch_size", len(prompts))
    je = JaxEngine(jm, jp, **kw)
    want = _serve(je, prompts)
    te, got = _port(name, prompts, **kw)
    assert got == want, name
    for c in COUNTERS:
        assert getattr(te, c) == getattr(je, c), c
    return te, got


# -- the primitive -------------------------------------------------------------

def test_sample_logits_matches_reference_with_ties():
    """Temperature and top-k over rows whose k-th value is tied (the mask
    keeps every tie), greedy, temperature 0 and top_k=1: tokens equal."""
    rng = np.random.default_rng(0)
    logits = np.round(rng.standard_normal((64, 48)) * 2) / 2   # many ties
    logits = logits.astype(np.float32)
    keys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(3), i))(jnp.arange(64))
    tkeys = fold_in(prng_key(3), torch.arange(64))
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    for kw in (dict(greedy=True), dict(greedy=False, temperature=0.0),
               dict(greedy=False, temperature=0.7, top_k=1),
               dict(greedy=False, temperature=0.7, top_k=5),
               dict(greedy=False, temperature=1.3, top_k=None),
               dict(greedy=False, temperature=0.5, top_k=48)):
        want = np.asarray(jax_sample_logits(jl, keys, **kw))
        got = sample_logits(tl, tkeys, **kw).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(kw))
    # top_k never samples outside each row's top-k set (ties kept)
    got = sample_logits(tl, tkeys, greedy=False, temperature=1.0, top_k=4)
    kth = np.sort(logits, axis=-1)[:, -4]
    assert (logits[np.arange(64), got.numpy()] >= kth).all()
    with pytest.raises(ValueError, match="rng"):
        sample_logits(tl, None, greedy=False, temperature=1.0)


def test_sampler_core_over_rid_step_grid():
    """``fold_in(fold_in(PRNGKey(seed), rid), step)`` keys derived from
    the (rid, step) vectors: the tokens equal the reference's."""
    rng = np.random.default_rng(1)
    rids, steps = np.meshgrid(np.arange(16), np.arange(12), indexing="ij")
    rids = rids.reshape(-1).astype(np.int32)
    steps = steps.reshape(-1).astype(np.int32)
    logits = rng.standard_normal((rids.size, 64)).astype(np.float32) * 3
    for kw in (dict(greedy=False, temperature=0.9, top_k=None),
               dict(greedy=False, temperature=0.8, top_k=16),
               dict(greedy=True)):
        want = np.asarray(jax_sampler_core(29, **kw)(
            jnp.asarray(logits), jnp.asarray(rids), jnp.asarray(steps)))
        got = make_sampler_core(29, **kw)(
            torch.from_numpy(logits), torch.from_numpy(rids),
            torch.from_numpy(steps)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(kw))


# -- the engine ----------------------------------------------------------------

def test_paged_sampling_matches_dense_seeded():
    prompts = _prompts()
    _, toks_d = _both("transformer", prompts, **_kw(False, **SAMPLED))
    _, toks_p = _both("transformer", prompts, **_kw(True, **SAMPLED))
    assert toks_d == toks_p
    # and actually sampled: a greedy run disagrees somewhere
    _, toks_g = _port("transformer", prompts, **_kw(True))
    assert toks_p != toks_g


@pytest.mark.parametrize("family", ["transformer", "mamba", "hybrid", "moe"])
def test_cross_mode_seeded_sampling_per_family(family):
    """Every served family draws the same streams on the port as on the
    reference, paged (state slabs, chunked prefill) and dense; and paged
    == dense, except on the MoE stack: its expert capacity is a share of
    the tokens a row feeds in one call, so a paged chunk and a dense
    wave drop different assignments (the reference's streams differ
    there too)."""
    prompts = _prompts(n=4, length=6, seed=23)
    cfg = dict(temperature=0.8, top_k=16, seed=29)
    te_d, toks_d = _both(family, prompts, **_kw(False, **cfg))
    te_p, toks_p = _both(family, prompts, **_kw(True, **cfg))
    assert not te_d.paged and te_p.paged
    assert (te_p.state_store is not None) == (family in ("mamba", "hybrid"))
    assert (toks_d == toks_p) == (family != "moe"), family
    _, toks_g = _port(family, prompts, **_kw(True))
    assert toks_p != toks_g, family
    _, again = _port(family, prompts, **_kw(True, **cfg))
    assert again == toks_p, family


def test_sampling_survives_mid_decode_join():
    """Join timing does not shift a request's stream: three requests
    together equal the same three strictly one after another, and the
    reference's."""
    prompts = _prompts(n=3, length=6, seed=5)
    cfg = _kw(True, greedy=False, temperature=0.9, top_k=None, seed=3)
    _, together = _both("transformer", prompts, **dict(cfg, batch_size=4))
    te, seq = _both("transformer", prompts, **dict(cfg, batch_size=1))
    assert te.n_requests == 3 and seq == together


def test_temperature_zero_reduces_to_greedy():
    prompts = _prompts(seed=7)
    for paged in (False, True):
        _, greedy = _port("transformer", prompts, **_kw(paged))
        eng, t0 = _port("transformer", prompts,
                        **_kw(paged, greedy=False, temperature=0.0, seed=9))
        assert eng._greedy and t0 == greedy
    _, _, tm, tp = pair("transformer")
    assert ServeEngine(tm, tp, device="cpu", greedy=False,
                       temperature=0.5).paged


def test_seeded_sampling_reproducible_and_seed_sensitive():
    prompts = _prompts(seed=13)
    cfg = _kw(True, greedy=False, temperature=1.2, max_new_tokens=8)
    _, a = _both("transformer", prompts, seed=17, **cfg)
    _, b = _port("transformer", prompts, seed=17, **cfg)
    _, c = _both("transformer", prompts, seed=18, **cfg)
    assert a == b and a != c


@pytest.mark.parametrize("paged", [True, False])
def test_sampled_burst_of_8_equals_single_steps(paged):
    """A burst of 8 decode steps per host drain draws the tokens K = 1
    draws (the burst loop calls the same sampler core per step)."""
    prompts = _prompts(n=3, length=6, seed=31)
    cfg = _kw(paged, max_new_tokens=10, **SAMPLED)
    _, k1 = _both("transformer", prompts, burst=1, **cfg)
    te, k8 = _both("transformer", prompts, burst=8, **cfg)
    assert k8 == k1 and te.loop_stats()["n_bursts"] > 0


@pytest.mark.parametrize("kw", [dict(temperature=-0.5), dict(top_k=0),
                                dict(top_k=-3, temperature=0.7)])
def test_bad_sampling_config_refused_as_the_reference(kw):
    jm, jp, tm, tp = pair("transformer")
    with pytest.raises(ValueError) as want:
        JaxEngine(jm, jp, **kw)
    with pytest.raises(ValueError) as got:
        ServeEngine(tm, tp, device="cpu", **kw)
    assert str(got.value) == str(want.value)
