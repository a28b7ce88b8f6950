"""The port's MLA (DeepSeek-V3 multi-head latent attention) and the
deepseek smoke model on the dense engine, against the JAX reference, on
the CPU.

Weights come from the reference's ``init`` through the bridge and inputs
from a seeded numpy generator, in f32.  On the CPU the prefill and the
expanded decode run the flash and decode kernels' plain versions with V
zero-padded to the q/k head (its padded columns are 0 and cut off), so
they must match the reference's ``mla_prefill``/``mla_decode`` within
1e-5 (a few f32 ulps: torch's and XLA's reductions differ in their last
bits).  The absorbed decode must match the expanded one within the
reference's own bound, 2e-3 (``tests/test_decode_consistency.py``); the
dense engine's greedy tokens, statuses and counters must equal the JAX
engine's in both decode forms, over an f32 and a bf16 latent cache.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as JA
from repro.models import build_model as jax_build_model
from repro.serving import ServeEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import attention as TA
from repro_torch.models import build_model
from repro_torch.serving import ServeEngine

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-5
ABSORB_TOL = 2e-3    # the reference's bound between its two decode forms
ARCH = "deepseek-v3-671b"
CFG = jax_get_config(ARCH, smoke=True)     # f32, 2 layers, q/k 48, v 32
TCFG = get_config(ARCH, smoke=True)
COUNTERS = ("n_prefills", "n_joins", "n_evictions", "n_batches",
            "n_requests", "_pos")
_PAIR = []


def _pair():
    """(jax params, port params as tensors), built once."""
    if not _PAIR:
        jp = jax_build_model(CFG).init(jax.random.PRNGKey(0))
        _PAIR.extend([jp, bridge.to_torch(jax.tree.map(np.asarray, jp),
                                          "cpu")])
    return _PAIR


def _attn_params():
    """The first (dense-prefix) layer's MLA weights: (numpy, tensors)."""
    jp, tp = _pair()
    return (jax.tree.map(np.asarray, jp["prefix"][0]["attn"]),
            tp["prefix"][0]["attn"])


def _x(seed, B, S):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, CFG.d_model)).astype(np.float32)


def test_init_tree_matches_reference_with_mtp():
    """The port's init builds the reference's tree, ``mtp`` included, leaf
    by leaf in shape and type; the pattern is the dense prefix then MoE
    layers, all MLA, served dense only."""
    jp, tp = _pair()
    tm = build_model(TCFG, device="cpu")
    own = tm.init(seed=0)
    assert "mtp" in own and "mtp" in tp
    assert jax.tree.structure(jax.tree.map(lambda _: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, tp))
    for o, t in zip(jax.tree.leaves(own), jax.tree.leaves(tp)):
        assert o.shape == t.shape and o.dtype == t.dtype
    assert tm.prefix_descs == [("mla", "dense")]
    assert tm.period_descs == [("mla", "moe")]
    assert set(own["mtp"]["layer"]) == {"norm1", "attn", "norm2", "mlp"}
    assert not tm.supports_paged() and not tm.has_recurrent_state()
    assert tm.has_cache_typed_state()
    with pytest.raises(ValueError, match="paged=True"):
        ServeEngine(tm, own, device="cpu", paged=True)


@pytest.mark.parametrize("S", [1, 9])
def test_prefill_matches_reference(S):
    """Output and the latent cache (c_kv, k_rope) of a causal prefill."""
    jp, tp = _attn_params()
    x = _x(S, 2, S)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    jy, (jc, jkr) = JA.mla_prefill(jp, CFG, jnp.asarray(x), jnp.asarray(pos),
                                   impl="naive")
    ty, (tc, tkr) = TA.mla_prefill(tp, TCFG, torch.from_numpy(x),
                                   torch.from_numpy(pos))
    for want, got in ((jy, ty), (jc, tc), (jkr, tkr)):
        assert tuple(got.shape) == np.asarray(want).shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


def _caches(seed, B, C, n):
    """Latent caches with ``n`` filled slots (zeros past them)."""
    rng = np.random.default_rng(seed)
    m = CFG.mla
    c = np.zeros((B, C, m.kv_lora_rank), np.float32)
    kr = np.zeros((B, C, m.qk_rope_head_dim), np.float32)
    c[:, :n] = rng.standard_normal((B, n, m.kv_lora_rank))
    kr[:, :n] = rng.standard_normal((B, n, m.qk_rope_head_dim))
    return c, kr


@pytest.mark.parametrize("pos", [0, 9, 15, 20])
@pytest.mark.parametrize("absorb", [False, True])
def test_decode_matches_reference(absorb, pos):
    """One token at ``pos`` over a 16-slot latent cache: a first token, a
    partly filled cache, the last slot, and a position past the cache
    (the write clamps to the last slot, every slot valid, as
    ``lax.dynamic_update_slice`` does).  Output and both caches."""
    jp, tp = _attn_params()
    B, C = 2, 16
    x = _x(100 + pos, B, 1)
    c, kr = _caches(pos, B, C, min(pos, C))
    jo, jc, jkr = JA.mla_decode(jp, CFG, jnp.asarray(x), jnp.asarray(c),
                                jnp.asarray(kr), pos, absorb=absorb)
    tc, tkr = torch.from_numpy(c.copy()), torch.from_numpy(kr.copy())
    to, _, _ = TA.mla_decode(tp, TCFG, torch.from_numpy(x), tc, tkr, pos,
                             absorb=absorb)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tkr.numpy(), np.asarray(jkr), atol=ATOL,
                               rtol=0)


def test_absorbed_decode_matches_expanded():
    """The model's decode logits in the two forms after a prefill, within
    the reference's 2e-3 (its test_mla_absorbed_decode_matches_expanded,
    same capacity factor)."""
    cfg = TCFG.replace(moe=dataclasses.replace(TCFG.moe,
                                               capacity_factor=8.0))
    _, tp = _pair()
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32))
    naive = build_model(cfg, device="cpu")
    absorbed = build_model(cfg, device="cpu", mla_absorb=True)
    logits = []
    for model in (naive, absorbed):
        _, cache = naive.prefill(tp, tokens[:, :7], capacity=10,
                                 cache_dtype=torch.float32)
        lg, _ = model.decode_step(tp, cache, tokens[:, 7:], 7)
        logits.append(lg)
    assert (logits[0] - logits[1]).abs().max().item() < ABSORB_TOL


@pytest.mark.parametrize("kv_dtype", [None, "bf16"])
@pytest.mark.parametrize("absorb", [False, True])
def test_dense_engine_streams_match_reference(absorb, kv_dtype):
    """Five requests on two slots through the dense engine (the only one
    MLA serves on): greedy tokens, statuses and counters equal the JAX
    engine's, over an f32 and a bf16 latent cache."""
    jp, tp = _pair()
    prompts = [np.random.default_rng(7).integers(
        0, CFG.vocab_size, n).astype(np.int32) for n in (9, 3, 14, 6, 11)]
    kw = dict(batch_size=2, capacity=32, max_new_tokens=7, burst=2,
              kv_dtype=kv_dtype)
    je = JaxEngine(jax_build_model(CFG, mla_absorb=absorb), jp, **kw)
    te = ServeEngine(build_model(TCFG, device="cpu", mla_absorb=absorb), tp,
                     device="cpu", **kw)
    jr, tr = je.serve(prompts), te.serve(prompts)
    assert not te.paged and not je.paged
    assert [r.status for r in tr] == [r.status for r in jr] == ["ok"] * 5
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    for n in COUNTERS:
        assert getattr(te, n) == getattr(je, n), n
    jl, tl = je.loop_stats(), te.loop_stats()
    for n in ("n_bursts", "n_device_steps", "n_host_syncs",
              "n_burst_early_exits", "n_state_uploads"):
        assert tl[n] == jl[n], n
    leaves = te._cache["prefix"][0]
    assert set(leaves) == {"c", "kr"}
    assert leaves["c"].dtype == (torch.bfloat16 if kv_dtype
                                 else torch.float32)


def test_launcher_picks_the_dense_engine():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--requests", "3", "--batch", "2",
         "--max-new", "4", "--prompt-len", "12"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "served 3 requests / 12 tokens" in out.stdout
    assert "dense cache: 2 slots x 24 positions" in out.stdout
