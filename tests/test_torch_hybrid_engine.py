"""The hybrid Mamba+attention+MoE families through the port's paged
engine, against the JAX reference, on the CPU.

Weights come from the reference's ``init`` through the bridge.  The
paged step's logits must match within 1e-4; the engine's greedy token
streams, scheduler and loop counters and pool statistics must be
exactly equal, for pure mamba, hybrid, a tiny jamba (period 4, MoE every
2nd layer, 4 experts top-2) and a tiny dbrx (MoE top-4).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from conftest import FAMILY_CFGS, TINY_SERVE
from repro.models import build_model as jax_build_model
from repro.models.config import MoEConfig, SSMConfig
from repro.serving import ServeEngine as JaxEngine
from repro_torch import bridge
from repro_torch.models import build_model
from repro_torch.models import config as tconfig
from repro_torch.serving import ServeEngine

REPO = Path(__file__).resolve().parents[1]
COUNTERS = ("n_prefills", "n_joins", "n_evictions", "n_prefill_chunks",
            "n_prefix_hits", "n_shared_tokens", "n_cow_forks", "n_requests")
LOOP = ("n_bursts", "n_device_steps", "n_host_syncs", "n_burst_early_exits",
        "n_state_uploads")

TINY_JAMBA = TINY_SERVE.replace(
    arch_id="tiny-jamba", family="hybrid", n_layers=8, rope="none",
    ssm=SSMConfig(d_state=8, d_conv=4, expand=2),
    attn_layer_period=4, attn_layer_offset=2,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=48, layer_period=2,
                  layer_offset=1))
TINY_DBRX = TINY_SERVE.replace(
    arch_id="tiny-dbrx", family="moe", norm="layernorm",
    moe=MoEConfig(n_experts=6, top_k=4, d_expert=48, capacity_factor=1.0))
CFGS = {"mamba": FAMILY_CFGS["mamba"], "hybrid": FAMILY_CFGS["hybrid"],
        "jamba": TINY_JAMBA, "dbrx": TINY_DBRX,
        "mamba-bf16": FAMILY_CFGS["mamba"].replace(
            param_dtype="bfloat16", compute_dtype="bfloat16")}


def _port_cfg(cfg):
    """The same configuration as the port's own dataclasses."""
    kw = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    for name, cls in (("ssm", tconfig.SSMConfig), ("moe", tconfig.MoEConfig)):
        if kw[name] is not None:
            kw[name] = cls(**vars(kw[name]))
    return tconfig.ModelConfig(**kw)


_PAIRS = {}


def _pair(name):
    """(jax model, jax params, port model, port params), built once."""
    if name not in _PAIRS:
        cfg = CFGS[name]
        jm = jax_build_model(cfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(_port_cfg(cfg), device="cpu")
        _PAIRS[name] = (jm, jp, tm,
                        bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu"))
    return _PAIRS[name]


def _prompts(seed, lengths, vocab=TINY_SERVE.vocab_size):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _serve_both(name, prompts, **kw):
    jm, jp, tm, tp = _pair(name)
    je = JaxEngine(jm, jp, **kw)
    te = ServeEngine(tm, tp, device="cpu", **kw)
    jr = je.serve(prompts)
    tr = te.serve(prompts)
    assert [r.status for r in tr] == ["ok"] * len(prompts)
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    for n in COUNTERS:
        assert getattr(te, n) == getattr(je, n), n
    jl, tl = je.loop_stats(), te.loop_stats()
    for n in LOOP:
        assert tl[n] == jl[n], n
    ts, js = te.pool_stats(), je.pool_stats()
    assert ts == js
    return je, te


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["mamba", "hybrid", "jamba"])
def test_bridge_round_trips_mixed_dtype_trees(name, dtype):
    """Every leaf arrives with its shape, type and bits — f32 ``A_log``,
    ``D`` and ``router`` inside a bf16 model included — and the port's
    own init builds the same tree."""
    cfg = CFGS[name].replace(param_dtype=dtype, compute_dtype=dtype)
    jp = _pair(name)[1] if dtype == "float32" else \
        jax_build_model(cfg).init(jax.random.PRNGKey(1))
    jp = jax.tree.map(np.asarray, jp)
    tp = bridge.to_torch(jp, "cpu")
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    kinds = set()
    for path, a in leaves:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == a.shape, path
        if a.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), a)
        kinds.add((path[-1].key, str(t.dtype)))
    assert ("A_log", "torch.float32") in kinds and ("D", "torch.float32") in kinds
    if name == "jamba":
        assert ("router", "torch.float32") in kinds
    own = build_model(_port_cfg(cfg), device="cpu").init(seed=0)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, tp))
    assert all(o.shape == t.shape and o.dtype == t.dtype for o, t in
               zip(jax.tree.leaves(own), jax.tree.leaves(tp)))


@pytest.mark.parametrize("name", ["jamba", "dbrx"])
def test_paged_step_logits_and_slabs_match(name):
    """Chunked prefill then decode through the paged step, three slots on
    permuted slabs (one slab spare), a slot idle for a step and a slot
    starting late: logits, K/V pools and the slabs' owned rows within
    1e-4 (the deeper layers' K/V and states carry seven steps of f32
    rounding through eight layers)."""
    jm, jp, tm, tp = _pair(name)
    nb, bs, P, chunk, ns = 20, 4, 5, 4, 4
    jc = jm.init_paged_cache(nb, bs, dtype=jnp.float32, num_state_slots=ns)
    tc = tm.init_paged_cache(nb, bs, dtype=torch.float32, num_state_slots=ns)
    rng = np.random.default_rng(7)
    pt = np.stack([rng.permutation(nb)[:P] for _ in range(3)]).astype(np.int32)
    slabs = np.array([2, 0, 3], np.int32)
    prompts = _prompts(3, (9, 6, 5))
    start = (0, 0, 2)                      # slot 2 joins at step 2
    lengths = np.zeros(3, np.int32)
    step = jax.jit(jm.paged_step)
    nxt = np.zeros(3, np.int64)
    for it in range(7):
        tokens = np.zeros((3, chunk), np.int32)
        t_valid = np.zeros(3, np.int32)
        for b, pr in enumerate(prompts):
            if it < start[b] or (it == 1 and b == 1):
                continue                   # idle this step
            if lengths[b] < len(pr):
                n = min(chunk, len(pr) - lengths[b])
                tokens[b, :n] = pr[lengths[b]:lengths[b] + n]
                t_valid[b] = n
            else:
                tokens[b, 0] = nxt[b]
                t_valid[b] = 1
        if it >= 5:
            tokens = tokens[:, :1]         # pure decode: T = 1
            assert (t_valid == 1).all()
        args = (tokens, pt, lengths, t_valid, slabs)
        jl, jc = step(jp, jc, *map(jnp.asarray, args))
        tl, tc = tm.paged_step(tp, tc, *map(torch.from_numpy, args))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0, err_msg=f"step {it}")
        nxt = np.asarray(jl).argmax(-1)
        lengths = lengths + t_valid
    for j in range(len(tm.period_descs)):
        for key, ja in jc["blocks"][f"s{j}"].items():
            ta = tc["blocks"][f"s{j}"][key].numpy()
            ja = np.asarray(ja)
            if key in ("conv", "ssm"):
                assert ta.shape[1] == ns + 1          # the dump row
                np.testing.assert_allclose(ta[:, slabs], ja[:, slabs],
                                           atol=1e-4, rtol=0)
                np.testing.assert_array_equal(ta[:, 1], 0)  # never owned
            else:
                np.testing.assert_allclose(ta, ja, atol=1e-4, rtol=0)


@pytest.mark.parametrize("burst", [1, 4])
@pytest.mark.parametrize("name", ["mamba", "hybrid", "jamba", "dbrx"])
def test_greedy_streams_match_with_joins_and_chunked_prefill(name, burst):
    """Five requests on two slots (joins mid-decode), prompts longer than
    the prefill chunk, bursts of 1 and 4."""
    prompts = _prompts(burst, (9, 3, 14, 6, 11))
    je, te = _serve_both(name, prompts, batch_size=2, capacity=32,
                         max_new_tokens=7, prefill_chunk=4, block_size=4,
                         burst=burst)
    assert te.n_joins > 0 and te.n_prefill_chunks > len(prompts)
    assert te.share_prefix == (name == "dbrx")  # auto: off when recurrent
    if name != "dbrx":
        assert te.pool_stats()["n_state_live"] == 0


@pytest.mark.parametrize("name", ["hybrid", "jamba"])
def test_fewer_state_slabs_than_slots_queue_and_recycle(name):
    """Two slabs for three slots: a request with no free slab stays
    queued although a slot is free, and each recycled slab is blanked on
    its new owner's first step (the streams equal the reference's)."""
    prompts = _prompts(11, (7, 5, 9, 4, 6, 8))
    je, te = _serve_both(name, prompts, batch_size=3, capacity=32,
                         max_new_tokens=5, prefill_chunk=4, block_size=4,
                         burst=2, num_state_slots=2)
    s = te.pool_stats()
    assert s["num_state_slots"] == 2 and s["n_state_free"] == 2
    assert te.n_evictions == len(prompts)
    # the recycled slabs really held an earlier owner's state: serving
    # the last prompt alone gives the same tokens
    alone = ServeEngine(*_pair(name)[2:], device="cpu", batch_size=1,
                        capacity=32, max_new_tokens=5, prefill_chunk=4,
                        block_size=4).serve(prompts[-1:])
    np.testing.assert_array_equal(
        alone[0].tokens, te.serve(prompts[-1:])[0].tokens)


def test_bf16_mamba_over_f32_pool_serves_paged_as_reference():
    """A bf16 stack of mamba layers only over the default f32 pool: the
    paged step reads the f32 conv window in the compute type, so the
    reference serves it, and the port must too, with its statuses, tokens,
    counters and pool statistics (the slabs' bytes over ``num_blocks``).
    Dense mode keeps the port's up-front ``ValueError``: there the
    reference's f32 conv window changes its decode carry's type, and its
    requests end in ``error``."""
    prompts = _prompts(3, (9, 5))
    kw = dict(batch_size=2, capacity=64, max_new_tokens=4)
    je, te = _serve_both("mamba-bf16", prompts, **kw)
    assert te.paged and te.cache_dtype == torch.float32
    assert te.pool_stats()["bytes_per_block"] > 0
    _, _, tm, tp = _pair("mamba-bf16")
    with pytest.raises(ValueError, match="f32 KV pool"):
        ServeEngine(tm, tp, device="cpu", paged=False, **kw)


def test_share_prefix_gating_and_unported_families():
    _, _, tm, tp = _pair("hybrid")
    with pytest.raises(ValueError, match="share_prefix=True"):
        ServeEngine(tm, tp, device="cpu", share_prefix=True)
    assert not ServeEngine(tm, tp, device="cpu").share_prefix
    assert ServeEngine(*_pair("dbrx")[2:], device="cpu").share_prefix
    assert not tm.supports_speculative() and tm.has_recurrent_state()
    with pytest.raises(ValueError, match="num_state_slots"):
        tm.init_paged_cache(8, 4, dtype=torch.float32)
    # the xLSTM family (ported) builds, and refuses prefix sharing and
    # speculation as mamba does
    xm = build_model(_port_cfg(FAMILY_CFGS["xlstm"]), device="cpu")
    xp = xm.init(seed=0)
    assert not xm.supports_speculative() and xm.has_recurrent_state()
    with pytest.raises(ValueError, match="share_prefix=True"):
        ServeEngine(xm, xp, device="cpu", share_prefix=True)
    assert not ServeEngine(xm, xp, device="cpu").share_prefix
    with pytest.raises(ValueError, match="has recurrent layers"):
        ServeEngine(xm, xp, device="cpu", spec_k=2, draft_model=xm,
                    draft_params=xp)


@pytest.mark.parametrize("argv,n_tok", [
    (["--family", "mamba"], 30), (["--family", "hybrid", "--direct"], 30),
    (["--arch", "jamba-v0.1-52b", "--smoke", "--direct"], 30)])
def test_launcher_serves_recurrent_families_on_cpu(argv, n_tok):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "5", "--batch", "2", "--max-new", "6",
         "--prompt-len", "20", "--num-state-slots", "2", *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"served 5 requests / {n_tok} tokens" in out.stdout
    assert "state slabs: 2 slots, 2 free / 0 live" in out.stdout


def test_launcher_xlstm_family_raises():
    """``--family xlstm`` was refused until the xLSTM blocks were ported;
    it now serves on the CPU through state slabs, as the other recurrent
    families do."""
    test_launcher_serves_recurrent_families_on_cpu(["--family", "xlstm"], 30)
