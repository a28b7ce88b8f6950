"""Int8 paged KV in the port against the JAX reference, on the CPU.

The quantizer is the reference's arithmetic in its order, so its codes
and scales must equal the reference's bit for bit on equal inputs.  The
int8 attention step (plain path: ``paged_attention`` over the
dequantized gather, the int8 kernels' plain versions) must match the
reference's ``gqa_paged_step_quant`` within 1e-5 in f32, and the int8
engine's greedy streams, scheduler counters and ``pool_stats`` must
equal the JAX int8 engine's.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAMILY_CFGS, TINY_SERVE
from repro.models import attention as ja
from repro.models import build_model as jax_build_model
from repro.serving import ServeEngine as JaxEngine
from repro_torch import bridge
from repro_torch.models import attention as ta
from repro_torch.models import build_model
from repro_torch.models import config as tconfig
from repro_torch.serving import ServeEngine

REPO = Path(__file__).resolve().parents[1]
ATOL_F32 = 1e-5
COUNTERS = ("n_prefills", "n_joins", "n_evictions", "n_prefill_chunks",
            "n_prefix_hits", "n_shared_tokens", "n_cow_forks", "n_requests")
LOOP = ("n_bursts", "n_device_steps", "n_host_syncs", "n_burst_early_exits",
        "n_state_uploads")


def _port_cfg(cfg):
    kw = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    if kw["ssm"] is not None:
        kw["ssm"] = tconfig.SSMConfig(**vars(kw["ssm"]))
    return tconfig.ModelConfig(**kw)


_PAIRS = {}


def _pair(name):
    """(jax model, jax params, port model, port params), built once."""
    if name not in _PAIRS:
        cfg = FAMILY_CFGS[name]
        jm = jax_build_model(cfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(_port_cfg(cfg), device="cpu")
        _PAIRS[name] = (jm, jp, tm,
                        bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu"))
    return _PAIRS[name]


def _prompts(seed, lengths, vocab=TINY_SERVE.vocab_size):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


# -- the quantizer ------------------------------------------------------------

@pytest.mark.parametrize("shape,spread", [((3, 5, 2, 16), 1.0),
                                          ((2, 7, 4, 8), 300.0),
                                          ((4, 1, 3, 64), 1e-3)])
def test_quantize_dequantize_match_reference_bitwise(shape, spread):
    rng = np.random.default_rng(len(shape) + int(spread))
    x = (rng.standard_normal(shape) * spread).astype(np.float32)
    x[0, 0, 0] = 0.0                       # an all-zero row: the eps floor
    x[-1, -1, -1, :4] = [0.5, -0.5, 1.5, -2.5]   # ties of round-half-even
    jq, js = ja.quantize_kv(jnp.asarray(x))
    tq, ts = ta.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        ta.dequantize_kv(tq, ts).numpy(),
        np.asarray(ja.dequantize_kv(jq, js)))


@pytest.mark.parametrize("trail", [(2, 8), (2,)])
def test_paged_write_index_matches_reference_scatter(trail):
    """One write index serves pools of any trailing shape (K/V and their
    scales) with the reference's drop rule: padding, idle slots and
    positions past the page table are not written."""
    rng = np.random.default_rng(len(trail))
    nb, bs, B, T, P = 9, 4, 3, 6, 2
    pool = rng.standard_normal((nb, bs) + trail).astype(np.float32)
    vals = rng.standard_normal((B, T) + trail).astype(np.float32)
    pt = np.stack([rng.permutation(nb)[:P] for _ in range(B)]).astype(np.int32)
    lengths = np.array([0, 3, 6], np.int32)      # row 2 runs off its pages
    t_valid = np.array([6, 2, 4], np.int32)
    want = np.asarray(ja.paged_scatter(jnp.asarray(pool), jnp.asarray(vals),
                                       jnp.asarray(pt), jnp.asarray(lengths),
                                       jnp.asarray(t_valid)))
    index = ta.paged_write_index(torch.from_numpy(pt),
                                 torch.from_numpy(lengths),
                                 torch.from_numpy(t_valid), T, bs)
    got = ta.paged_write(torch.from_numpy(pool.copy()),
                         torch.from_numpy(vals), index)
    np.testing.assert_array_equal(got.numpy(), want)
    assert index[0].numel() == 6 + 2 + 2          # tokens kept


# -- the int8 attention step --------------------------------------------------

@pytest.mark.parametrize("T", [1, 4])
def test_gqa_paged_step_quant_matches_reference(T):
    """Same weights, same pools: out within 1e-5 (f32).  The K/V rows
    come out of two projections that sum in other orders and may differ
    in their last bit, so a scale (amax / 127) may too: the scales agree
    within 1e-6 relative (seen: 9 of 96 differ, by 1.9e-7).  A code
    could differ by one for the same reason: such codes are counted and
    must be rare (seen: none)."""
    cfg = TINY_SERVE
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    p_j = ja.gqa_params(jax.random.PRNGKey(3), cfg, jnp.float32)
    p_t = {k: torch.from_numpy(np.array(v)) for k, v in p_j.items()}
    rng = np.random.default_rng(T)
    nb, bs, B, P = 12, 4, 3, 3
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    kq, ks = ja.quantize_kv(jnp.asarray(
        rng.standard_normal((nb, bs, KV, hd)).astype(np.float32)))
    vq, vs = ja.quantize_kv(jnp.asarray(
        rng.standard_normal((nb, bs, KV, hd)).astype(np.float32)))
    pools = [np.asarray(a) for a in (kq, vq, ks, vs)]
    pt = np.stack([rng.permutation(nb)[:P] for _ in range(B)]).astype(np.int32)
    lengths = np.array([0, 5, 8], np.int32)
    t_valid = np.array([T, T - 1 if T > 1 else 1, 0 if T > 1 else 1],
                       np.int32)
    j_out, *j_pools = ja.gqa_paged_step_quant(
        p_j, cfg, jnp.asarray(x), *map(jnp.asarray, pools), jnp.asarray(pt),
        jnp.asarray(lengths), jnp.asarray(t_valid))
    t_pools = [torch.from_numpy(a.copy()) for a in pools]
    state = dict(zip(("k", "v", "k_scale", "v_scale"), t_pools))
    index = ta.paged_write_index(torch.from_numpy(pt),
                                 torch.from_numpy(lengths),
                                 torch.from_numpy(t_valid), T, bs)
    t_out = ta.gqa_paged_step(p_t, cfg, torch.from_numpy(x), state,
                              torch.from_numpy(pt), torch.from_numpy(lengths),
                              index)
    assert all(state[n] is a for n, a in zip(state, t_pools))    # in place
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                               atol=ATOL_F32, rtol=0)
    off_by_one = 0
    for got, want in zip(t_pools[:2], j_pools[:2]):
        d = np.abs(got.numpy().astype(int) - np.asarray(want).astype(int))
        assert d.max() <= 1
        off_by_one += int((d == 1).sum())
    assert off_by_one <= 2, off_by_one
    for got, want in zip(t_pools[2:], j_pools[2:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=0)


# -- the model's int8 pools ---------------------------------------------------

def test_int8_cache_structure_and_cow_fork():
    """int8 K/V plus (nb, bs, KV) f32 scales per attention layer, none in
    the f32 pool; a COW fork copies the scale rows with the codes."""
    _, _, tm, _ = _pair("hybrid")
    nb, bs = 6, 4
    cache = tm.init_paged_cache(nb, bs, dtype=torch.float32,
                                num_state_slots=2, kv_dtype="int8")
    attn = [st for st in cache["blocks"].values() if "k" in st]
    assert attn and all(st["k"].dtype == torch.int8
                        and st["k_scale"].dtype == torch.float32
                        and st["k_scale"].shape == st["k"].shape[:-1]
                        for st in attn)
    plain = tm.init_paged_cache(nb, bs, dtype=torch.float32,
                                num_state_slots=2)
    assert not [k for st in plain["blocks"].values() for k in st
                if k.endswith("_scale")]
    for st in attn:
        for a in st.values():
            a.copy_(torch.arange(a.numel()).reshape(a.shape) % 100)
    tm.copy_paged_block(cache, 1, 4)
    for st in attn:
        for name, a in st.items():
            assert torch.equal(a[:, 4], a[:, 1]), name
    with pytest.raises(ValueError, match="kv_dtype"):
        tm.init_paged_cache(nb, bs, num_state_slots=2, kv_dtype="int4")


# -- the engine ---------------------------------------------------------------

def _serve_both(name, prompts, **kw):
    jm, jp, tm, tp = _pair(name)
    je = JaxEngine(jm, jp, kv_dtype="int8", **kw)
    te = ServeEngine(tm, tp, device="cpu", kv_dtype="int8", **kw)
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
    assert ts["kv_dtype"] == "int8"
    assert ts == js
    return je, te


@pytest.mark.parametrize("name,burst", [("transformer", 1),
                                        ("transformer", 4), ("hybrid", 4)])
def test_int8_streams_match_with_joins_and_chunked_prefill(name, burst):
    """Five requests on two slots (joins mid-decode), prompts longer than
    the prefill chunk: T > 1 steps (the int8 prefill kernel's plain
    version) mixed with T = 1 bursts (B3's)."""
    prompts = _prompts(burst + 40, (9, 3, 14, 6, 11))
    _, te = _serve_both(name, prompts, batch_size=2, capacity=32,
                        max_new_tokens=7, prefill_chunk=4, block_size=4,
                        burst=burst)
    assert te.n_joins > 0 and te.n_prefill_chunks > len(prompts)


def test_int8_prefix_sharing_and_cow_fork_match():
    """One slot: the second request maps the first one's retained int8
    pages (codes and scales), including its partial tail page, and forks
    the block it writes."""
    (a,) = _prompts(21, (10,))
    prompts = [a, a[:7].copy(), np.concatenate([a[:8], a[:3]])]
    _, te = _serve_both("transformer", prompts, batch_size=1, capacity=32,
                        max_new_tokens=5, prefill_chunk=4, block_size=4,
                        burst=2)
    assert te.n_prefix_hits >= 2 and te.n_cow_forks >= 1
    assert te.pool_stats()["n_live"] == 0


def test_int8_bytes_per_block_counts_scales():
    _, _, tm, tp = _pair("transformer")
    cfg = tm.cfg
    kw = dict(batch_size=2, capacity=32, max_new_tokens=4, block_size=4,
              device="cpu")
    f32 = ServeEngine(tm, tp, **kw).kv_bytes_per_block()
    q = ServeEngine(tm, tp, kv_dtype="int8", **kw).kv_bytes_per_block()
    hd = cfg.resolved_head_dim
    assert f32 / q == (2 * hd * 4) / (2 * hd + 2 * 4)
    assert q == cfg.n_layers * 4 * cfg.n_kv_heads * (2 * hd + 8)


def test_mamba_int8_run_is_bitwise_its_f32_run():
    """No attention layer, nothing quantized: the int8 engine's tokens and
    counters are the f32 engine's (the reference's contract too)."""
    _, _, tm, tp = _pair("mamba")
    prompts = _prompts(7, (9, 3, 12))
    kw = dict(batch_size=2, capacity=32, max_new_tokens=6, prefill_chunk=4,
              block_size=4, burst=4, device="cpu")
    a = ServeEngine(tm, tp, **kw)
    b = ServeEngine(tm, tp, kv_dtype="int8", **kw)
    for x, y in zip(a.serve(prompts), b.serve(prompts)):
        np.testing.assert_array_equal(x.tokens, y.tokens)
    assert a.loop_stats() == b.loop_stats()
    assert b.pool_stats()["kv_dtype"] == "int8"


def test_bf16_model_with_int8_pool_raises_as_the_reference_fails():
    cfg = TINY_SERVE.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    tm = build_model(_port_cfg(cfg), device="cpu")
    with pytest.raises(ValueError, match="bf16 model with kv_dtype='int8'"):
        ServeEngine(tm, tm.init(seed=0), device="cpu", kv_dtype="int8")
    # the reference: the dequantized f32 K/V promote the residual stream
    # out of bf16 and its first step fails
    jm = jax_build_model(cfg)
    je = JaxEngine(jm, jm.init(jax.random.PRNGKey(0)), kv_dtype="int8",
                   batch_size=2, capacity=24, max_new_tokens=4,
                   block_size=4, prefill_chunk=4)
    try:
        res = je.serve(_prompts(2, (5, 9)))
    except TypeError as exc:
        assert "carry" in str(exc)
    else:
        assert all(r.status == "error" for r in res)


def test_int8_gates():
    _, _, tm, tp = _pair("transformer")
    for kw, exc, msg in (({"paged": False}, ValueError, "paged mode"),
                         ({"spec_k": 2}, ValueError, "spec_k"),
                         ({"mesh": object()}, NotImplementedError, "mesh")):
        with pytest.raises(exc, match=msg):
            ServeEngine(tm, tp, device="cpu", kv_dtype="int8", **kw)


def test_launcher_serves_int8_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--kv-dtype", "int8", "--requests", "5",
         "--batch", "2", "--max-new", "6", "--prompt-len", "20"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "served 5 requests / 30 tokens" in out.stdout
    assert "kv storage: int8" in out.stdout
