"""The port's dense (non-paged) serving path against the JAX reference,
on the CPU.

Inputs are made from a seed with numpy and weights come from the
reference's ``init`` through the bridge.  On the CPU the kernel
wrappers run their plain versions: the contiguous flash attention (B2)
and the dense decode attention (B4) must equal the reference's Pallas
kernels in interpret mode and its jnp functions within 1e-5 in f32;
``prefill``/``decode_step`` logits the reference's within 1e-4 over
many steps (f32; sums taken in another order); the dense engine's greedy
token streams and scheduler and loop counters exactly.  The GPU cases
of these kernels are in ``tests/test_torch_kernels.py``.
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
from repro.kernels.decode_attention import ops as jd
from repro.kernels.flash_attention import ops as jf
from repro.models import attention as ja
from repro.models import build_model as jax_build_model
from repro.models import mamba as jmamba
from repro.models.config import MoEConfig
from repro.serving import ServeEngine as JaxEngine
from repro_torch import bridge
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as ta
from repro_torch.models import build_model
from repro_torch.models import mamba as tmamba
from repro_torch.models import config as tconfig
from repro_torch.serving import ServeEngine

REPO = Path(__file__).resolve().parents[1]
ATOL_F32 = 1e-5          # one attention / one mamba layer, f32
ATOL_LOGITS = 1e-4       # a whole model over many decode steps, f32
COUNTERS = ("n_prefills", "n_joins", "n_evictions", "n_batches",
            "n_requests", "_pos")
LOOP = ("n_bursts", "n_device_steps", "n_host_syncs", "n_burst_early_exits",
        "n_state_uploads")

CFGS = {"transformer": TINY_SERVE,
        "window": TINY_SERVE.replace(arch_id="tiny-window", sliding_window=8),
        "hybrid": FAMILY_CFGS["hybrid"],
        # a dense prefix layer before the MoE periods: the cache's
        # ``prefix`` leaves (batch axis 0) beside the stacked ones
        "moe": TINY_SERVE.replace(
            arch_id="tiny-moe", family="moe", n_layers=3,
            moe=MoEConfig(n_experts=4, top_k=2, d_expert=48,
                          first_dense_layers=1))}


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


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _prompts(seed, lengths, vocab=TINY_SERVE.vocab_size):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


# -- B2, contiguous: plain version vs the Pallas kernel (interpret) ----------

@pytest.mark.parametrize("S,window,block", [
    (32, 0, 16),        # causal, S a multiple of the block
    (27, 0, 8),         # causal, S not a multiple of the block
    (40, 12, 16),       # causal with a window, S not a multiple
])
def test_plain_flash_matches_pallas_and_reference(S, window, block):
    rng = np.random.default_rng(S + window)
    B, H, KV, hd = 2, 6, 2, 16       # G = 3: not a power of two
    q, k, v = _randn(rng, B, S, H, hd), _randn(rng, B, S, KV, hd), \
        _randn(rng, B, S, KV, hd)
    got = fops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True,
                               sliding_window=window).numpy()
    pallas = np.asarray(jf.flash_attention_bshd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        sliding_window=window, block_q=block, block_k=block,
        interpret=True))
    naive = np.asarray(ja.naive_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        sliding_window=window))
    np.testing.assert_allclose(got, pallas, atol=ATOL_F32, rtol=0)
    np.testing.assert_allclose(got, naive, atol=ATOL_F32, rtol=0)


def test_plain_naive_attention_options_match_reference():
    """The plain version's other options (q_offset, kv_len, no causal
    mask) as the reference computes them."""
    rng = np.random.default_rng(5)
    q, k, v = _randn(rng, 3, 5, 4, 8), _randn(rng, 3, 9, 2, 8), \
        _randn(rng, 3, 9, 2, 8)
    kv_len = np.array([9, 4, 6], np.int32)
    for kw in (dict(causal=False), dict(causal=True, q_offset=4),
               dict(causal=False, sliding_window=3, q_offset=4)):
        want = np.asarray(ja.naive_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            kv_len=jnp.asarray(kv_len), **kw))
        got = ta.naive_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 kv_len=torch.from_numpy(kv_len), **kw)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL_F32, rtol=0)


# -- B4: plain version vs the Pallas kernel (interpret) ----------------------

@pytest.mark.parametrize("B,H,KV,C,hd,pos,window", [
    (2, 6, 2, 40, 16, 22, 0),      # partly filled cache
    (3, 4, 4, 32, 8, 0, 0),        # the first token only
    (2, 6, 3, 24, 16, 57, 24),     # a wrapped ring: every slot valid
    (2, 16, 1, 24, 16, 20, 0),     # G = 16 (glm4-9b's group)
    (2, 24, 2, 32, 8, 31, 0),      # G = 12 (nemotron-4-340b's), all valid
])
def test_plain_decode_matches_pallas_and_reference(B, H, KV, C, hd, pos,
                                                   window):
    rng = np.random.default_rng(C + pos)
    q = _randn(rng, B, H, hd)
    kc, vc = _randn(rng, B, C, KV, hd), _randn(rng, B, C, KV, hd)
    n_valid = min(pos + 1, C)
    got = dops.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                torch.from_numpy(vc), n_valid).numpy()
    pallas = np.asarray(jd.decode_attention_bhd(
        jnp.asarray(q)[:, None], jnp.asarray(kc), jnp.asarray(vc),
        jnp.int32(n_valid), block_k=16, interpret=True))[:, 0]
    ref = np.asarray(ja.decode_attention(
        jnp.asarray(q)[:, None], jnp.asarray(kc), jnp.asarray(vc),
        jnp.int32(pos), window=window))[:, 0]
    np.testing.assert_allclose(got, pallas, atol=ATOL_F32, rtol=0)
    np.testing.assert_allclose(got, ref, atol=ATOL_F32, rtol=0)


def test_cache_update_matches_reference_incl_ring_and_clamp():
    """One-token inserts: at ``pos``, at ``pos % C`` in a ring, and
    clamped to the last slot past the strip (``dynamic_update_slice``)."""
    rng = np.random.default_rng(2)
    cache = _randn(rng, 2, 6, 2, 4)
    new = _randn(rng, 2, 1, 2, 4)
    for pos, window in ((3, 0), (9, 6), (8, 0)):
        jk, jv = ja.cache_update_one(jnp.asarray(cache), jnp.asarray(cache),
                                     jnp.asarray(new), jnp.asarray(new),
                                     pos, window)
        tk, tv = ta.cache_update_one(torch.from_numpy(cache.copy()),
                                     torch.from_numpy(cache.copy()),
                                     torch.from_numpy(new),
                                     torch.from_numpy(new), pos, window)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# -- the mamba prefill (the scan's cold-start case, B5) ----------------------

def test_mamba_forward_matches_reference():
    jm, jp, tm, tp = _pair("hybrid")
    cfg = CFGS["hybrid"]
    j = [i for i, d in enumerate(jm.period_descs) if d[0] == "mamba"][0]
    jpl = jax.tree.map(lambda a: a[0], jp["blocks"][f"s{j}"]["mamba"])
    tpl = {k: v[0] for k, v in tp["blocks"][f"s{j}"]["mamba"].items()}
    x = _randn(np.random.default_rng(8), 2, 13, cfg.d_model)
    jy, (jconv, jssm) = jmamba.mamba_forward(jpl, cfg, jnp.asarray(x))
    ty, (tconv, tssm) = tmamba.mamba_forward(tpl, _port_cfg(cfg),
                                             torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL_F32,
                               rtol=0)
    np.testing.assert_allclose(tconv.numpy(), np.asarray(jconv),
                               atol=ATOL_F32, rtol=0)
    np.testing.assert_allclose(tssm.numpy(), np.asarray(jssm),
                               atol=ATOL_F32, rtol=0)


# -- prefill / decode_step: logits step by step ------------------------------

@pytest.mark.parametrize("name", list(CFGS))
def test_prefill_and_decode_logits_match_reference(name):
    """Prefill 11 tokens into a 24-slot cache, then 16 greedy decode
    steps (the window model's 8-slot ring wraps twice); logits at every
    step and the final caches must match."""
    jm, jp, tm, tp = _pair(name)
    toks = _prompts(3, (11, 11))
    toks = np.stack(toks)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), capacity=24,
                        cache_dtype=jnp.float32)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), capacity=24,
                        cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL_LOGITS,
                               rtol=0)
    for i in range(16):
        tok = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), 11 + i)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), 11 + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=ATOL_LOGITS, rtol=0, err_msg=str(i))
    pairs = [(jc["blocks"][f"s{j}"], tc["blocks"][f"s{j}"])
             for j in range(len(tm.period_descs))]
    pairs += list(zip(jc.get("prefix", []), tc.get("prefix", [])))
    assert len(pairs) == len(tm.period_descs) + len(tm.prefix_descs)
    for jst, tst in pairs:
        for key, ja_ in jst.items():
            assert tst[key].shape == ja_.shape, key
            np.testing.assert_allclose(tst[key].numpy(), np.asarray(ja_),
                                       atol=ATOL_LOGITS, rtol=0)


def test_init_cache_shapes_match_reference():
    for name in CFGS:
        jm, _, tm, _ = _pair(name)
        jc = jm.init_cache(3, 20, dtype=jnp.float32)
        tc = tm.init_cache(3, 20, dtype=torch.float32)
        for j in range(len(tm.period_descs)):
            for key, a in jc["blocks"][f"s{j}"].items():
                b = tc["blocks"][f"s{j}"][key]
                assert tuple(b.shape) == a.shape, (name, key)
                assert str(b.dtype)[6:] == str(a.dtype), (name, key)


# -- the dense engine: streams and counters equal the reference's ------------

def _serve_both(name, prompts, **kw):
    jm, jp, tm, tp = _pair(name)
    je = JaxEngine(jm, jp, paged=False, **kw)
    te = ServeEngine(tm, tp, device="cpu", paged=False, **kw)
    assert not je.paged and not te.paged
    jr = je.serve(prompts)
    tr = te.serve(prompts)
    assert [r.status for r in tr] == [r.status for r in jr]
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    for attr in COUNTERS:
        assert getattr(te, attr) == getattr(je, attr), attr
    jl, tl = je.loop_stats(), te.loop_stats()
    for attr in LOOP:
        assert tl[attr] == jl[attr], attr
    # every dense device step is a burst step: one blocking read of the
    # active flags before each, and one more at an early exit
    assert tl["n_flag_reads"] == (tl["n_device_steps"]
                                  + tl["n_burst_early_exits"])
    assert te.pool_stats() is None and je.pool_stats() is None
    return je, te, tr


def _eos_for(name, prompts, **kw):
    """A token the reference emits early for the first request when
    serving ``prompts`` without an eos: as eos it ends that request
    first, so the others see a mid-decode join."""
    jm, jp, _, _ = _pair(name)
    return int(JaxEngine(jm, jp, paged=False, **kw).serve(prompts)[0]
               .tokens[1])


@pytest.mark.parametrize("burst", [1, 8])
@pytest.mark.parametrize("name", list(CFGS))
def test_dense_engine_streams_match_with_joins(name, burst):
    """Six requests on two slots: one stops early at eos, so queued
    requests that fit the shared position join mid-decode (and a longer
    one waits for the next fresh wave); bursts of 1 and 8."""
    prompts = _prompts(7, (9, 12, 5, 14, 6, 10))
    kw = dict(batch_size=2, capacity=40, max_new_tokens=9)
    eos = _eos_for(name, prompts, **kw)
    je, te, _ = _serve_both(name, prompts, eos_id=eos, burst=burst, **kw)
    assert te.n_joins > 0 and te.n_prefills > 1


def test_dense_burst_k8_equals_k1():
    """The ``tests/test_burst.py`` contract on the port: bursts of 4 and
    8 give the tokens of single steps, with fewer host syncs."""
    prompts = _prompts(83, (6, 6, 6))
    _, _, tm, tp = _pair("transformer")
    runs = {}
    for k in (1, 4, 8):
        eng = ServeEngine(tm, tp, device="cpu", batch_size=3, capacity=32,
                          max_new_tokens=8, paged=False, burst=8)
        eng.burst = k
        runs[k] = (eng, [list(r.tokens) for r in eng.serve(prompts)])
    for k in (4, 8):
        assert runs[k][1] == runs[1][1], k
    assert runs[8][0].n_host_syncs < runs[1][0].n_host_syncs


@pytest.mark.parametrize("name", ["transformer", "window"])
def test_dense_engine_truncates_at_capacity(name):
    """Capacity 16: the first wave (prompts of 6) has 10 decode positions
    and the second (a prompt of 4) 12 — each request is cut there, with
    its first token, although max_new is 24; the windowed model's 8-slot
    ring wraps before that."""
    prompts = _prompts(89, (6, 6, 4))
    je, te, tr = _serve_both(name, prompts, batch_size=2, capacity=16,
                             max_new_tokens=24, burst=8)
    assert [len(r.tokens) for r in tr] == [11, 11, 13]
    assert te._pos == 16


@pytest.mark.parametrize("name", list(CFGS))
def test_generate_batch_matches_reference(name):
    jm, jp, tm, tp = _pair(name)
    prompts = np.stack(_prompts(31, (7, 7, 7)))
    kw = dict(batch_size=3, capacity=32, max_new_tokens=12)
    want = JaxEngine(jm, jp, paged=False, **kw).generate_batch(prompts)
    te = ServeEngine(tm, tp, device="cpu", paged=False, **kw)
    got = te.generate_batch(prompts)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert te.n_batches == 1 and te.n_requests == 3


# nemotron-4-340b's layer at a tiny width: layernorm, squared ReLU, rotary
# on half of each head, and its head_dim of 192 set explicitly (the smoke
# configs cap it at 64), which the bf16 tensor-core bodies now take
NEMOTRON_TINY = TINY_SERVE.replace(
    arch_id="tiny-nemotron", d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=192, norm="layernorm", mlp_act="relu2", rope_pct=0.5)


@pytest.mark.parametrize("paged", [True, False])
def test_nemotron_shaped_streams_match_reference(paged):
    """Four requests on two slots, paged (chunked prefill) and dense: the
    port's greedy streams equal the JAX engine's, and it picked the mode
    asked for."""
    if "nemotron" not in _PAIRS:
        jm = jax_build_model(NEMOTRON_TINY)
        jp = jm.init(jax.random.PRNGKey(0))
        _PAIRS["nemotron"] = (
            jm, jp, build_model(_port_cfg(NEMOTRON_TINY), device="cpu"),
            bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu"))
    jm, jp, tm, tp = _PAIRS["nemotron"]
    assert tm.cfg.resolved_head_dim == 192
    prompts = _prompts(19, (9, 12, 5, 14))
    kw = dict(batch_size=2, capacity=32, max_new_tokens=6, paged=paged)
    if paged:
        kw.update(prefill_chunk=4, block_size=4)
    jr = JaxEngine(jm, jp, **kw).serve(prompts)
    te = ServeEngine(tm, tp, device="cpu", **kw)
    tr = te.serve(prompts)
    assert te.paged == paged
    assert [r.status for r in tr] == [r.status for r in jr] == ["ok"] * 4
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(a.tokens, b.tokens)


@pytest.mark.parametrize("name", ["transformer", "window", "moe"])
def test_generate_batch_prompt_longer_than_capacity(name):
    """Prompts of 20 tokens over a 16-slot cache: without a window the
    cache keeps the first 16 positions and decode writes clamp to the
    last slot (as ``dynamic_update_slice`` does); with one, the last 8 in
    ring order.  The seeded cache is a fresh contiguous buffer, as the
    decode kernel requires."""
    jm, jp, tm, tp = _pair(name)
    prompts = np.stack(_prompts(37, (20, 20)))
    kw = dict(batch_size=2, capacity=16, max_new_tokens=6)
    want = JaxEngine(jm, jp, paged=False, **kw).generate_batch(prompts)
    got = ServeEngine(tm, tp, device="cpu", paged=False,
                      **kw).generate_batch(prompts)
    np.testing.assert_array_equal(got, np.asarray(want))
    _, cache = tm.prefill(tp, torch.from_numpy(prompts), capacity=16,
                          cache_dtype=torch.float32)
    leaves = [leaf for st in cache.get("prefix", []) for leaf in st.values()]
    for j in range(len(tm.period_descs)):
        leaves += list(cache["blocks"][f"s{j}"].values())
    assert leaves and all(leaf.is_contiguous() for leaf in leaves)


def test_dense_timeout_cancels_queued_and_inflight_requests():
    """A timeout fails the queued request and both in-flight slots with
    the tokens they have; the engine then serves a new wave cleanly."""
    _, _, tm, tp = _pair("transformer")
    eng = ServeEngine(tm, tp, device="cpu", paged=False, batch_size=2,
                      capacity=32, max_new_tokens=8, burst=2)
    rids = [eng.submit(p) for p in _prompts(4, (5, 7, 6))]
    eng.step()                        # a wave of two, one burst
    res = eng.wait(rids, timeout_s=0.0)
    assert [r.status for r in res] == ["timeout"] * 3
    assert [len(r.tokens) for r in res] == [2, 2, 0]   # K = 1: queued
    assert eng.n_active == 0 and not eng.has_work
    again = eng.serve(_prompts(4, (5,)))
    assert again[0].status == "ok" and len(again[0].tokens) == 8


def test_paged_auto_selection_and_dense_refusals():
    """``paged=None`` picks dense for a sliding-window model and paged
    otherwise; ``paged=True`` on a window model and the options that
    need the block pool raise the reference's errors."""
    jm, jp, tm, tp = _pair("window")
    assert not ServeEngine(tm, tp, device="cpu").paged
    assert not JaxEngine(jm, jp).paged
    assert ServeEngine(*_pair("transformer")[2:], device="cpu").paged
    cases = [dict(paged=True), dict(paged=False, share_prefix=True),
             dict(paged=False, kv_dtype="int8"),
             dict(paged=False, mesh=object())]
    for kw in cases:
        with pytest.raises(ValueError) as want:
            JaxEngine(jm, jp, **kw)
        with pytest.raises(ValueError) as got:
            ServeEngine(tm, tp, device="cpu", **kw)
        assert str(got.value) == str(want.value), kw
    with pytest.raises(ValueError, match="spec_k > 0 requires paged"):
        ServeEngine(tm, tp, device="cpu", paged=False, spec_k=2)
    eng = ServeEngine(tm, tp, device="cpu", paged=False)
    assert eng.kv_bytes_per_block() == 0 and not eng.share_prefix


def test_bf16_model_with_f32_cache_raises_where_the_reference_fails():
    """The reference's dense mode cannot serve a bf16 model over its
    default f32 cache either: the prefill runs, the first decode step's
    f32 K/V promote the residual stream and fail, and every request ends
    with status "error".  The port refuses the combination up front."""
    cfg = TINY_SERVE.replace(param_dtype="bfloat16",
                             compute_dtype="bfloat16")
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    kw = dict(batch_size=2, capacity=24, max_new_tokens=4, paged=False)
    res = JaxEngine(jm, jp, **kw).serve(_prompts(2, (5, 9)))
    assert [r.status for r in res] == ["error", "error"]
    tm = build_model(_port_cfg(cfg), device="cpu")
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    with pytest.raises(ValueError, match="kv_dtype='bf16'"):
        ServeEngine(tm, tp, device="cpu", **kw)
    want = JaxEngine(jm, jp, kv_dtype="bf16", **kw).serve(_prompts(2, (5, 9)))
    got = ServeEngine(tm, tp, device="cpu", kv_dtype="bf16",
                      **kw).serve(_prompts(2, (5, 9)))
    assert [r.status for r in got] == ["ok", "ok"]
    assert [len(r.tokens) for r in got] == [len(r.tokens) for r in want]


def test_dense_engine_without_a_device_needs_a_gpu():
    cfg = _port_cfg(TINY_SERVE)
    model = build_model(cfg, device="cpu")
    params = model.init(seed=0)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="one device"):
            ServeEngine(model, params, paged=False)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(model, params, paged=False)


# -- the launcher ---------------------------------------------------------------

@pytest.mark.parametrize("mode", [[], ["--direct"]])
def test_launcher_serves_dense_on_cpu(mode):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--paged", "off", "--requests", "5", "--batch",
         "2", "--max-new", "6", "--prompt-len", "20", *mode],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "served 5 requests / 30 tokens" in out.stdout
    assert "evictions=5" in out.stdout
    assert "prefill_chunks" not in out.stdout
    # capacity = prompt-len + max-new + 8, as the reference launcher sets it
    assert "dense cache: 2 slots x 34 positions" in out.stdout


@pytest.mark.parametrize("argv,msg", [
    (["--paged", "off", "--kv-dtype", "int8"], "--kv-dtype int8 and --paged off"),
    (["--paged", "off", "--spec-k", "2"], "--spec-k and --paged off"),
    (["--spec-k", "2", "--family", "hybrid"], "--spec-k and --family hybrid"),
])
def test_launcher_rejects_dense_flag_combinations(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        tserve.validate_args(tserve.build_parser().parse_args(argv))
