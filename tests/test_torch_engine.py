"""The port's ServeEngine against the JAX reference's, on the CPU.

Same weights (through the bridge), same prompts: the greedy token
streams and the scheduler counters must be exactly equal.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from conftest import TINY_SERVE
from repro.models import build_model as jax_build_model
from repro.serving import ServeEngine as JaxEngine
from repro_torch import bridge
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.serving import ServeEngine

REPO = Path(__file__).resolve().parents[1]
COUNTERS = ("n_prefills", "n_joins", "n_evictions", "n_prefill_chunks",
            "n_prefix_hits", "n_shared_tokens", "n_cow_forks", "n_requests")


@pytest.fixture(scope="module")
def pair():
    jm = jax_build_model(TINY_SERVE)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(TINY_SERVE, device="cpu")
    return jm, jp, tm, bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _prompts(seed, lengths, vocab=TINY_SERVE.vocab_size):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _serve_both(pair, prompts, **kw):
    jm, jp, tm, tp = pair
    je = JaxEngine(jm, jp, **kw)
    te = ServeEngine(tm, tp, device="cpu", **kw)
    jr = je.serve(prompts)
    tr = te.serve(prompts)
    assert [r.status for r in tr] == ["ok"] * len(prompts)
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    for name in COUNTERS:
        assert getattr(te, name) == getattr(je, name), name
    jl, tl = je.loop_stats(), te.loop_stats()
    for name in ("n_bursts", "n_device_steps", "n_host_syncs",
                 "n_burst_early_exits", "n_state_uploads"):
        assert tl[name] == jl[name], name
    # the port's burst loop reads the active flags before each burst step
    # and once more where it exits early (the reference tests them on the
    # device)
    assert tl["n_flag_reads"] == (tl["n_device_steps"] - te.n_prefill_chunks
                                  + tl["n_burst_early_exits"])
    return je, te


@pytest.mark.parametrize("burst", [1, 4])
def test_greedy_streams_match_with_joins_and_chunked_prefill(pair, burst):
    """Five requests on two slots (joins mid-decode), prompts longer than
    the prefill chunk, bursts of 1 and 4."""
    prompts = _prompts(burst, (9, 3, 14, 6, 11))
    je, te = _serve_both(pair, prompts, batch_size=2, capacity=32,
                         max_new_tokens=7, prefill_chunk=4, block_size=4,
                         burst=burst)
    assert te.n_joins > 0 and te.n_prefill_chunks > len(prompts)


def test_prefix_sharing_and_cow_fork_match(pair):
    """One slot: the second request maps the first one's retained pages,
    including its partial tail page, and forks the block it writes."""
    (a,) = _prompts(21, (10,))
    prompts = [a, a[:7].copy(), np.concatenate([a[:8], a[:3]])]
    je, te = _serve_both(pair, prompts, batch_size=1, capacity=32,
                         max_new_tokens=5, prefill_chunk=4, block_size=4,
                         burst=2)
    assert te.n_prefix_hits >= 2 and te.n_cow_forks >= 1
    assert te.pool_stats()["n_live"] == 0


def test_bf16_model_with_f32_pool_raises(pair):
    cfg = TINY_SERVE.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    tm = build_model(cfg, device="cpu")
    tp = tm.init(seed=0)
    with pytest.raises(ValueError, match="kv_dtype='bf16'"):
        ServeEngine(tm, tp, device="cpu")
    with pytest.raises(ValueError, match="kv_dtype='bf16'"):
        ServeEngine(tm, tp, device="cpu", kv_dtype="f32")
    eng = ServeEngine(tm, tp, device="cpu", kv_dtype="bf16", batch_size=2,
                      capacity=24, max_new_tokens=4, block_size=4)
    res = eng.serve(_prompts(2, (5, 9)))
    assert [len(r.tokens) for r in res] == [4, 4]


@pytest.mark.parametrize("kw,exc,item", [
    # sampling and speculation are ported: what they refuse is what the
    # reference refuses
    ({"top_k": 0}, ValueError, "top_k must be >= 1"),
    ({"spec_k": 2}, ValueError, "requires draft_model="),
    # the dense mode is ported: what it refuses is what the reference's
    # dense mode refuses
    ({"paged": False, "share_prefix": True}, ValueError,
     "share_prefix=True requires paged mode"),
    ({"mesh": object()}, NotImplementedError, "A17"),
    ({"paged": False, "kv_dtype": "int8"}, ValueError,
     "int8' requires paged mode")])
def test_unsupported_options_raise(pair, kw, exc, item):
    _, _, tm, tp = pair
    with pytest.raises(exc, match=item):
        ServeEngine(tm, tp, device="cpu", **kw)


def test_unsupported_lane_family_and_listen_raise(pair):
    _, _, tm, tp = pair
    eng = ServeEngine(tm, tp, device="cpu")
    with pytest.raises(ValueError, match="unknown lane 'bulk'"):
        eng.submit(np.arange(4, dtype=np.int32), lane="bulk")
    from repro_torch.models import EncDecLM
    from repro_torch.models.config import MLAConfig, MoEConfig, SSMConfig
    # the vision-language family and the encoder-decoder (A13) are
    # ported: they build, and serve dense only
    vlm = build_model(TINY_SERVE.replace(family="vlm"), device="cpu")
    assert vlm.period_descs == [("attn", "dense")]
    encdec = build_model(TINY_SERVE.replace(family="encdec", n_enc_layers=2,
                                            enc_seq=8), device="cpu")
    assert isinstance(encdec, EncDecLM) and not encdec.supports_paged()
    # the xLSTM (A10b) and MLA (A12) families are ported: they build
    ssm = TINY_SERVE.replace(family="ssm", d_ff=0,
                             ssm=SSMConfig(slstm_every=2))
    mla = TINY_SERVE.replace(family="moe", mla=MLAConfig(),
                             moe=MoEConfig(n_experts=4, d_expert=32))
    assert build_model(ssm, device="cpu").period_descs == [
        ("mlstm", "none"), ("slstm", "none")]
    assert build_model(mla, device="cpu").period_descs == [("mla", "moe")]
    with pytest.raises(SystemExit, match="unknown or empty lanes"):
        tserve.main(["--smoke", "--device", "cpu", "--listen", "0",
                     "--lanes", "interactive,bulk"])
    # and the launcher's --family xlstm serves
    out = tserve.main(["--device", "cpu", "--family", "xlstm", "--requests",
                       "2", "--max-new", "3", "--prompt-len", "12"])
    assert out["n_results"] == 2 and out["total_tokens"] == 6


@pytest.mark.parametrize("mode", [[], ["--direct"]])
def test_launcher_serves_on_cpu(mode):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--requests", "5", "--batch", "2",
         "--max-new", "6", "--prompt-len", "20", *mode],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "served 5 requests / 30 tokens" in out.stdout
    assert "evictions=5" in out.stdout


def test_pipeline_filter_isolates_a_bad_row(pair):
    _, _, tm, tp = pair
    eng = ServeEngine(tm, tp, device="cpu", batch_size=2, capacity=24,
                      max_new_tokens=4, block_size=4)
    good = _prompts(9, (6,))[0]
    bad = good.copy()
    bad[0] = TINY_SERVE.vocab_size            # outside the vocab
    out = eng.as_pipeline_filter()(np.stack([good, bad]))
    assert out.shape == (2, 4)
    np.testing.assert_array_equal(out[0], eng.serve([good])[0].tokens)
    np.testing.assert_array_equal(out[1], np.zeros(4, np.int32))


def test_torch_filter_backend_round_trips_numpy():
    from repro_torch.core.elements.filter import TensorFilter
    f = TensorFilter("f", fn=lambda x: (x * 2, x.sum(dim=1)),
                     framework="torch", device="cpu")
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    a, b = f.invoke([x])
    assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
    np.testing.assert_array_equal(a, x * 2)
    np.testing.assert_array_equal(b, x.sum(axis=1))
    with pytest.raises(ValueError, match="pass_meta"):
        TensorFilter("g", fn=lambda x: x, framework="torch", pass_meta=True)
