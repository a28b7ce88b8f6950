"""The port's vision-language family (qwen2-vl-72b's smoke config: 2
layers, d 256, 4/1 heads of 64, M-RoPE sections (8, 12, 12), 16 patch
rows, f32) against the JAX reference, on the CPU.

Weights come from the reference's ``init`` through the bridge; tokens and
patch embeddings from seeded numpy generators.  ``apply`` with patches
and caller positions, the prefill's logits and dense cache and the decode
steps (the reference's decode positions: the sequence index on all three
streams) must match within ``1e-4 * max(1, max|x|)``; the dense engine's
``generate_batch`` with patches and its continuous API without them must
give the reference engine's tokens, statuses and counters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serving import ServeEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.serving import ServeEngine

torch.backends.cuda.matmul.allow_tf32 = False
ARCH = "qwen2-vl-72b"
CFG = jax_get_config(ARCH, smoke=True)
TCFG = get_config(ARCH, smoke=True)
COUNTERS = ("n_prefills", "n_joins", "n_evictions", "n_batches",
            "n_requests", "_pos")
_PAIR = []


def _pair():
    if not _PAIR:
        jm = jax_build_model(CFG)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(TCFG, device="cpu")
        _PAIR.extend([jm, jp, tm,
                      bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")])
    return _PAIR


def _inputs(seed, B, S):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, TCFG.vocab_size, (B, S)).astype(np.int32)
    patches = (rng.standard_normal((B, TCFG.vision_seq, TCFG.d_model))
               * 0.02).astype(np.float32)
    return tokens, patches


def _close(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


def test_family_builds_dense_with_mrope():
    _, _, tm, _ = _pair()
    assert TCFG.rope == "mrope" and sum(TCFG.mrope_sections) == 32
    assert tm.period_descs == [("attn", "dense")] and not tm.supports_paged()


def test_apply_with_patches_and_caller_positions():
    """Patches overwrite the first 16 embeddings; caller positions (3, B,
    S) replace ``make_positions``."""
    jm, jp, tm, tp = _pair()
    tokens, patches = _inputs(1, 2, 28)
    pos = np.random.default_rng(2).integers(0, 60, (3, 2, 28)).astype(np.int32)
    jl, _ = jm.apply(jp, jnp.asarray(tokens), jnp.asarray(patches),
                     jnp.asarray(pos))
    tl, _ = tm.apply(tp, torch.from_numpy(tokens), torch.from_numpy(patches),
                     torch.from_numpy(pos))
    _close(tl, jl)
    # the patches matter
    other, _ = tm.apply(tp, torch.from_numpy(tokens), None,
                        torch.from_numpy(pos))
    assert not torch.allclose(other, tl)


def test_prefill_and_decode_match_reference():
    jm, jp, tm, tp = _pair()
    tokens, patches = _inputs(3, 2, 24)
    S, cap = 21, 28
    jl, jc = jm.prefill(jp, jnp.asarray(tokens[:, :S]), cap,
                        extra_embeds=jnp.asarray(patches),
                        cache_dtype=jnp.float32)
    tl, tc = tm.prefill(tp, torch.from_numpy(tokens[:, :S]), cap,
                        extra_embeds=torch.from_numpy(patches),
                        cache_dtype=torch.float32)
    _close(tl, jl)
    for name in ("k", "v"):
        _close(tc["blocks"]["s0"][name], jc["blocks"]["s0"][name])
    for pos in range(S, 24):
        tok = tokens[:, pos: pos + 1]
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), pos)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), pos)
        _close(tl, jl)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_generate_batch_with_patches_matches_reference_engine(dtype):
    jm, jp, tm, tp = _pair()
    prompts, patches = _inputs(4, 4, 20)
    kw = dict(batch_size=4, capacity=32, max_new_tokens=6, kv_dtype=dtype)
    want = JaxEngine(jm, jp, **kw).generate_batch(prompts,
                                                   extra_embeds=patches)
    eng = ServeEngine(tm, tp, device="cpu", **kw)
    np.testing.assert_array_equal(
        eng.generate_batch(prompts, extra_embeds=patches), np.asarray(want))


def test_continuous_api_without_patches_matches_reference_engine():
    """Five requests on two slots (a mid-decode join), text only, on the
    dense engine both sides pick for an M-RoPE model."""
    jm, jp, tm, tp = _pair()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, TCFG.vocab_size, n).astype(np.int32)
               for n in (9, 3, 20, 6, 11)]
    kw = dict(batch_size=2, capacity=40, max_new_tokens=5, burst=2)
    je = JaxEngine(jm, jp, **kw)
    te = ServeEngine(tm, tp, device="cpu", **kw)
    jr, tr = je.serve(prompts), te.serve(prompts)
    assert not te.paged and not je.paged
    assert [r.status for r in tr] == [r.status for r in jr] == ["ok"] * 5
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    for n in COUNTERS:
        assert getattr(te, n) == getattr(je, n), n


def test_launcher_serves_the_vlm_on_the_dense_engine():
    out = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "3", "--batch", "2", "--max-new", "4",
                       "--prompt-len", "24"])
    assert out["n_results"] == 3 and out["total_tokens"] == 12
    assert not out["engine"].paged
