"""The port's encoder-decoder (``EncDecLM``, whisper-tiny's smoke config:
2 + 2 layers, d 256, 4 heads, 64 encoder frames, f32) against the JAX
reference, on the CPU.

Weights come from the reference's ``init`` through the bridge; tokens and
frames from seeded numpy generators (the reference's ``jax.random``
frames cannot be drawn by torch).  Encoder states, logits and the dense
cache must match within ``1e-4 * max(1, max|x|)`` (f32, TF32 off); the
port's prefill plus decode steps must give its own ``apply``'s logits
within the same bound; a decoder prompt longer than the encoder's frames
runs (its cross-attention has S > T); the dense engine's
``generate_batch`` with frames must equal the reference engine's tokens;
the continuous API and the launcher refuse the model with a
``ValueError`` naming ``generate_batch``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import encdec as JE
from repro.serving import ServeEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import EncDecLM, build_model
from repro_torch.models import encdec as TE
from repro_torch.models import frontends
from repro_torch.serving import ServeEngine

torch.backends.cuda.matmul.allow_tf32 = False
ARCH = "whisper-tiny"
CFG = jax_get_config(ARCH, smoke=True)
TCFG = get_config(ARCH, smoke=True)
B = 2
_PAIR = []


def _pair():
    """(jax model, jax params, port model, port params), built once."""
    if not _PAIR:
        jm = jax_build_model(CFG)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(TCFG, device="cpu")
        _PAIR.extend([jm, jp, tm,
                      bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")])
    return _PAIR


def _frames(seed, batch=B):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(frontends.audio_frames_shape(TCFG, batch))
            * 0.02).astype(np.float32)


def _tokens(seed, S, batch=B):
    return np.random.default_rng(seed).integers(
        0, TCFG.vocab_size, (batch, S)).astype(np.int32)


def _close(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=0)


def test_build_init_tree_and_frontends():
    """``build_model`` gives an ``EncDecLM`` whose ``init`` builds the
    reference's tree; the frontend stubs have the reference's shapes and
    draw from an explicit generator."""
    _, jp, tm, tp = _pair()
    assert isinstance(tm, EncDecLM) and not tm.supports_paged()
    own = tm.init(seed=0)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, tp))
    for o, t in zip(jax.tree.leaves(own), jax.tree.leaves(tp)):
        assert o.shape == t.shape and o.dtype == t.dtype
    np.testing.assert_allclose(TE._sinusoid(70, 256).numpy(),
                               np.asarray(JE._sinusoid(70, 256)), atol=1e-6)
    vcfg = get_config("qwen2-vl-72b", smoke=True)
    g = torch.Generator().manual_seed(3)
    a = frontends.fake_audio_frames(TCFG, 2, g)
    p = frontends.fake_vision_patches(vcfg, 3, torch.Generator().manual_seed(3))
    assert tuple(a.shape) == (2, 64, 256) and tuple(p.shape) == (3, 16, 256)
    assert torch.equal(a, frontends.fake_audio_frames(
        TCFG, 2, torch.Generator().manual_seed(3)))
    assert 0.01 < a.std().item() < 0.03


def test_encode_and_apply_match_reference():
    jm, jp, tm, tp = _pair()
    frames, tokens = _frames(1), _tokens(2, 12)
    _close(tm.encode(tp, torch.from_numpy(frames)),
           jm.encode(jp, jnp.asarray(frames)))
    tl, aux = tm.apply(tp, torch.from_numpy(tokens), torch.from_numpy(frames))
    jl, _ = jm.apply(jp, jnp.asarray(tokens), jnp.asarray(frames))
    _close(tl, jl)
    assert aux.item() == 0.0
    with pytest.raises(ValueError, match="encoder frames"):
        tm.apply(tp, torch.from_numpy(tokens))


def test_prefill_and_decode_match_reference_and_own_apply():
    """Prefill logits and every cache leaf, then three decode steps,
    against the reference; the port's prefill + decode logits equal its
    own ``apply`` at those positions."""
    jm, jp, tm, tp = _pair()
    frames, tokens = _frames(3), _tokens(4, 13)
    S, cap = 10, 16
    jl, jc = jm.prefill(jp, jnp.asarray(tokens[:, :S]), cap,
                        extra_embeds=jnp.asarray(frames),
                        cache_dtype=jnp.float32)
    tl, tc = tm.prefill(tp, torch.from_numpy(tokens[:, :S]), cap,
                        extra_embeds=torch.from_numpy(frames),
                        cache_dtype=torch.float32)
    _close(tl, jl)
    for name in ("k", "v", "cross_k", "cross_v"):
        _close(tc[name], jc[name])
    full, _ = tm.apply(tp, torch.from_numpy(tokens), torch.from_numpy(frames))
    _close(tl, full[:, S - 1].numpy())
    for pos in range(S, 13):
        tok = tokens[:, pos: pos + 1]
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), pos)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), pos)
        _close(tl, jl)
        _close(tl, full[:, pos].numpy())


def test_decoder_prompt_longer_than_encoder_frames():
    """A 80-token decoder prompt over 64 frames: the cross-attention runs
    80 queries over 64 keys, as the reference's."""
    jm, jp, tm, tp = _pair()
    frames, tokens = _frames(5), _tokens(6, 80)
    assert tokens.shape[1] > TCFG.enc_seq
    tl, _ = tm.apply(tp, torch.from_numpy(tokens), torch.from_numpy(frames))
    jl, _ = jm.apply(jp, jnp.asarray(tokens), jnp.asarray(frames))
    _close(tl, jl)


def test_generate_batch_with_frames_matches_reference_engine():
    jm, jp, tm, tp = _pair()
    frames, prompts = _frames(7, 4), _tokens(8, 6, 4)
    kw = dict(batch_size=4, capacity=24, max_new_tokens=8, kv_dtype="f32")
    want = JaxEngine(jm, jp, **kw).generate_batch(prompts, extra_embeds=frames)
    eng = ServeEngine(tm, tp, device="cpu", **kw)
    assert not eng.paged
    got = eng.generate_batch(prompts, extra_embeds=frames)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert eng.n_batches == 1 and eng.n_requests == 4


def test_continuous_api_and_launcher_refuse_encdec():
    _, _, tm, tp = _pair()
    eng = ServeEngine(tm, tp, device="cpu", batch_size=2)
    for call in (lambda: eng.submit(np.arange(4, dtype=np.int32)),
                 lambda: eng.serve([np.arange(4, dtype=np.int32)]),
                 lambda: tserve.main(["--arch", ARCH, "--smoke", "--device",
                                      "cpu", "--requests", "1"])):
        with pytest.raises(ValueError, match=r"generate_batch\(prompts, "
                                             r"extra_embeds=frames\)"):
            call()
    assert eng.n_requests == 0
