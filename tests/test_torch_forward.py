"""The port's full-sequence forward (``TransformerLM.apply``), its
positions and M-RoPE, against the JAX reference, on the CPU.

Weights come from the reference's ``init`` through the bridge and inputs
from seeded numpy generators, in f32 (TF32 off).  ``apply``'s logits and
MoE aux loss must match the reference's within ``1e-4 * max(1,
max|logits|)`` on every smoke config of ``ARCH_IDS`` but whisper-tiny
(the encoder-decoder: ``test_torch_encdec.py``), the VLM with patch
embeddings; positions must be equal; ``apply_mrope`` within 1e-6; the
last row of ``apply`` within the same bound of the port's own
``prefill`` logits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import common as JC
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT

torch.backends.cuda.matmul.allow_tf32 = False
ARCHS = [a for a in ARCH_IDS if a != "whisper-tiny"]
B, S = 2, 24        # S > the VLM smoke config's vision_seq (16)
_PAIRS = {}


def _pair(arch):
    """(jax model, jax params, port model, port params), built once."""
    if arch not in _PAIRS:
        jm = jax_build_model(jax_get_config(arch, smoke=True))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(get_config(arch, smoke=True), device="cpu")
        _PAIRS[arch] = (jm, jp, tm,
                        bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu"))
    return _PAIRS[arch]


def _inputs(cfg, seed):
    """Tokens (B, S) and, for the VLM, patch embeddings (B, vision_seq,
    d), from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    patches = None
    if cfg.vision_seq:
        patches = (rng.standard_normal((B, cfg.vision_seq, cfg.d_model))
                   * 0.02).astype(np.float32)
    return tokens, patches


def _tol(want) -> float:
    return 1e-4 * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_matches_reference(arch):
    """Logits (B, S, V) and the MoE aux loss summed over layers."""
    jm, jp, tm, tp = _pair(arch)
    tokens, patches = _inputs(tm.cfg, len(arch))
    jl, jaux = jm.apply(jp, jnp.asarray(tokens),
                        None if patches is None else jnp.asarray(patches))
    tl, taux = tm.apply(tp, torch.from_numpy(tokens),
                        None if patches is None else torch.from_numpy(patches))
    jl = np.asarray(jl)
    assert tuple(tl.shape) == jl.shape == (B, S, tm.cfg.vocab_size)
    assert taux.dtype == torch.float32 and taux.dim() == 0
    np.testing.assert_allclose(tl.numpy(), jl, atol=_tol(jl), rtol=0)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-6, rtol=1e-5)
    if tm.cfg.moe is not None:
        assert taux.item() > 0


@pytest.mark.parametrize("arch", ["smollm-360m", "jamba-v0.1-52b",
                                  "deepseek-v3-671b", "xlstm-350m",
                                  "qwen2-vl-72b"])
def test_apply_last_row_matches_prefill(arch):
    """``apply``'s last position equals the port's own ``prefill`` logits
    (the same positions and embeddings, patches included)."""
    _, _, tm, tp = _pair(arch)
    tokens, patches = _inputs(tm.cfg, 7)
    t = torch.from_numpy(tokens)
    extra = None if patches is None else torch.from_numpy(patches)
    logits, _ = tm.apply(tp, t, extra)
    last, _ = tm.prefill(tp, t, capacity=S + 4, extra_embeds=extra,
                         cache_dtype=torch.float32)
    want = logits[:, -1].numpy()
    np.testing.assert_allclose(last.numpy(), want, atol=_tol(want), rtol=0)


@pytest.mark.parametrize("arch,S_,offset", [
    ("smollm-360m", 9, 0), ("smollm-360m", 9, 5),
    ("qwen2-vl-72b", 12, 0),            # no room for text: plain streams
    ("qwen2-vl-72b", 16, 0),            # exactly the vision prefix
    ("qwen2-vl-72b", 30, 0), ("qwen2-vl-72b", 30, 3)])
def test_make_positions_match_reference(arch, S_, offset):
    """(B, S) positions, or the (3, B, S) M-RoPE streams with and without
    a vision prefix, exactly."""
    jcfg, tcfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    want = np.asarray(JT.make_positions(jcfg, 3, S_, offset))
    got = TT.make_positions(tcfg, 3, S_, offset)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sections,hd", [((16, 24, 24), 128),
                                         ((10, 11, 11), 64)])
def test_apply_mrope_matches_reference(sections, hd):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 11, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 300, (3, 2, 11)).astype(np.int32)
    want = np.asarray(JC.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                     1e6, sections))
    got = TC.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                         sections)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="sum to head_dim/2"):
        TC.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                       (1, 2, 3))
