"""The port's top-k gating (B6) and MoE layer against the JAX reference.

On the CPU the gating wrapper runs its plain PyTorch version, whose
values and indices must equal the reference's Pallas kernel (interpret
mode) and ``jax.lax.top_k`` exactly, ties included; ``route`` and
``moe_forward`` must match within 1e-5 in f32, capacity drops included.
The kernel-vs-plain cases need a CUDA device and skip without one; on a
card, run this file with ``JAX_PLATFORMS=cpu`` and ``--noconftest``.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels.moe_gating import ops as gops
from repro_torch.models import moe as TMO
from repro_torch.models.config import ModelConfig, MoEConfig

ATOL = 1e-5


def _cfg(E=4, k=2, router="softmax", n_shared=0, cf=1.25, scale=1.0):
    return ModelConfig(arch_id="tiny-moe", family="moe", n_layers=1,
                       d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                       vocab_size=64,
                       moe=MoEConfig(n_experts=E, top_k=k, d_expert=24,
                                     router=router, n_shared=n_shared,
                                     capacity_factor=cf, routed_scale=scale))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's gating kernel (interpret mode) and MoE layer."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.moe_gating import ops as jops
    from repro.models import moe as jmoe
    from repro.models.config import ModelConfig as JCfg
    from repro.models.config import MoEConfig as JMoE

    def jcfg(cfg):
        m = cfg.moe
        return JCfg(arch_id=cfg.arch_id, family="moe", n_layers=1,
                    d_model=cfg.d_model, n_heads=4, n_kv_heads=2, d_ff=64,
                    vocab_size=64,
                    moe=JMoE(**dataclasses.asdict(m)))

    def params(cfg, seed):
        return jax.tree.map(np.array, jmoe.moe_params(
            jax.random.PRNGKey(seed), jcfg(cfg), jnp.float32))

    return SimpleNamespace(jax=jax, jnp=jnp, ops=jops, moe=jmoe, cfg=jcfg,
                           params=params)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tied_scores(seed, T, E):
    """Scores with many exact ties: values from a 3-level grid, plus rows
    that are constant, so first-index tie breaking decides the order."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 3, (T, E)).astype(np.float32) / 4.0
    s[0] = 0.5
    s[1, ::2] = 0.75
    return s


def _tree(p, fn):
    if isinstance(p, dict):
        return {k: _tree(v, fn) for k, v in p.items()}
    return fn(p)


@pytest.mark.parametrize("E", [4, 16])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_plain_topk_matches_pallas_and_lax_exactly(ref, E, k):
    scores = _tied_scores(E * 10 + k, 13, E)
    rng = np.random.default_rng(k)
    scores = np.concatenate(
        [scores, rng.standard_normal((5, E)).astype(np.float32)])
    vals, idx = gops.gating_topk(torch.from_numpy(scores), k)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    jnp = ref.jnp
    pv, pi = ref.ops.topk(jnp.asarray(scores), k, interpret=True)
    lv, li = ref.jax.lax.top_k(jnp.asarray(scores), k)
    for v, i in ((pv, pi), (lv, li)):
        np.testing.assert_array_equal(vals.numpy(), np.asarray(v))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(i))


@pytest.mark.parametrize("router", ["softmax", "sigmoid_bias"])
def test_route_matches_reference(ref, router):
    cfg = _cfg(E=8, k=2, router=router, scale=2.5)
    p = ref.params(cfg, 1)
    if router == "sigmoid_bias":
        p["router_bias"] = np.linspace(-0.2, 0.2, 8).astype(np.float32)
    x = np.random.default_rng(2).standard_normal((3, 7, 32)).astype(np.float32)
    jw, ji, jaux = ref.moe.route(_tree(p, ref.jnp.asarray), ref.cfg(cfg).moe,
                                 ref.jnp.asarray(x))
    tw, ti, taux = TMO.route(_tree(p, torch.from_numpy), cfg.moe,
                             torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL, rtol=0)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-6, rtol=0)


@pytest.mark.parametrize("E,k,router,n_shared,skew", [
    (4, 2, "softmax", 0, False),      # jamba-style
    (6, 4, "softmax", 0, True),       # dbrx-style k = 4, skewed router
    (8, 2, "sigmoid_bias", 1, True),  # dsv3-style router + shared expert
])
def test_moe_forward_matches_reference_with_drops(ref, E, k, router,
                                                  n_shared, skew):
    cfg = _cfg(E=E, k=k, router=router, n_shared=n_shared, cf=1.0)
    p = ref.params(cfg, E + k)
    if skew:
        # expert 0 wins every token: its queue overflows the capacity
        p["router"][:, 0] += 0.5
    x = np.random.default_rng(E).standard_normal((2, 9, 32)).astype(np.float32)
    x[:, :, :] += 1.0          # a shared direction the skewed column sees
    jy, jaux = ref.moe.moe_forward(_tree(p, ref.jnp.asarray), ref.cfg(cfg),
                                   ref.jnp.asarray(x))
    tp = _tree(p, torch.from_numpy)
    ty, taux = TMO.moe_forward(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-6, rtol=0)
    _, idx, _ = TMO.route(tp, cfg.moe, torch.from_numpy(x))
    C = max(min(int(np.ceil(9 * k / E * 1.0)), 9), 1)
    _, _, keep = TMO._dispatch(torch.from_numpy(x), idx, E, C)
    if skew:
        assert not keep.all(), "the skewed router should overflow a queue"


def test_position_in_expert_and_dispatch_match_reference(ref):
    """Ranks within each expert's queue and the dump-row rule, per row."""
    rng = np.random.default_rng(4)
    E, C, T, k, d = 5, 2, 6, 2, 3
    idx = rng.integers(0, E, (3, T, k)).astype(np.int32)
    x = rng.standard_normal((3, T, d)).astype(np.float32)
    xe, slot, keep = TMO._dispatch(torch.from_numpy(x), torch.from_numpy(idx),
                                   E, C)
    for b in range(3):
        jxe, jslot, jkeep, _ = ref.moe._dispatch_one_row(
            ref.jnp.asarray(x[b]), ref.jnp.asarray(idx[b]), None, E, C)
        np.testing.assert_array_equal(slot[b].numpy(), np.asarray(jslot))
        np.testing.assert_array_equal(keep[b].numpy(), np.asarray(jkeep))
        np.testing.assert_array_equal(xe[b].numpy(), np.asarray(jxe))


def test_gating_wrapper_rejects_unsupported_operands():
    s = torch.zeros(4, 16)
    gops.check_gating_operands(s, 2)                       # the valid call
    with pytest.raises(TypeError):
        gops.check_gating_operands(s.bfloat16(), 2)
    with pytest.raises(ValueError):
        gops.check_gating_operands(s.t(), 2)
    with pytest.raises(ValueError):
        gops.check_gating_operands(torch.zeros(4, 300), 2)
    with pytest.raises(ValueError):
        gops.check_gating_operands(s, 9)
    with pytest.raises(ValueError):
        gops.check_gating_operands(torch.zeros(4, 3), 4)


# -- on the card: the kernel against its plain version ------------------------

@pytest.mark.parametrize("T,E,k", [(8, 16, 2), (256, 16, 2), (37, 4, 4),
                                   (100, 256, 8), (9, 40, 3)])
def test_gating_kernel_matches_plain_exactly(cuda, T, E, k):
    rng = np.random.default_rng(T + E)
    s = torch.softmax(torch.from_numpy(
        rng.standard_normal((T, E)).astype(np.float32)), -1).to(cuda)
    for scores in (s, torch.from_numpy(_tied_scores(E, T, E)).to(cuda)):
        n0 = gops.KERNEL.launches
        vals, idx = gops.gating_topk(scores, k)
        wv, wi = gops.gating_topk_plain(scores, k)
        torch.cuda.synchronize()
        assert gops.KERNEL.launches == n0 + 1
        assert torch.equal(vals, wv) and torch.equal(idx, wi)


@pytest.mark.parametrize("E", [2, 4, 16, 17, 32, 40, 256])
def test_gating_kernel_exact_at_every_group_width(cuda, E):
    """Every sub-warp group width (E = 2 .. 32: 16 to 1 tokens a warp)
    and several experts a lane (40, 256), each k up to min(E, 8), against
    the plain version: softmax scores, a tie-laden grid, rows of +0.0
    and -0.0 mixed (equal under the tie rule: the lowest index first),
    with negative values around them, and negative rows holding one
    -0.0.  Each value carries the bits of the score it came from, sign
    of zero included; bit for bit the plain version's wherever that is
    defined (in a tie of -0.0 and +0.0 the sign of ``torch.max`` is its
    reduction order's)."""
    T = 67
    rng = np.random.default_rng(E)
    soft = torch.softmax(torch.from_numpy(
        rng.standard_normal((T, E)).astype(np.float32)), -1)
    signed = np.where(rng.random((T, E)) < 0.5, 0.0, -0.0).astype(np.float32)
    signed[:, ::3] = -rng.random((T, (E + 2) // 3)).astype(np.float32)
    lone = -rng.random((T, E)).astype(np.float32) - 0.5
    lone[np.arange(T), rng.integers(0, E, T)] = -0.0
    cases = ((soft, True), (torch.from_numpy(_tied_scores(E + 1, T, E)), True),
             (torch.from_numpy(signed), False), (torch.from_numpy(lone), True))
    for scores, defined in cases:
        scores = scores.to(cuda)
        for k in range(1, min(E, 8) + 1):
            n0 = gops.KERNEL.launches
            vals, idx = gops.gating_topk(scores, k)
            wv, wi = gops.gating_topk_plain(scores, k)
            torch.cuda.synchronize()
            assert gops.KERNEL.launches == n0 + 1
            assert torch.equal(vals, wv) and torch.equal(idx, wi), (E, k)
            own = scores.gather(1, idx.long())
            assert torch.equal(vals.view(torch.int32),
                               own.view(torch.int32)), (E, k)
            if defined:
                assert torch.equal(vals.view(torch.int32),
                                   wv.view(torch.int32)), (E, k)
