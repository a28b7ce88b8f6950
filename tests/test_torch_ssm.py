"""The port's selective scan (B5) and Mamba block against the JAX
reference.

On the CPU the scan wrapper runs its plain PyTorch version, which must
equal the reference's Pallas kernel (interpret mode), its jnp scan and
``mamba_paged_step`` within 1e-5 in f32.  The kernel-vs-plain cases need
a CUDA device and skip without one; on a card, run this file with
``JAX_PLATFORMS=cpu`` and ``--noconftest`` (the JAX comparisons then
skip where JAX is missing).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssm_scan import ops as sops
from repro_torch.models import mamba as TMB
from repro_torch.models.config import ModelConfig, SSMConfig

ATOL = 1e-5
CFG = ModelConfig(arch_id="tiny-mamba", family="hybrid", n_layers=1,
                  d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                  vocab_size=64, ssm=SSMConfig(d_state=8, d_conv=4, expand=2),
                  attn_layer_period=1, attn_layer_offset=1)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's scan kernel (interpret mode), oracle and Mamba
    block, plus the tiny block's weights as numpy."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ssm_scan import ops as jops
    from repro.kernels.ssm_scan import ref as jref
    from repro.models import mamba as jm
    from repro.models.config import ModelConfig as JCfg
    from repro.models.config import SSMConfig as JSSM
    jcfg = JCfg(**{f: getattr(CFG, f) for f in
                   ("arch_id", "family", "n_layers", "d_model", "n_heads",
                    "n_kv_heads", "d_ff", "vocab_size", "attn_layer_period",
                    "attn_layer_offset")},
                ssm=JSSM(d_state=8, d_conv=4, expand=2))
    params = jax.tree.map(np.asarray,
                          jm.mamba_params(jax.random.PRNGKey(3), jcfg,
                                          jnp.float32))
    return SimpleNamespace(jnp=jnp, ops=jops, ref=jref, mamba=jm, cfg=jcfg,
                           params=params)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scan_case(seed, B, S, di, N):
    """Scan inputs as a Mamba layer makes them: dt > 0 (softplus), A < 0."""
    rng = np.random.default_rng(seed)
    return dict(
        dt=np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(np.float32),
        xs=rng.standard_normal((B, S, di)).astype(np.float32),
        Bc=rng.standard_normal((B, S, N)).astype(np.float32),
        Cc=rng.standard_normal((B, S, N)).astype(np.float32),
        A=-np.exp(rng.standard_normal((di, N)) * 0.5).astype(np.float32),
        D=rng.standard_normal((di,)).astype(np.float32),
        h0=rng.standard_normal((B, di, N)).astype(np.float32),
        t_valid=rng.integers(0, S + 1, B).astype(np.int32))


def _t(a, device="cpu", dtype=None):
    t = torch.from_numpy(np.array(a)).to(device)
    return t.to(dtype) if dtype is not None else t


@pytest.mark.parametrize("B,S,di,N,chunk_t", [(2, 13, 16, 8, 8),
                                              (3, 7, 24, 16, 4)])
def test_plain_scan_matches_pallas_cold_start(ref, B, S, di, N, chunk_t):
    """h0 = 0, every position valid: the TPU kernel's own contract, with
    S not a multiple of its time chunk (and di of its d block)."""
    c = _scan_case(B * S, B, S, di, N)
    y, h = sops.selective_scan(
        _t(c["dt"]), _t(c["xs"]), _t(c["Bc"]), _t(c["Cc"]), _t(c["A"]),
        _t(c["D"]), torch.zeros(B, di, N),
        torch.full((B,), S, dtype=torch.int32))
    jnp = ref.jnp
    jy, jh = ref.ops.selective_scan(
        jnp.asarray(c["dt"]), jnp.asarray(c["Bc"]), jnp.asarray(c["Cc"]),
        jnp.asarray(c["xs"]), jnp.asarray(c["A"]), jnp.asarray(c["D"]),
        block_d=16, chunk_t=chunk_t, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    # the model-level plain scan is the same function
    my, mh = TMB.selective_scan(_t(c["dt"]), _t(c["Bc"]), _t(c["Cc"]),
                                _t(c["xs"]), _t(c["A"]), _t(c["D"]))
    np.testing.assert_allclose(my.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(mh.numpy(), np.asarray(jh), atol=ATOL, rtol=0)


def test_plain_scan_with_carried_state_matches_oracle(ref):
    """A carried state h0 and every position valid: the reference's
    sequential oracle with ``h0``."""
    c = _scan_case(5, 3, 6, 16, 8)
    B, S = 3, 6
    y, h = sops.selective_scan(
        _t(c["dt"]), _t(c["xs"]), _t(c["Bc"]), _t(c["Cc"]), _t(c["A"]),
        _t(c["D"]), _t(c["h0"]), torch.full((B,), S, dtype=torch.int32))
    jnp = ref.jnp
    jy, jh = ref.ref.selective_scan_ref(
        jnp.asarray(c["dt"]), jnp.asarray(c["Bc"]), jnp.asarray(c["Cc"]),
        jnp.asarray(c["xs"]), jnp.asarray(c["A"]), jnp.asarray(c["D"]),
        h0=jnp.asarray(c["h0"]))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL, rtol=0)


@pytest.mark.parametrize("T", [1, 5])
def test_mamba_paged_step_matches_reference(ref, T):
    """Carried conv and SSM state, t_valid mixing 0, partial and full
    rows: outputs of the valid positions, the next conv window and the
    SSM state all within 1e-5."""
    rng = np.random.default_rng(T)
    B, dc, di, N = 4, 4, CFG.d_inner, CFG.ssm.d_state
    x = rng.standard_normal((B, T, CFG.d_model)).astype(np.float32)
    conv = rng.standard_normal((B, dc - 1, di)).astype(np.float32)
    ssm = rng.standard_normal((B, di, N)).astype(np.float32)
    t_valid = np.array([0, T, max(T - 2, 1), 1], np.int32)
    jnp = ref.jnp
    jy, (jconv, jssm) = ref.mamba.mamba_paged_step(
        {k: jnp.asarray(v) for k, v in ref.params.items()}, ref.cfg,
        jnp.asarray(x), jnp.asarray(conv), jnp.asarray(ssm),
        jnp.asarray(t_valid))
    tp = {k: _t(v) for k, v in ref.params.items()}
    ty, (tconv, tssm) = TMB.mamba_paged_step(tp, CFG, _t(x), _t(conv),
                                             _t(ssm), _t(t_valid))
    np.testing.assert_allclose(tconv.numpy(), np.asarray(jconv), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tssm.numpy(), np.asarray(jssm), atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(tssm[0].numpy(), ssm[0])   # idle row
    for b in range(B):
        n = t_valid[b]
        np.testing.assert_allclose(ty[b, :n].numpy(), np.asarray(jy)[b, :n],
                                   atol=ATOL, rtol=0)


def test_mamba_decode_and_params_match_reference(ref):
    rng = np.random.default_rng(9)
    B, di, N = 2, CFG.d_inner, CFG.ssm.d_state
    x = rng.standard_normal((B, 1, CFG.d_model)).astype(np.float32)
    conv = rng.standard_normal((B, 3, di)).astype(np.float32)
    ssm = rng.standard_normal((B, di, N)).astype(np.float32)
    jnp = ref.jnp
    jy, (jc, js) = ref.mamba.mamba_decode(
        {k: jnp.asarray(v) for k, v in ref.params.items()}, ref.cfg,
        jnp.asarray(x), jnp.asarray(conv), jnp.asarray(ssm))
    ty, (tc, ts) = TMB.mamba_decode({k: _t(v) for k, v in ref.params.items()},
                                    CFG, _t(x), _t(conv), _t(ssm))
    for a, b in ((ty, jy), (tc, jc), (ts, js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)
    # the port's init builds the same leaves; A_log and D stay f32 in bf16
    own = TMB.mamba_params(torch.Generator().manual_seed(0), CFG,
                           torch.bfloat16)
    assert set(own) == set(ref.params)
    for k, v in own.items():
        assert tuple(v.shape) == ref.params[k].shape, k
        assert v.dtype == (torch.float32 if k in ("A_log", "D")
                           else torch.bfloat16), k
    np.testing.assert_allclose(own["A_log"].numpy(), ref.params["A_log"],
                               atol=1e-6, rtol=0)


def test_scan_wrapper_rejects_unsupported_operands():
    c = {k: _t(v) for k, v in _scan_case(0, 2, 3, 8, 4).items()}
    args = [c[k] for k in ("dt", "xs", "Bc", "Cc", "A", "D", "h0", "t_valid")]
    sops.check_scan_operands(*args)                         # the valid call

    def bad(i, v):
        a = list(args)
        a[i] = v
        return a
    with pytest.raises(TypeError):
        sops.check_scan_operands(*bad(1, args[1].double()))
    with pytest.raises(TypeError):
        sops.check_scan_operands(*bad(6, args[6].bfloat16()))
    with pytest.raises(TypeError):
        sops.check_scan_operands(*bad(7, args[7].long()))
    with pytest.raises(ValueError, match="contiguous"):
        sops.check_scan_operands(*bad(0, args[0].transpose(0, 1)))
    with pytest.raises(ValueError, match="h0"):
        sops.check_scan_operands(*bad(6, args[6][:1].contiguous()))
    big = torch.zeros(2, 3, 17)
    with pytest.raises(ValueError, match="d_state"):
        sops.check_scan_operands(args[0], args[1], big, big,
                                 torch.zeros(8, 17), args[5],
                                 torch.zeros(2, 8, 17), args[7])


# -- on the card: the kernel against its plain version ------------------------

# f32: the kernel's expf and its fused multiply-adds against torch's exp
# and separate products, and its sequential N-sum against einsum's:
# values here are O(10), so f32 rounding stays well under 1e-4.
_TOL = 1e-4


@pytest.mark.parametrize("B,T,di,N", [(3, 1, 200, 8), (2, 37, 256, 16),
                                      (8, 32, 8192, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernel_matches_plain(cuda, B, T, di, N, dtype):
    c = _scan_case(B + T, B, T, di, N)
    c["t_valid"][0] = 0
    c["t_valid"][-1] = T
    args = (_t(c["dt"], cuda, dtype), _t(c["xs"], cuda, dtype),
            _t(c["Bc"], cuda, dtype), _t(c["Cc"], cuda, dtype),
            _t(c["A"], cuda), _t(c["D"], cuda), _t(c["h0"], cuda),
            _t(c["t_valid"], cuda))
    n0 = sops.KERNEL.launches
    y, h = sops.selective_scan(*args)
    wy, wh = sops.selective_scan_plain(*args)
    torch.cuda.synchronize()
    assert sops.KERNEL.launches == n0 + 1
    assert y.dtype == h.dtype == torch.float32
    assert (y - wy).abs().max().item() <= _TOL
    assert (h - wh).abs().max().item() <= _TOL
    assert torch.equal(h[0], args[6][0])            # t_valid = 0: untouched
