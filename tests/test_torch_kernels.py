"""The port's paged attention kernels against the JAX reference.

On the CPU the kernel wrappers run their plain PyTorch versions, which
must equal the reference's Pallas kernels (interpret mode) and its
``paged_attention`` within 1e-5 in f32.  The kernel-vs-plain cases need
a CUDA device and skip without one; on a card, run this file with
``JAX_PLATFORMS=cpu`` and ``--noconftest`` (the shared conftest imports
the JAX package, which a GPU machine may lack).
"""
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops

ATOL_F32 = 1e-5


@pytest.fixture(scope="module")
def ref():
    """The JAX package's paged attention and Pallas ops (CPU, interpret)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.decode_attention import ops as jd
    from repro.kernels.flash_attention import ops as jf
    from repro.models import attention as ja
    # interpret=True: the Pallas TPU kernels run as written only on a
    # TPU; on a GPU host too they must run in interpret mode
    return SimpleNamespace(jnp=jnp,
                           decode=partial(jd.paged_decode_attention_bhd,
                                          interpret=True),
                           flash=partial(jf.flash_attention_bshd,
                                         interpret=True),
                           gather=ja.paged_gather,
                           attention=ja.paged_attention)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, *, B, T, H, KV, hd, bs, P, max_len, min_len=1):
    """Random q, shuffled page tables over a pool with spare blocks, and
    lengths spread over [min_len, max_len]."""
    rng = np.random.default_rng(seed)
    nb = B * P + 3
    return dict(
        q=rng.standard_normal((B, T, H, hd)).astype(np.float32),
        k=rng.standard_normal((nb, bs, KV, hd)).astype(np.float32),
        v=rng.standard_normal((nb, bs, KV, hd)).astype(np.float32),
        pt=np.stack([rng.permutation(nb)[:P] for _ in range(B)])
        .astype(np.int32),
        lengths=rng.integers(min_len, max_len + 1, B).astype(np.int32))


def _t(a, device="cpu", dtype=None):
    t = torch.from_numpy(np.asarray(a)).to(device)
    return t.to(dtype) if dtype is not None else t


@pytest.mark.parametrize("B,H,KV,hd,bs,P", [(3, 4, 2, 16, 4, 4),
                                            (2, 6, 2, 8, 8, 3),
                                            (2, 3, 3, 16, 4, 5)])
def test_plain_paged_decode_matches_pallas_and_reference(ref, B, H, KV, hd,
                                                         bs, P):
    c = _case(B * 100 + H, B=B, T=1, H=H, KV=KV, hd=hd, bs=bs, P=P,
              max_len=P * bs)
    c["lengths"][0] = P * bs          # a slot whose pages are all full
    got = dops.paged_decode_attention(
        _t(c["q"][:, 0]), _t(c["k"]), _t(c["v"]), _t(c["pt"]),
        _t(c["lengths"])).numpy()
    jnp = ref.jnp
    pallas = np.asarray(ref.decode(jnp.asarray(c["q"]), jnp.asarray(c["k"]),
                                   jnp.asarray(c["v"]), jnp.asarray(c["pt"]),
                                   jnp.asarray(c["lengths"])))[:, 0]
    pt = jnp.asarray(c["pt"])
    plain = np.asarray(ref.attention(
        jnp.asarray(c["q"]), ref.gather(jnp.asarray(c["k"]), pt),
        ref.gather(jnp.asarray(c["v"]), pt),
        jnp.asarray(c["lengths"] - 1)[:, None]))[:, 0]
    np.testing.assert_allclose(got, pallas, atol=ATOL_F32, rtol=0)
    np.testing.assert_allclose(got, plain, atol=ATOL_F32, rtol=0)


@pytest.mark.parametrize("B,T,H,KV,hd,bs,P", [(3, 6, 4, 2, 16, 4, 6),
                                              (2, 5, 6, 3, 8, 8, 3)])
def test_plain_paged_prefill_matches_reference(ref, B, T, H, KV, hd, bs, P):
    """T query tokens per slot at positions lengths + t, including rows
    whose positions run past the page table (the gather view ends at
    P * bs, as in the reference)."""
    c = _case(7 + T, B=B, T=T, H=H, KV=KV, hd=hd, bs=bs, P=P, max_len=P * bs)
    lengths = c["lengths"] - 1        # tokens cached before the chunk
    lengths[0] = 0
    lengths[-1] = P * bs - 2          # the chunk overruns the page table
    got = fops.paged_prefill_attention(
        _t(c["q"]), _t(c["k"]), _t(c["v"]), _t(c["pt"]), _t(lengths)).numpy()
    jnp = ref.jnp
    pt = jnp.asarray(c["pt"])
    pos = lengths[:, None] + np.arange(T, dtype=np.int32)[None, :]
    want = np.asarray(ref.attention(
        jnp.asarray(c["q"]), ref.gather(jnp.asarray(c["k"]), pt),
        ref.gather(jnp.asarray(c["v"]), pt), jnp.asarray(pos)))
    np.testing.assert_allclose(got, want, atol=ATOL_F32, rtol=0)


def test_plain_paged_prefill_matches_flash_attention(ref):
    """Identity page table, nothing cached: causal attention over the
    chunk itself, as the reference's flash_attention kernel computes it
    (T a multiple of its blocks)."""
    B, T, H, KV, hd, bs = 2, 16, 4, 2, 16, 4
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    P = T // bs
    pt = np.arange(B * P, dtype=np.int32).reshape(B, P)
    got = fops.paged_prefill_attention(
        _t(q), _t(k.reshape(B * P, bs, KV, hd)),
        _t(v.reshape(B * P, bs, KV, hd)), _t(pt),
        torch.zeros(B, dtype=torch.int32)).numpy()
    jnp = ref.jnp
    want = np.asarray(ref.flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, block_q=8,
                                block_k=8))
    np.testing.assert_allclose(got, want, atol=ATOL_F32, rtol=0)


def test_wrappers_reject_unsupported_operands():
    c = _case(0, B=2, T=1, H=4, KV=2, hd=8, bs=4, P=2, max_len=8)
    q, k, v = _t(c["q"][:, 0]), _t(c["k"]), _t(c["v"])
    pt, ln = _t(c["pt"]), _t(c["lengths"])
    with pytest.raises(TypeError):
        dops.check_paged_operands(q.bfloat16(), k, v, pt, ln, 3)
    with pytest.raises(TypeError):
        dops.check_paged_operands(q, k, v, pt.long(), ln, 3)
    with pytest.raises(ValueError):
        dops.check_paged_operands(q, k[..., :4].contiguous(),
                                  v[..., :4].contiguous(), pt, ln, 3)
    with pytest.raises(ValueError):
        dops.check_paged_operands(q, k.transpose(1, 2), v, pt, ln, 3)
    with pytest.raises(ValueError, match="head_dim % 8"):
        dops.check_paged_operands(q[..., :4].contiguous(),
                                  k[..., :4].contiguous(),
                                  v[..., :4].contiguous(), pt, ln, 3)
    dops.check_paged_operands(q, k, v, pt, ln, 3)      # the valid call


# -- on the card: each kernel against its plain version ----------------------

# bf16: the plain version rounds q*scale, the scores and the normalized
# probabilities to bf16 (as the reference does); the kernel keeps scores
# in f32 and rounds the unnormalized probabilities.  Outputs are bf16 (8
# significant bits): with at least one page of keys per slot |out| < 2,
# and the two differ by a few bf16 ulps.
_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
_SERVED = dict(H=15, KV=5, hd=64, bs=16, P=40, max_len=600, min_len=16)


@pytest.mark.parametrize("B", [4, 8])
@pytest.mark.parametrize("qdt,kvdt", [(torch.float32, torch.float32),
                                      (torch.float32, torch.bfloat16),
                                      (torch.bfloat16, torch.bfloat16)])
def test_decode_kernel_matches_plain(cuda, B, qdt, kvdt):
    c = _case(B, B=B, T=1, **_SERVED)
    args = (_t(c["q"][:, 0], cuda, qdt), _t(c["k"], cuda, kvdt),
            _t(c["v"], cuda, kvdt), _t(c["pt"], cuda), _t(c["lengths"], cuda))
    n0 = dops.KERNEL.launches
    got = dops.paged_decode_attention(*args)
    want = dops.paged_decode_attention_plain(*args)
    torch.cuda.synchronize()
    assert dops.KERNEL.launches == n0 + 1
    assert got.dtype == want.dtype == kvdt
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _TOL[kvdt], err


@pytest.mark.parametrize("B", [4, 8])
@pytest.mark.parametrize("qdt,kvdt", [(torch.float32, torch.float32),
                                      (torch.bfloat16, torch.bfloat16)])
def test_prefill_kernel_matches_plain(cuda, B, qdt, kvdt):
    c = _case(B + 1, B=B, T=32, **_SERVED)
    lengths = c["lengths"] - 1        # tokens cached before the chunk
    args = (_t(c["q"], cuda, qdt), _t(c["k"], cuda, kvdt),
            _t(c["v"], cuda, kvdt), _t(c["pt"], cuda), _t(lengths, cuda))
    n0 = fops.KERNEL.launches
    got = fops.paged_prefill_attention(*args)
    want = fops.paged_prefill_attention_plain(*args)
    torch.cuda.synchronize()
    assert fops.KERNEL.launches == n0 + 1
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _TOL[kvdt], err
