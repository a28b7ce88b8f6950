"""The port's attention kernels, its fused transform (B7) and the
selective scan's backward (B5') against the JAX reference and their
plain versions.

On the CPU the kernel wrappers run their plain PyTorch versions, which
must equal the reference's Pallas kernels (interpret mode) and its
``paged_attention`` within 1e-5 in f32.  The kernel-vs-plain cases need
a CUDA device and skip without one; on a card, run this file with
``JAX_PLATFORMS=cpu`` and ``--noconftest`` (the shared conftest imports
the JAX package, which a GPU machine may lack).
"""
import ctypes
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.ssm_scan import ops as sops
from repro_torch.kernels.transform import ops as tops

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
                           decode_quant=partial(
                               jd.paged_decode_attention_quant_bhd,
                               interpret=True),
                           gather=ja.paged_gather,
                           attention=ja.paged_attention,
                           quantize=ja.quantize_kv,
                           dequantize=ja.dequantize_kv)


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
                                            (2, 3, 3, 16, 4, 5),
                                            (2, 16, 1, 16, 4, 4),   # G = 16
                                            (2, 24, 2, 8, 4, 3)])   # G = 12
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


def test_library_hash_covers_included_headers(tmp_path):
    """A kernel library is rebuilt when a header that its source includes
    with quotes changes, directly or through another header."""
    from repro_torch.kernels import build
    (tmp_path / "inc").mkdir()
    src, body = tmp_path / "k.cu", tmp_path / "inc" / "body.cuh"
    common = tmp_path / "common.cuh"
    src.write_text('#include "inc/body.cuh"\n#include <cuda_runtime.h>\n')
    body.write_text('#pragma once\n#include "../common.cuh"\n')
    common.write_text("// one\n")
    assert [f.name for f in build.source_files(src)] == \
        ["k.cu", "body.cuh", "common.cuh"]
    before = build.library_path("k", src)
    assert build.library_path("k", src) == before
    common.write_text("// two\n")
    assert build.library_path("k", src) != before


_PREFILL_BODIES = ["prefill_tf32.cuh", "common.cuh", "prefill_mma.cuh",
                   "prefill_body.cuh"]


@pytest.mark.parametrize("kernel,bodies", [
    (dops.KERNEL, ["decode_gqa_mma.cuh", "prefill_tf32.cuh", "common.cuh",
                   "prefill_mma.cuh", "decode_body.cuh"]),
    (dops.DENSE_KERNEL, ["decode_mla.cuh", "common.cuh", "decode_gqa_mma.cuh",
                         "prefill_tf32.cuh", "prefill_mma.cuh",
                         "decode_body.cuh"]),
    (dops.QUANT_KERNEL, ["decode_gqa_mma.cuh", "prefill_tf32.cuh",
                         "common.cuh", "prefill_mma.cuh", "decode_body.cuh"]),
    (fops.KERNEL, _PREFILL_BODIES), (fops.FLASH_KERNEL, _PREFILL_BODIES),
    (fops.QUANT_KERNEL, ["prefill_tf32.cuh", "common.cuh",
                         "prefill_body.cuh"])])
def test_attention_kernels_share_their_family_body(kernel, bodies):
    """The paged and contiguous entries of each attention family are
    built from shared bodies and the shared helpers: the paged and
    contiguous prefill entries also from the two tensor-core bodies, the
    int8 prefill from the split-TF32 one, the paged, dense and int8 decode
    also from the tensor-core decode body (which takes the prefill bodies'
    mma.sync and split-TF32 helpers), the dense decode also from the MLA
    body."""
    from repro_torch.kernels import build
    names = [f.name for f in build.source_files(kernel.source)]
    assert names == [kernel.source.name] + bodies


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


_JAMBA = dict(H=32, KV=8, hd=128, bs=16, P=40, max_len=600, min_len=16)


@pytest.mark.parametrize("T", [1, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_at_jamba_heads(cuda, T, dtype):
    """Jamba's attention geometry (32 query / 8 KV heads, head_dim 128):
    both kernels stage ~70 KB of dynamic shared memory, above the 48 KB
    default, which the wrappers opt into."""
    c = _case(T + 5, B=8, T=T, **_JAMBA)
    lengths = c["lengths"] - (T > 1)
    q = c["q"][:, 0] if T == 1 else c["q"]
    args = (_t(q, cuda, dtype), _t(c["k"], cuda, dtype),
            _t(c["v"], cuda, dtype), _t(c["pt"], cuda), _t(lengths, cuda))
    ops = dops if T == 1 else fops
    kern = dops.paged_decode_attention if T == 1 else \
        fops.paged_prefill_attention
    plain = dops.paged_decode_attention_plain if T == 1 else \
        fops.paged_prefill_attention_plain
    n0 = ops.KERNEL.launches
    got = kern(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    assert ops.KERNEL.launches == n0 + 1
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _TOL[dtype], err


# -- the dense engine's kernels: contiguous flash prefill (B2) and dense
#    decode (B4), each against its plain version on the card ------------------

def _dense_qkv(seed, B, S, T, heads, dtype, device):
    rng = np.random.default_rng(seed)
    H, KV, hd = heads["H"], heads["KV"], heads["hd"]
    return (_t(rng.standard_normal((B, S, H, hd)).astype(np.float32),
               device, dtype),
            _t(rng.standard_normal((B, T, KV, hd)).astype(np.float32),
               device, dtype),
            _t(rng.standard_normal((B, T, KV, hd)).astype(np.float32),
               device, dtype))


_SMOLLM = dict(H=15, KV=5, hd=64)
_JAMBA_HEADS = dict(H=32, KV=8, hd=128)


@pytest.mark.parametrize("S,window", [(512, 0), (512, 128), (77, 0),
                                      (77, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, S, window, dtype):
    """Causal, causal with a window, and S not a multiple of the kernel's
    16-token query tile or 32-key tile."""
    q, k, v = _dense_qkv(S + window, 2, S, S, _SMOLLM, dtype, cuda)
    n0 = fops.FLASH_KERNEL.launches
    got = fops.flash_attention(q, k, v, causal=True, sliding_window=window)
    want = fops.flash_attention_plain(q, k, v, causal=True,
                                      sliding_window=window)
    torch.cuda.synchronize()
    assert fops.FLASH_KERNEL.launches == n0 + 1
    assert got.dtype == want.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _TOL[dtype], err


@pytest.mark.parametrize("heads", [_SMOLLM, _JAMBA_HEADS])
@pytest.mark.parametrize("n_valid", [1, 300, 576])
@pytest.mark.parametrize("qdt,kvdt", [(torch.float32, torch.float32),
                                      (torch.float32, torch.bfloat16),
                                      (torch.bfloat16, torch.bfloat16)])
def test_dense_decode_kernel_matches_plain(cuda, heads, n_valid, qdt, kvdt):
    """A first token, a partly filled cache and a full one (a wrapped
    ring: every slot valid)."""
    q, k, v = _dense_qkv(n_valid, 8, 1, 576, heads, torch.float32, cuda)
    q, k, v = q[:, 0].to(qdt).contiguous(), k.to(kvdt), v.to(kvdt)
    n0 = dops.DENSE_KERNEL.launches
    got = dops.decode_attention(q, k, v, n_valid)
    want = dops.decode_attention_plain(q, k, v, n_valid)
    torch.cuda.synchronize()
    assert dops.DENSE_KERNEL.launches == n0 + 1
    assert got.dtype == want.dtype == kvdt
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _TOL[kvdt], err


def test_dense_wrappers_reject_unsupported_operands():
    q, k, v = _dense_qkv(0, 2, 8, 8, dict(H=4, KV=2, hd=8), torch.float32,
                         "cpu")
    with pytest.raises(ValueError, match="causal"):
        fops.check_flash_operands(q, k, v, False, 4)
    with pytest.raises(ValueError, match="1 <= S <= T"):
        fops.check_flash_operands(q, k[:, :4].contiguous(),
                                  v[:, :4].contiguous(), True, 0)
    with pytest.raises(TypeError):
        fops.check_flash_operands(q, k.bfloat16(), v, True, 0)
    fops.check_flash_operands(q, k, v, True, 4)        # the valid call
    qd = q[:, 0].contiguous()
    with pytest.raises(ValueError, match="n_valid"):
        dops.check_dense_operands(qd, k, v, 9)
    with pytest.raises(TypeError):
        dops.check_dense_operands(qd.bfloat16(), k, v, 3)
    with pytest.raises(ValueError, match="contiguous"):
        dops.check_dense_operands(qd, k.transpose(1, 2), v, 3)
    dops.check_dense_operands(qd, k, v, 8)             # the valid call


def test_flash_check_takes_more_queries_than_keys_without_causal_mask():
    """Decoder queries over encoder keys: S > T passes without the causal
    mask; S = 0 or T = 0 never does."""
    q, k, v = _dense_qkv(0, 2, 8, 3, dict(H=4, KV=2, hd=8), torch.float32,
                         "cpu")
    fops.check_flash_operands(q, k, v, False, 0)
    for qq, kk in ((q[:, :0], k), (q, k[:, :0])):
        with pytest.raises(ValueError, match="queries over"):
            fops.check_flash_operands(qq.contiguous(), kk.contiguous(),
                                      kk.contiguous(), False, 0)


# the whisper-tiny geometry: 6/6 heads of 64; qwen2-vl-72b's: 64/8 of 128
_WHISPER = dict(H=6, KV=6, hd=64)
_QWEN2VL = dict(H=64, KV=8, hd=128)


@pytest.mark.parametrize("S,T", [(150, 150), (80, 64), (1500, 1500)])
@pytest.mark.parametrize("heads", [_WHISPER, _JAMBA_HEADS],
                         ids=["whisper", "jamba"])
@pytest.mark.parametrize("dtype,entry", [
    (torch.bfloat16, "flash_attention_bf16_mma"),
    (torch.float32, "flash_attention_f32_tf32")])
def test_flash_kernel_without_causal_mask_matches_plain(cuda, heads, S, T,
                                                        dtype, entry):
    """B2 bidirectional on the tensor-core bodies: the whisper encoder's
    self-attention (S = T, no multiple of a 64-key tile, masked at kpos >=
    T alone) and its decoder's cross-attention with more queries than
    keys (S > T)."""
    q, k, v = _dense_qkv(S + T + heads["hd"], 2, S, T, heads, dtype, cuda)
    before = _entry_counts(fops.FLASH_KERNEL)
    got = fops.flash_attention(q, k, v, causal=False)
    want = fops.flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    _assert_one_launch_of(fops.FLASH_KERNEL, before, entry)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= (ATOL_F32 if dtype == torch.float32
                   else _TOL[torch.bfloat16]), err


@pytest.mark.parametrize("heads,C,n_valid", [(_WHISPER, 1500, 1500),
                                             (_WHISPER, 64, 64),
                                             (_QWEN2VL, 1184, 1153)],
                         ids=["whisper_cross", "whisper_smoke_cross",
                              "qwen2vl"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_kernel_at_slice_shapes_matches_plain(cuda, heads, C,
                                                           n_valid, dtype):
    """B4 over the whole cross cache (one query, no mask: every one of
    enc_seq slots valid) and at qwen2-vl's heads."""
    q, k, v = _dense_qkv(C + n_valid, 8, 1, C, heads, dtype, cuda)
    q = q[:, 0].contiguous()
    n0 = dops.DENSE_KERNEL.launches
    got = dops.decode_attention(q, k, v, n_valid)
    want = dops.decode_attention_plain(q, k, v, n_valid)
    torch.cuda.synchronize()
    assert dops.DENSE_KERNEL.launches == n0 + 1
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _TOL[dtype], err


# -- the tensor-core prefill body (prefill_mma.cuh): bf16 at hd 64 / 128 -----

def _entry_counts(kernel):
    return dict(kernel.entry_launches)


def _assert_one_launch_of(kernel, before, entry):
    """Exactly one launch since ``before``, and of ``entry``."""
    after = _entry_counts(kernel)
    assert {e: after[e] - before[e] for e in after} == \
        {e: int(e == entry) for e in after}


_SMOLLM_PAGED = dict(H=15, KV=5, hd=64, bs=16, P=8)
_JAMBA_PAGED = dict(H=32, KV=8, hd=128, bs=16, P=8)
# nemotron-4-340b: 96/8 heads of 192 (G = 12), V as wide
_NEMOTRON = dict(H=96, KV=8, hd=192)
_NEMOTRON_PAGED = dict(_NEMOTRON, bs=16, P=8)


@pytest.mark.parametrize("T", [5, 17, 32])
@pytest.mark.parametrize("heads", [_SMOLLM_PAGED, _JAMBA_PAGED,
                                   _NEMOTRON_PAGED],
                         ids=["smollm", "jamba", "nemotron"])
def test_prefill_mma_kernel_matches_plain(cuda, heads, T):
    """bf16 K2 on the tensor-core body: a slot with nothing cached (every
    prompt's first chunk), a chunk that straddles a page boundary, one
    that ends at the page table's end, and T * G rows that are no
    multiple of the 16-row warp tile (T = 5, 17 at G = 3)."""
    B = 4
    c = _case(T + heads["hd"], B=B, T=T, max_len=heads["P"] * 16 - T,
              **heads)
    lengths = c["lengths"]
    lengths[0] = 0
    lengths[1] = 2 * heads["bs"] - 3           # straddles pages 1 and 2
    lengths[2] = heads["P"] * heads["bs"] - T  # the last page's last key
    args = (_t(c["q"], cuda, torch.bfloat16), _t(c["k"], cuda, torch.bfloat16),
            _t(c["v"], cuda, torch.bfloat16), _t(c["pt"], cuda),
            _t(lengths, cuda))
    before = _entry_counts(fops.KERNEL)
    got = fops.paged_prefill_attention(*args)
    want = fops.paged_prefill_attention_plain(*args)
    torch.cuda.synchronize()
    _assert_one_launch_of(fops.KERNEL, before,
                          "paged_prefill_attention_bf16_bf16_mma")
    assert got.dtype == want.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _TOL[torch.bfloat16], err


@pytest.mark.parametrize("S,window", [(77, 0), (77, 16), (77, 128),
                                      (512, 0), (512, 16), (512, 128)])
@pytest.mark.parametrize("heads", [_SMOLLM, _JAMBA_HEADS, _NEMOTRON],
                         ids=["smollm", "jamba", "nemotron"])
def test_flash_mma_kernel_matches_plain(cuda, heads, S, window):
    """bf16 B2 contiguous on the tensor-core body: causal, with windows
    narrower and wider than a 64-key tile, S no multiple of a tile."""
    q, k, v = _dense_qkv(S + window + heads["hd"], 2, S, S, heads,
                         torch.bfloat16, cuda)
    before = _entry_counts(fops.FLASH_KERNEL)
    got = fops.flash_attention(q, k, v, causal=True, sliding_window=window)
    want = fops.flash_attention_plain(q, k, v, causal=True,
                                      sliding_window=window)
    torch.cuda.synchronize()
    _assert_one_launch_of(fops.FLASH_KERNEL, before, "flash_attention_bf16_mma")
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _TOL[torch.bfloat16], err


def test_bf16_head_dim_32_stays_on_the_cuda_core_body(cuda):
    """bf16 at a head_dim the tensor-core body is not built for runs the
    CUDA-core body, paged and contiguous."""
    heads = dict(H=4, KV=2, hd=32)
    c = _case(11, B=2, T=9, bs=16, P=4, max_len=40, min_len=16, **heads)
    args = (_t(c["q"], cuda, torch.bfloat16), _t(c["k"], cuda, torch.bfloat16),
            _t(c["v"], cuda, torch.bfloat16), _t(c["pt"], cuda),
            _t(c["lengths"], cuda))
    before = _entry_counts(fops.KERNEL)
    got = fops.paged_prefill_attention(*args)
    want = fops.paged_prefill_attention_plain(*args)
    torch.cuda.synchronize()
    _assert_one_launch_of(fops.KERNEL, before,
                          "paged_prefill_attention_bf16_bf16")
    assert (got.float() - want.float()).abs().max().item() <= \
        _TOL[torch.bfloat16]
    q, k, v = _dense_qkv(12, 2, 40, 40, heads, torch.bfloat16, cuda)
    before = _entry_counts(fops.FLASH_KERNEL)
    got = fops.flash_attention(q, k, v, causal=True)
    want = fops.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    _assert_one_launch_of(fops.FLASH_KERNEL, before, "flash_attention_bf16")
    assert (got.float() - want.float()).abs().max().item() <= \
        _TOL[torch.bfloat16]


# -- MLA's operands (DeepSeek-V3: q/k 128 + 64 with the rope key shared by
#    every head, V 128): B2's and B4's MLA entries ------------------------------

_MLA = (128, 64, 128)


def _bf16_ulp(want):
    """One bf16 ulp at the largest |want| (chip_smoke's MLA unit)."""
    amax = want.float().abs().max().item()
    return 2.0 ** (np.floor(np.log2(amax)) - 7)


def _mla_operands(seed, B, S, T, C, H, device, dims=_MLA,
                  dtype=torch.bfloat16):
    """q (B, S, H, nope + rope), k_nope (B, T, H, nope), the rope keys
    (B, C, rope) and V (B, T, H, vd) from a seeded numpy generator."""
    nope, rope, vd = dims
    rng = np.random.default_rng(seed)
    return tuple(_t(rng.standard_normal(shape).astype(np.float32), device,
                    dtype)
                 for shape in ((B, S, H, nope + rope), (B, T, H, nope),
                               (B, C, rope), (B, T, H, vd)))


@pytest.mark.parametrize("B,S,H", [(2, 77, 128), (1, 128, 128), (2, 512, 16),
                                   (1, 1, 128)])
def test_mla_flash_kernel_matches_plain(cuda, B, S, H):
    """B2's MLA entry (the tensor-core body at q/k 192, V 128, the K tile
    assembled from k_nope and the shared rope key): S no multiple of the
    64-row block, the served S = 128, S = 512, one token; within phase
    3's tolerance (one bf16 ulp of the largest output, at least 2e-2)."""
    q, kn, kr, v = _mla_operands(S + H, B, S, S, S, H, cuda)
    before = _entry_counts(fops.FLASH_KERNEL)
    got = fops.mla_flash_attention(q, kn, kr, v)
    want = fops.mla_flash_attention_plain(q, kn, kr, v)
    torch.cuda.synchronize()
    _assert_one_launch_of(fops.FLASH_KERNEL, before,
                          "flash_attention_mla_bf16_mma")
    assert got.shape == want.shape == (B, S, H, 128)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= max(_TOL[torch.bfloat16], _bf16_ulp(want)), err


# B4's MLA entry: (B, H, T, C, n_valid), n_valid "warp" the keys of one
# tile for each warp of the body's block (read from the built kernel), so
# each warp's run ends on a tile edge, "warp+1" one key more
_MLA_DECODE_CASES = {
    "one_split-1": (8, 128, 576, 640, 1),
    "one_split-warp": (8, 128, 576, 640, "warp"),
    "one_split-warp+1": (8, 128, 576, 640, "warp+1"),
    "one_split-129": (8, 128, 576, 640, 129),
    "one_split-576": (8, 128, 576, 640, 576),
    "served-144": (8, 128, 144, 144, 144),
    "splits-1": (2, 8, 576, 640, 1),
    "splits-129": (2, 8, 576, 640, 129),
    "splits-576": (2, 8, 576, 640, 576),
    "splits_128_heads-576": (2, 128, 576, 640, 576)}


@pytest.mark.parametrize("case", list(_MLA_DECODE_CASES))
def test_mla_decode_kernel_matches_plain(cuda, case):
    """B4's MLA entry (``csrc/decode_mla.cuh``): k_nope/V for T slots, the
    rope keys read in place from a C-slot latent cache; one split per
    pair at 128 heads and B = 8, the split-and-combine path at B = 2
    (its partials V-wide); one key, each warp's run ending on a tile edge
    and one key past it, a ragged last tile (129), the served 144 of 144;
    within phase 3's tolerance (two bf16 ulps of the largest output, at
    least 6e-3), and two launches give the same bits."""
    B, H, T, C, n_valid = _MLA_DECODE_CASES[case]
    if isinstance(n_valid, str):
        occ = dops.mla_decode_occupancy()
        n_valid = occ["warps"] * occ["tile_keys"] + (n_valid == "warp+1")
    q, kn, kr, v = _mla_operands(n_valid + H, B, 1, T, C, H, cuda)
    q = q[:, 0].contiguous()
    before = _entry_counts(dops.DENSE_KERNEL)
    got = dops.mla_decode_attention(q, kn, kr, v, n_valid)
    again = dops.mla_decode_attention(q, kn, kr, v, n_valid)
    want = dops.mla_decode_attention_plain(q, kn, kr, v, n_valid)
    torch.cuda.synchronize()
    after = _entry_counts(dops.DENSE_KERNEL)
    assert {e: after[e] - before[e] for e in after} == \
        {e: 2 * (e == "decode_attention_mla_bf16") for e in after}
    assert got.shape == want.shape == (B, H, 128)
    assert torch.equal(got, again)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= max(6e-3, 2 * _bf16_ulp(want)), err


def test_mla_f32_smoke_dims_run_the_gqa_entries(cuda):
    """f32 at the smoke config's dims (32 + 16, V 32): the GQA entries over
    the concatenated, padded operands, equal to the plain versions within
    the f32 tolerance."""
    dims = (32, 16, 32)
    q, kn, kr, v = _mla_operands(5, 2, 40, 40, 48, 4, cuda, dims,
                                 torch.float32)
    before = _entry_counts(fops.FLASH_KERNEL)
    got = fops.mla_flash_attention(q, kn, kr[:, :40].contiguous(), v)
    want = fops.mla_flash_attention_plain(q, kn, kr[:, :40].contiguous(), v)
    torch.cuda.synchronize()
    _assert_one_launch_of(fops.FLASH_KERNEL, before, "flash_attention_f32")
    assert (got - want).abs().max().item() <= _TOL[torch.float32]
    qd = q[:, 0].contiguous()
    before = _entry_counts(dops.DENSE_KERNEL)
    got = dops.mla_decode_attention(qd, kn, kr, v, 33)
    want = dops.mla_decode_attention_plain(qd, kn, kr, v, 33)
    torch.cuda.synchronize()
    _assert_one_launch_of(dops.DENSE_KERNEL, before,
                          "decode_attention_f32_f32")
    assert (got - want).abs().max().item() <= _TOL[torch.float32]


def test_mla_wrappers_reject_unsupported_operands():
    """The MLA entries' checks: bf16 throughout, MLA's dims, contiguous
    16-byte aligned operands that fit one another, and rope keys for
    every key row."""
    q, kn, kr, v = _mla_operands(0, 2, 1, 8, 10, 2, "cpu")
    q = q[:, 0].contiguous()
    dops.check_mla_operands(q, kn, kr, v, 3)           # the valid call
    with pytest.raises(TypeError):
        dops.check_mla_operands(q.float(), kn, kr, v, 3)
    with pytest.raises(ValueError, match="contiguous"):
        dops.check_mla_operands(q, kn.transpose(1, 2), kr, v, 3)
    with pytest.raises(ValueError, match="aligned"):
        shifted = torch.empty(kr.numel() + 1, dtype=kr.dtype)[1:]
        dops.check_mla_operands(q, kn, shifted.view(kr.shape), v, 3)
    with pytest.raises(ValueError, match="MLA dims"):
        dops.check_mla_operands(q, kn, kr, v[..., :64].contiguous(), 3)
    with pytest.raises(ValueError, match="do not fit"):
        dops.check_mla_operands(q, kn, kr[:, :7].contiguous(), v, 3)
    with pytest.raises(ValueError, match="bad shapes"):
        dops.check_mla_operands(q, kn, kr, v, 4)


# -- the split-TF32 prefill body (prefill_tf32.cuh): f32 q at hd 64, 128 and
#    192 (nemotron-4-340b's heads, G = 12: 8-warp blocks) -------------------

def _paged_straddle_lengths(c, T, heads):
    """A slot with nothing cached, a chunk straddling a page boundary and
    one ending at the page table's last key."""
    lengths = c["lengths"]
    lengths[0] = 0
    lengths[1] = 2 * heads["bs"] - 3
    lengths[2] = heads["P"] * heads["bs"] - T
    return lengths


@pytest.mark.parametrize("T", [5, 17, 32])
@pytest.mark.parametrize("kvdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [_SMOLLM_PAGED, _JAMBA_PAGED,
                                   _NEMOTRON_PAGED],
                         ids=["smollm", "jamba", "nemotron"])
def test_prefill_tf32_kernel_matches_plain(cuda, heads, kvdt, T):
    """f32 K2 over f32 and bf16 pools on the split-TF32 body: lengths 0,
    page straddles, T * G rows that are no multiple of a warp's 16."""
    c = _case(T + heads["hd"] + 1, B=4, T=T, max_len=heads["P"] * 16 - T,
              **heads)
    lengths = _paged_straddle_lengths(c, T, heads)
    args = (_t(c["q"], cuda), _t(c["k"], cuda, kvdt), _t(c["v"], cuda, kvdt),
            _t(c["pt"], cuda), _t(lengths, cuda))
    before = _entry_counts(fops.KERNEL)
    got = fops.paged_prefill_attention(*args)
    want = fops.paged_prefill_attention_plain(*args)
    torch.cuda.synchronize()
    _assert_one_launch_of(fops.KERNEL, before,
                          f"paged_prefill_attention_f32_{dops._NAMES[kvdt]}"
                          "_tf32")
    assert got.dtype == want.dtype == kvdt
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _TOL[kvdt], err


@pytest.mark.parametrize("T", [5, 17, 32])
@pytest.mark.parametrize("heads", [_SMOLLM_PAGED, _JAMBA_PAGED,
                                   _NEMOTRON_PAGED],
                         ids=["smollm", "jamba", "nemotron"])
def test_prefill_quant_tf32_kernel_matches_plain(cuda, heads, T):
    """K2q on the split-TF32 body (int8 tiles, row scales folded into the
    scores and probabilities) within f32's 1e-5 of the plain version's
    dequantize-then-dot."""
    c = _quant_case(T + heads["hd"] + 2, B=4, T=T,
                    max_len=heads["P"] * 16 - T, **heads)
    lengths = _paged_straddle_lengths(c, T, heads)
    args = _quant_args(c, c["q"], cuda, lengths=lengths)
    before = _entry_counts(fops.QUANT_KERNEL)
    got = fops.paged_prefill_attention_quant(*args)
    want = fops.paged_prefill_attention_quant_plain(*args)
    torch.cuda.synchronize()
    _assert_one_launch_of(fops.QUANT_KERNEL, before,
                          "paged_prefill_attention_quant_f32_tf32")
    err = (got - want).abs().max().item()
    assert err <= ATOL_F32, err


@pytest.mark.parametrize("S,window", [(77, 0), (77, 16), (77, 128),
                                      (512, 0), (512, 16), (512, 128)])
@pytest.mark.parametrize("heads", [_SMOLLM, _JAMBA_HEADS, _NEMOTRON],
                         ids=["smollm", "jamba", "nemotron"])
def test_flash_tf32_kernel_matches_plain(cuda, heads, S, window):
    """f32 B2 contiguous on the split-TF32 body: causal, with windows
    narrower and wider than a 32-key tile, S no multiple of a tile."""
    q, k, v = _dense_qkv(S + window + heads["hd"] + 1, 2, S, S, heads,
                         torch.float32, cuda)
    before = _entry_counts(fops.FLASH_KERNEL)
    got = fops.flash_attention(q, k, v, causal=True, sliding_window=window)
    want = fops.flash_attention_plain(q, k, v, causal=True,
                                      sliding_window=window)
    torch.cuda.synchronize()
    _assert_one_launch_of(fops.FLASH_KERNEL, before, "flash_attention_f32_tf32")
    err = (got - want).abs().max().item()
    assert err <= ATOL_F32, err


# -- the split decode body (decode_body.cuh): K1, B4, B3 ---------------------

def _split_lengths(B, P, bs, KV, plan=None):
    """Lengths at the split planner's boundaries for B slots of P pages
    (``plan``, default ``split_plan``'s for B * KV pairs): 0, 1, exactly
    one split, one split + 1, the whole page table, and ragged rows
    between."""
    _, split_keys = plan or dops.split_plan(P * bs, B * KV)
    edge = [0, 1, split_keys, split_keys + 1, P * bs]
    rng = np.random.default_rng(B + P)
    return np.array(edge + list(rng.integers(1, P * bs + 1, B - len(edge))),
                    np.int32)


def _split_pages(entry, bs, hd, dtype, pages):
    """Pages of ``bs`` keys a row takes for ``entry``'s plan to split it:
    ``pages`` for decode_body.cuh's entries, three of the tensor-core
    body's splits (``MMA_SPLIT_BYTES`` of the K/V type ``dtype`` each) for
    its own."""
    if not entry.endswith(("_mma", "_tf32")):
        return pages
    return -(-3 * dops.MMA_SPLIT_BYTES[dtype] //
             (bs * dops.key_bytes(dtype, hd)))


def _check_decode_rows(got, want, lengths, tol):
    """Rows with keys equal the plain version within ``tol``; a row with
    none outputs 0, as the kernel always has (the plain version averages
    every V row there: all its scores are masked alike)."""
    empty = torch.as_tensor(lengths == 0, device=got.device)
    assert torch.equal(got[empty].float(),
                       torch.zeros_like(got[empty].float()))
    err = (got[~empty].float() - want[~empty].float()).abs().max().item()
    assert err <= tol, err


@pytest.mark.parametrize("max_keys,pairs", [
    (592, 40), (544, 40), (640, 64), (1, 1), (64, 40), (65, 40), (600, 4),
    (5000, 1), (96, 300)])
def test_decode_split_plan_covers_the_keys_from_host_ints(max_keys, pairs):
    """The split plan (CPU): whole key tiles, every key in exactly one
    split, no split under MIN_SPLIT_KEYS unless there is one, no more
    splits than fill TARGET_BLOCKS; computed from host ints only."""
    n_split, split_keys = dops.split_plan(max_keys, pairs)
    assert split_keys % dops.KEY_TILE == 0
    assert (n_split - 1) * split_keys < max_keys <= n_split * split_keys
    assert n_split == 1 or split_keys >= dops.MIN_SPLIT_KEYS
    assert pairs * (n_split - 1) < dops.TARGET_BLOCKS
    with pytest.raises(TypeError, match="host ints"):
        dops.split_plan(torch.tensor(max_keys), pairs)


def test_decode_split_args_come_from_shapes(monkeypatch):
    """The wrappers' split arguments depend on q's shape, the KV heads and
    the row bound (P * bs, or n_valid) alone, and the workspace is one
    buffer pair per device, grown, never shrunk, counters zeroed."""
    monkeypatch.setattr(dops, "_WORKSPACE", {})
    q = torch.zeros((8, 15, 64))
    split_keys, n_split, ws_ptr, cnt_ptr = dops._split_args(q, 592, 5)
    assert (n_split, split_keys) == dops.split_plan(592, 8 * 5)
    ws, cnt = dops._WORKSPACE[torch.device("cpu")]
    assert (ws.data_ptr(), cnt.data_ptr()) == (ws_ptr, cnt_ptr)
    assert ws.numel() == 8 * 5 * n_split * 3 * (64 + 2)
    assert cnt.numel() == 8 * 5 and not cnt.any()
    assert dops._split_args(q[:4], 100, 5)[2:] == (ws_ptr, cnt_ptr)
    big = dops._split_args(torch.zeros((16, 15, 64)), 592, 5)
    assert dops._WORKSPACE[torch.device("cpu")][1].numel() == 16 * 5
    assert big[:2] == dops.split_plan(592, 16 * 5)[::-1]


@pytest.mark.parametrize("qdt,kvdt", [(torch.float32, torch.float32),
                                      (torch.float32, torch.bfloat16),
                                      (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("heads", [_SMOLLM_PAGED, _JAMBA_PAGED],
                         ids=["smollm", "jamba"])
def test_decode_split_boundaries_match_plain(cuda, heads, qdt, kvdt):
    """K1 with rows of 0, 1, one split's keys, one more, and all P * bs
    in one batch, at the boundaries of the split plan of the entry the
    dispatch picks; two launches give the same bits."""
    B, bs, hd = 8, heads["bs"], heads["hd"]
    entry = dops.decode_entry("paged_decode_attention", qdt, kvdt,
                              heads["H"] // heads["KV"], hd)
    P = _split_pages(entry, bs, hd, qdt, 40)
    c = _case(P + hd, B=B, T=1, max_len=P * bs, **dict(heads, P=P))
    plan = dops.entry_split_plan(entry, P * bs, B * heads["KV"], qdt, hd,
                                 dops.sm_count(cuda))
    lengths = _split_lengths(B, P, bs, heads["KV"], plan)
    args = (_t(c["q"][:, 0], cuda, qdt), _t(c["k"], cuda, kvdt),
            _t(c["v"], cuda, kvdt), _t(c["pt"], cuda), _t(lengths, cuda))
    assert plan[0] > 1
    n0 = dops.KERNEL.launches
    got = dops.paged_decode_attention(*args)
    again = dops.paged_decode_attention(*args)
    want = dops.paged_decode_attention_plain(*args)
    torch.cuda.synchronize()
    assert dops.KERNEL.launches == n0 + 2
    assert torch.equal(got, again)
    _check_decode_rows(got, want, lengths, _TOL[kvdt])


def _quant_launch(entry, args):
    """B3's C entry ``entry`` on ``args`` (q, int8 pools, their scales,
    page table, lengths) with the split plan its wrapper gives it: the
    wrapper where the dispatch picks ``entry``, else a direct launch (the
    body the dispatch leaves for other shapes, at these operands)."""
    q, kq, vq, ks, vs, pt, lengths = args
    B, H, hd = q.shape
    KV, bs, P = kq.shape[2], kq.shape[1], pt.shape[1]
    if entry == dops.quant_decode_entry(H // KV, hd):
        return dops.paged_decode_attention_quant(*args)
    out = torch.empty_like(q)
    dops.QUANT_KERNEL.launch(
        entry, q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), pt.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, H, KV, hd, bs, P, ctypes.c_float(1.0 / np.sqrt(hd)),
        *dops._split_args(q, P * bs, KV, entry=entry, kv_dtype=torch.int8),
        torch.cuda.current_stream(q.device).cuda_stream)
    return out


@pytest.mark.parametrize("entry", ["paged_decode_attention_quant_f32_tf32",
                                   "paged_decode_attention_quant_f32"],
                         ids=["tf32", "f32"])
@pytest.mark.parametrize("heads", [_SERVED, _JAMBA], ids=["smollm", "jamba"])
def test_decode_quant_split_boundaries_match_plain(cuda, heads, entry):
    """B3's two bodies at the boundaries of each one's own split plan
    (rows of 0 and 1 key, one split's keys, one more, the whole table):
    the tensor-core body's ``_f32_tf32``, which the dispatch picks here
    (page tables of three of its splits), and decode_body.cuh's
    ``_f32``, which it keeps for other shapes; once a call, within f32's
    1e-5 of the plain version, bitwise repeatable."""
    B, bs, hd = 8, heads["bs"], heads["hd"]
    P = _split_pages(entry, bs, hd, torch.int8, heads["P"])
    c = _quant_case(hd + 3, B=B, T=1, **dict(heads, P=P, max_len=P * bs))
    plan = dops.entry_split_plan(entry, P * bs, B * heads["KV"], torch.int8,
                                 hd, dops.sm_count(cuda))
    assert plan[0] > 1
    lengths = _split_lengths(B, P, bs, heads["KV"], plan)
    args = _quant_args(c, c["q"][:, 0], cuda, lengths=lengths)
    before = _entry_counts(dops.QUANT_KERNEL)
    got = _quant_launch(entry, args)
    torch.cuda.synchronize()
    _assert_one_launch_of(dops.QUANT_KERNEL, before, entry)
    again = _quant_launch(entry, args)
    want = dops.paged_decode_attention_quant_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _check_decode_rows(got, want, lengths, ATOL_F32)


@pytest.mark.parametrize("qdt,kvdt", [(torch.float32, torch.float32),
                                      (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("heads", [_SMOLLM, _JAMBA_HEADS],
                         ids=["smollm", "jamba"])
def test_dense_decode_split_boundaries_match_plain(cuda, heads, qdt, kvdt):
    """B4 with n_valid at 1, one split's keys, one more, and the whole
    cache (the split plan of the entry the dispatch picks); bitwise
    repeatable."""
    B, hd = 8, heads["hd"]
    entry = dops.decode_entry("decode_attention", qdt, kvdt,
                              heads["H"] // heads["KV"], hd)
    C = 16 * _split_pages(entry, 16, hd, qdt, 584 // 16) + 584 % 16
    n_split, split_keys = dops.entry_split_plan(entry, C, B * heads["KV"],
                                                qdt, hd, dops.sm_count(cuda))
    assert n_split > 1
    for n_valid in (1, split_keys, split_keys + 1, C):
        q, k, v = _dense_qkv(n_valid + 7, B, 1, C, heads, qdt, cuda)
        q = q[:, 0].contiguous()
        got = dops.decode_attention(q, k, v, n_valid)
        again = dops.decode_attention(q, k, v, n_valid)
        want = dops.decode_attention_plain(q, k, v, n_valid)
        torch.cuda.synchronize()
        assert torch.equal(got, again), n_valid
        err = (got.float() - want.float()).abs().max().item()
        assert err <= _TOL[kvdt], (n_valid, err)


# -- the tensor-core decode body (decode_gqa_mma.cuh): K1 and B4 at grouped
#    heads, bf16 (mma.sync) and f32 (split TF32) -----------------------------

_QWEN2VL_HEADS = dict(H=64, KV=8, hd=128)    # qwen2-vl-72b, G = 8
_GLM4_HEADS = dict(H=32, KV=2, hd=128)       # glm4-9b, G = 16
_H100_SMS = 132                              # an H100 SXM's SMs


@pytest.mark.parametrize("sms", [_H100_SMS, 114], ids=["sxm", "pcie"])
@pytest.mark.parametrize("max_keys,pairs,dtype,hd", [
    (544, 64, torch.bfloat16, 192), (544, 64, torch.float32, 192),
    (4128, 16, torch.bfloat16, 128), (8192, 64, torch.bfloat16, 192),
    (1184, 64, torch.float32, 128), (1, 1, torch.bfloat16, 64),
    (100, 300, torch.float32, 128), (5000, 1, torch.float32, 64)])
def test_mma_split_plan_from_host_ints(max_keys, pairs, dtype, hd, sms):
    """The tensor-core body's plan (CPU): whole 16-key tiles, every key in
    exactly one split, no more splits than a row's K/V bytes hold the
    type's MMA_SPLIT_BYTES (rounded up), no more blocks than the device's
    SMs (an H100 SXM's 132, a PCIe card's 114) unless the pairs alone are
    more; host ints only."""
    key_bytes, split_bytes = 2 * hd * dtype.itemsize, \
        dops.MMA_SPLIT_BYTES[dtype]
    n_split, split_keys = dops.entry_split_plan(
        "decode_attention_x_mma", max_keys, pairs, dtype, hd, sms)
    assert (n_split, split_keys) == dops.mma_split_plan(
        max_keys, pairs, key_bytes, split_bytes, sms)
    assert split_keys % dops.MMA_KEY_TILE == 0
    assert (n_split - 1) * split_keys < max_keys <= n_split * split_keys
    assert (n_split - 1) * split_bytes < max_keys * key_bytes
    assert n_split == 1 or pairs * n_split <= sms
    with pytest.raises(TypeError, match="host ints"):
        dops.mma_split_plan(max_keys, torch.tensor(pairs), key_bytes,
                            split_bytes, sms)


def test_decode_entry_picks_the_body_from_dtypes_and_shapes(monkeypatch):
    """K1 and B4 at G <= MMA_MAX_GROUP = 16 (whisper-tiny's 1 up to
    glm4-9b's 16) and a tensor-core head dim go to the tensor-core body in
    bf16 and f32; every other shape (head dims 48 and 32, G = 24), the
    mixed f32-q-over-bf16 pair and B3 stay on decode_body.cuh; the split
    arguments follow the entry, the tensor-core body's planned for the
    device's SMs (``sm_count``, stubbed here)."""
    bf16, f32 = torch.bfloat16, torch.float32
    for prefix in ("paged_decode_attention", "decode_attention"):
        assert dops.decode_entry(prefix, bf16, bf16, 12, 192) == \
            f"{prefix}_bf16_bf16_mma"
        assert dops.decode_entry(prefix, f32, f32, 16, 128) == \
            f"{prefix}_f32_f32_tf32"
        # whisper-tiny, smollm-360m, jamba, qwen2-vl
        for G, hd in ((1, 64), (3, 64), (4, 128), (8, 128)):
            assert dops.decode_entry(prefix, bf16, bf16, G, hd) == \
                f"{prefix}_bf16_bf16_mma"
        for G, hd in ((12, 48), (4, 32), (24, 128)):
            assert dops.decode_entry(prefix, bf16, bf16, G, hd) == \
                f"{prefix}_bf16_bf16"
        assert dops.decode_entry(prefix, f32, bf16, 16, 128) == \
            f"{prefix}_f32_bf16"
        handle = dops.KERNEL if prefix.startswith("paged") \
            else dops.DENSE_KERNEL
        assert {f"{prefix}_bf16_bf16_mma", f"{prefix}_f32_f32_tf32"} \
            <= set(handle.entries)
    q = torch.zeros((8, 96, 192), dtype=bf16)
    monkeypatch.setattr(dops, "sm_count", lambda device: _H100_SMS)
    args = dops._split_args(q, 544, 8, entry="decode_attention_bf16_bf16_mma")
    assert args[:2] == dops.mma_split_plan(
        544, 64, 2 * 192 * 2, dops.MMA_SPLIT_BYTES[bf16], _H100_SMS)[::-1]
    assert dops._split_args(q, 544, 8, entry="decode_attention_bf16_bf16")[
        :2] == dops.split_plan(544, 64)[::-1]


def _gqa_lengths(B, P, bs):
    """Rows of 1 key, one straddling a page boundary, a whole number of
    pages, all P * bs, and ragged rows between (B = 1: the straddling
    row)."""
    edge = [bs + 3, 1, 2 * bs, P * bs]
    rng = np.random.default_rng(B + P + bs)
    return np.array((edge + list(rng.integers(1, P * bs + 1, B)))[:B],
                    np.int32)


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [_NEMOTRON, _QWEN2VL_HEADS, _GLM4_HEADS],
                         ids=["nemotron", "qwen2vl", "glm4"])
def test_gqa_decode_kernels_match_plain(cuda, heads, dtype, B):
    """K1 and B4 at nemotron-4-340b's (G = 12, hd 192), qwen2-vl-72b's (8,
    128) and glm4-9b's (16, 128) heads each launch exactly their
    tensor-core entry and equal the plain version: K1 over rows of 1 key,
    one straddling a page, whole pages and a full page table; B4 at
    n_valid 1, 37 and the whole cache.  Two launches, the same bits."""
    P, bs = 40, 16
    c = _case(B + heads["H"], B=B, T=1, bs=bs, P=P, max_len=P * bs,
              **heads)
    lengths = _gqa_lengths(B, P, bs)
    args = (_t(c["q"][:, 0], cuda, dtype), _t(c["k"], cuda, dtype),
            _t(c["v"], cuda, dtype), _t(c["pt"], cuda), _t(lengths, cuda))
    G, hd = heads["H"] // heads["KV"], heads["hd"]
    entry = dops.decode_entry("paged_decode_attention", dtype, dtype, G, hd)
    assert entry.endswith("_mma" if dtype == torch.bfloat16 else "_tf32")
    before = _entry_counts(dops.KERNEL)
    got = dops.paged_decode_attention(*args)
    torch.cuda.synchronize()
    _assert_one_launch_of(dops.KERNEL, before, entry)
    again = dops.paged_decode_attention(*args)
    want = dops.paged_decode_attention_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == dtype and torch.equal(got, again)
    _check_decode_rows(got, want, lengths, _TOL[dtype])
    C = 600
    entry = dops.decode_entry("decode_attention", dtype, dtype, G, hd)
    for n_valid in (1, 37, C):
        q, k, v = _dense_qkv(n_valid + B, B, 1, C, heads, dtype, cuda)
        q = q[:, 0].contiguous()
        before = _entry_counts(dops.DENSE_KERNEL)
        got = dops.decode_attention(q, k, v, n_valid)
        torch.cuda.synchronize()
        _assert_one_launch_of(dops.DENSE_KERNEL, before, entry)
        again = dops.decode_attention(q, k, v, n_valid)
        want = dops.decode_attention_plain(q, k, v, n_valid)
        torch.cuda.synchronize()
        assert torch.equal(got, again), n_valid
        err = (got.float() - want.float()).abs().max().item()
        assert err <= _TOL[dtype], (n_valid, err)


@pytest.mark.parametrize("G", [1, 3, 4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gqa_decode_entries_take_any_group_and_head_dim(cuda, G, dtype):
    """The tensor-core entries, launched by name, are right at every group
    size up to 16 (rows G..15 padded) and head_dim 64 and 192, rows long
    enough to split (B = 2): the rows chip_smoke.py phase 3
    times against decode_body.cuh to set the dispatch's rule."""
    suffix = "bf16_bf16_mma" if dtype == torch.bfloat16 else "f32_f32_tf32"
    entry = f"paged_decode_attention_{suffix}"
    for hd in (64, 192):
        heads = dict(H=2 * G, KV=2, hd=hd)
        P = _split_pages(entry, 16, hd, dtype, 40)
        c = _case(G + hd, B=2, T=1, bs=16, P=P, max_len=P * 16, min_len=16,
                  **heads)
        args = (_t(c["q"][:, 0], cuda, dtype), _t(c["k"], cuda, dtype),
                _t(c["v"], cuda, dtype), _t(c["pt"], cuda),
                _t(c["lengths"], cuda))
        q, kp, vp, pt, ln = args
        out = torch.empty_like(q)
        split = dops._split_args(q, P * 16, 2, entry=entry)
        assert split[1] > 1
        dops.KERNEL.launch(
            entry, q.data_ptr(), kp.data_ptr(), vp.data_ptr(), pt.data_ptr(),
            ln.data_ptr(), out.data_ptr(), 2, 2 * G, 2, hd, 16, P,
            ctypes.c_float(1.0 / np.sqrt(hd)), *split,
            torch.cuda.current_stream().cuda_stream)
        want = dops.paged_decode_attention_plain(*args)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        assert err <= _TOL[dtype], (hd, err)


# -- int8 pools: B3 (decode) and the int8 paged prefill (K2q) ----------------

def _quant_case(seed, **kw):
    """``_case`` with int8 K/V pools and their f32 per-row scales, made by
    the port's quantizer (bitwise the reference's, tests/test_torch_quant.py)
    from the f32 pools."""
    from repro_torch.models.attention import quantize_kv
    c = _case(seed, **kw)
    for name in ("k", "v"):
        codes, scale = quantize_kv(torch.from_numpy(c[name]))
        c[name], c[name + "_scale"] = codes.numpy(), scale.numpy()
    return c


def _quant_args(c, q, device="cpu", lengths=None):
    return (_t(q, device), _t(c["k"], device), _t(c["v"], device),
            _t(c["k_scale"], device), _t(c["v_scale"], device),
            _t(c["pt"], device),
            _t(c["lengths"] if lengths is None else lengths, device))


@pytest.mark.parametrize("B,H,KV,hd,bs,P", [(3, 4, 2, 16, 4, 4),
                                            (2, 6, 3, 32, 8, 3),
                                            (2, 32, 2, 16, 4, 3)])
def test_plain_paged_decode_quant_matches_pallas_and_reference(ref, B, H, KV,
                                                               hd, bs, P):
    """B3's plain version against the reference's Pallas kernel
    (interpret mode) and its ``paged_attention`` over the dequantized
    gather, within 1e-5 (f32); the last case at glm4-9b's G = 16."""
    c = _quant_case(B * 10 + hd, B=B, T=1, H=H, KV=KV, hd=hd, bs=bs, P=P,
                    max_len=P * bs)
    c["lengths"][0] = P * bs
    got = dops.paged_decode_attention_quant(*_quant_args(c, c["q"][:, 0]))
    assert got.dtype == torch.float32
    jnp = ref.jnp
    args = [jnp.asarray(c[n]) for n in ("k", "v", "k_scale", "v_scale", "pt",
                                        "lengths")]
    pallas = np.asarray(ref.decode_quant(jnp.asarray(c["q"]), *args))[:, 0]
    pt = jnp.asarray(c["pt"])
    kd = ref.dequantize(ref.gather(args[0], pt), ref.gather(args[2], pt))
    vd = ref.dequantize(ref.gather(args[1], pt), ref.gather(args[3], pt))
    plain = np.asarray(ref.attention(jnp.asarray(c["q"]), kd, vd,
                                     jnp.asarray(c["lengths"] - 1)[:, None]))
    np.testing.assert_allclose(got.numpy(), pallas, atol=ATOL_F32, rtol=0)
    np.testing.assert_allclose(got.numpy(), plain[:, 0], atol=ATOL_F32,
                               rtol=0)


def test_plain_paged_prefill_quant_matches_reference(ref):
    """K2q's plain version: T tokens per slot over the dequantized gather,
    a chunk that overruns the page table included."""
    B, T, H, KV, hd, bs, P = 3, 6, 4, 2, 16, 4, 6
    c = _quant_case(17, B=B, T=T, H=H, KV=KV, hd=hd, bs=bs, P=P,
                    max_len=P * bs)
    lengths = c["lengths"] - 1
    lengths[0], lengths[-1] = 0, P * bs - 2
    got = fops.paged_prefill_attention_quant(
        *_quant_args(c, c["q"], lengths=lengths)).numpy()
    jnp = ref.jnp
    pt = jnp.asarray(c["pt"])
    kd = ref.dequantize(ref.gather(jnp.asarray(c["k"]), pt),
                        ref.gather(jnp.asarray(c["k_scale"]), pt))
    vd = ref.dequantize(ref.gather(jnp.asarray(c["v"]), pt),
                        ref.gather(jnp.asarray(c["v_scale"]), pt))
    pos = lengths[:, None] + np.arange(T, dtype=np.int32)[None, :]
    want = np.asarray(ref.attention(jnp.asarray(c["q"]), kd, vd,
                                    jnp.asarray(pos)))
    np.testing.assert_allclose(got, want, atol=ATOL_F32, rtol=0)


def test_quant_wrappers_reject_unsupported_operands():
    c = _quant_case(0, B=2, T=1, H=4, KV=2, hd=16, bs=4, P=2, max_len=8)
    q, k, v, ks, vs, pt, ln = _quant_args(c, c["q"][:, 0])
    check = partial(dops.check_paged_operands, n_q_dims=3)
    check(q, k, v, pt, ln, scales=(ks, vs))           # the valid call
    with pytest.raises(TypeError, match="int8 kernels"):
        check(q.bfloat16(), k, v, pt, ln, scales=(ks, vs))
    with pytest.raises(TypeError, match="int8 kernels"):
        check(q, k.float(), v.float(), pt, ln, scales=(ks, vs))
    with pytest.raises(TypeError, match="int8 kernels"):
        check(q, k, v, pt, ln, scales=(ks.double(), vs))
    with pytest.raises(ValueError, match="scales"):
        check(q, k, v, pt, ln, scales=(ks[:, :2].contiguous(), vs))
    c8 = _quant_case(1, B=2, T=1, H=4, KV=2, hd=8, bs=4, P=2, max_len=8)
    with pytest.raises(ValueError, match="head_dim % 16"):
        check(*_quant_args(c8, c8["q"][:, 0])[:3], pt, ln,
              scales=_quant_args(c8, c8["q"][:, 0])[3:5])


@pytest.mark.parametrize("B", [4, 8])
@pytest.mark.parametrize("heads", [_SERVED, _JAMBA])
def test_decode_quant_kernel_matches_plain(cuda, B, heads):
    c = _quant_case(B + 30, B=B, T=1, **heads)
    args = _quant_args(c, c["q"][:, 0], cuda)
    n0 = dops.QUANT_KERNEL.launches
    got = dops.paged_decode_attention_quant(*args)
    want = dops.paged_decode_attention_quant_plain(*args)
    torch.cuda.synchronize()
    assert dops.QUANT_KERNEL.launches == n0 + 1
    assert got.dtype == want.dtype == torch.float32
    err = (got - want).abs().max().item()
    assert err <= ATOL_F32, err


@pytest.mark.parametrize("B", [4, 8])
@pytest.mark.parametrize("heads", [_SERVED, _JAMBA])
def test_prefill_quant_kernel_matches_plain(cuda, B, heads):
    c = _quant_case(B + 31, B=B, T=32, **heads)
    args = _quant_args(c, c["q"], cuda, lengths=c["lengths"] - 1)
    n0 = fops.QUANT_KERNEL.launches
    got = fops.paged_prefill_attention_quant(*args)
    want = fops.paged_prefill_attention_quant_plain(*args)
    torch.cuda.synchronize()
    assert fops.QUANT_KERNEL.launches == n0 + 1
    err = (got - want).abs().max().item()
    assert err <= ATOL_F32, err


# -- B3 on the tensor cores: paged_decode_attention_quant_f32_tf32 ----------

def test_quant_decode_entry_picks_the_body_from_shapes(monkeypatch):
    """B3 (f32 q over int8 pools) goes to the tensor-core body's
    ``paged_decode_attention_quant_f32_tf32`` exactly at G <= 16 and head
    dims 64, 128 and 192, to decode_body.cuh's ``_quant_f32`` at every
    other shape (the tests' head dims 16 and 32, G = 17 and 24); its split
    arguments are ``mma_split_plan``'s over 2 * hd + 8 bytes a key and the
    int8 ``MMA_SPLIT_BYTES``, from host ints (the SMs stubbed)."""
    for G in range(1, 25):
        for hd in (16, 32, 48, 64, 96, 128, 192, 256):
            want = "paged_decode_attention_quant_f32" + (
                "_tf32" if G <= 16 and hd in (64, 128, 192) else "")
            assert dops.quant_decode_entry(G, hd) == want, (G, hd)
    assert set(dops.QUANT_KERNEL.entries) == {
        "paged_decode_attention_quant_f32",
        "paged_decode_attention_quant_f32_tf32"}
    assert dops.key_bytes(torch.int8, 128) == 2 * 128 + 8
    monkeypatch.setattr(dops, "sm_count", lambda device: _H100_SMS)
    q = torch.zeros((8, 32, 128))
    entry = dops.quant_decode_entry(16, 128)
    args = dops._split_args(q, 4128, 2, entry=entry, kv_dtype=torch.int8)
    assert args[:2] == dops.mma_split_plan(
        4128, 16, 264, dops.MMA_SPLIT_BYTES[torch.int8], _H100_SMS)[::-1]
    assert dops._split_args(
        q, 4128, 2, entry="paged_decode_attention_quant_f32",
        kv_dtype=torch.int8)[:2] == dops.split_plan(4128, 16)[::-1]


@pytest.mark.parametrize("max_keys,pairs,hd", [
    (640, 40, 64), (4128, 16, 128), (8192, 16, 128), (544, 64, 192),
    (1184, 64, 128), (1, 1, 64), (5000, 1, 192), (96, 300, 128)])
def test_quant_split_plan_covers_the_keys_from_host_ints(max_keys, pairs, hd):
    """The int8 entry's plan (CPU): whole 16-key tiles, every key in
    exactly one split, no more splits than a row's bytes (int8 K and V
    rows and their two f32 scales a key) hold int8's MMA_SPLIT_BYTES
    (rounded up), no more blocks than an H100's 132 SMs unless the pairs
    alone are more; host ints only."""
    entry = dops.quant_decode_entry(4, hd)
    n_split, split_keys = dops.entry_split_plan(
        entry, max_keys, pairs, torch.int8, hd, _H100_SMS)
    kb, sb = 2 * hd + 8, dops.MMA_SPLIT_BYTES[torch.int8]
    assert split_keys % dops.MMA_KEY_TILE == 0
    assert (n_split - 1) * split_keys < max_keys <= n_split * split_keys
    assert (n_split - 1) * sb < max_keys * kb
    assert n_split == 1 or pairs * n_split <= _H100_SMS
    with pytest.raises(TypeError, match="host ints"):
        dops.entry_split_plan(entry, torch.tensor(max_keys), pairs,
                              torch.int8, hd, _H100_SMS)


_SMOLLM_Q = dict(_SMOLLM_PAGED, P=40)
_JAMBA_Q = dict(_JAMBA_PAGED, P=40)
_GQA_QUANT_HEADS = {"smollm": _SMOLLM_Q, "jamba": _JAMBA_Q,
                    "nemotron": dict(_NEMOTRON, bs=16, P=40),
                    "qwen2vl": dict(_QWEN2VL_HEADS, bs=16, P=40),
                    "glm4": dict(_GLM4_HEADS, bs=16, P=40)}


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("geo", list(_GQA_QUANT_HEADS))
def test_quant_gqa_decode_kernel_matches_plain(cuda, geo, B):
    """B3's tensor-core entry at smollm-360m's (G = 3, hd 64), jamba's (4,
    128), nemotron-4-340b's (12, 192), qwen2-vl-72b's (8, 128) and
    glm4-9b's (16, 128) heads: one launch of
    ``paged_decode_attention_quant_f32_tf32`` a call, equal to the plain
    version within f32's 1e-5 over rows of 1 key, one straddling a page,
    whole pages and a full page table; a row with no keys outputs 0 (B =
    8: the last row); two launches give the same bits."""
    heads = _GQA_QUANT_HEADS[geo]
    P, bs = heads["P"], heads["bs"]
    c = _quant_case(B + heads["H"] + 5, B=B, T=1, max_len=P * bs, **heads)
    lengths = _gqa_lengths(B, P, bs)
    if B == 8:
        lengths[-1] = 0
    args = _quant_args(c, c["q"][:, 0], cuda, lengths=lengths)
    entry = dops.quant_decode_entry(heads["H"] // heads["KV"], heads["hd"])
    assert entry == "paged_decode_attention_quant_f32_tf32"
    before = _entry_counts(dops.QUANT_KERNEL)
    got = dops.paged_decode_attention_quant(*args)
    torch.cuda.synchronize()
    _assert_one_launch_of(dops.QUANT_KERNEL, before, entry)
    again = dops.paged_decode_attention_quant(*args)
    want = dops.paged_decode_attention_quant_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, again)
    _check_decode_rows(got, want, lengths, ATOL_F32)


def test_quant_decode_keeps_the_cuda_core_body_elsewhere(cuda):
    """At a head dim the tensor-core body is not built for (32) B3 runs
    decode_body.cuh's ``paged_decode_attention_quant_f32``, once a call,
    equal to the plain version."""
    c = _quant_case(11, B=4, T=1, H=4, KV=2, hd=32, bs=16, P=8, max_len=128)
    args = _quant_args(c, c["q"][:, 0], cuda)
    before = _entry_counts(dops.QUANT_KERNEL)
    got = dops.paged_decode_attention_quant(*args)
    want = dops.paged_decode_attention_quant_plain(*args)
    torch.cuda.synchronize()
    _assert_one_launch_of(dops.QUANT_KERNEL, before,
                          "paged_decode_attention_quant_f32")
    assert (got - want).abs().max().item() <= ATOL_F32


# -- B7: the fused transform, bit-exact against its plain version ------------

@pytest.mark.parametrize("in_dt,out_dt", [
    (torch.uint8, torch.float32), (torch.uint8, torch.uint8),
    (torch.float32, torch.int8), (torch.float32, torch.uint32),
    (torch.float32, torch.int32), (torch.float32, torch.bool),
    (torch.int32, torch.float16), (torch.float16, torch.bfloat16),
    (torch.bfloat16, torch.int16), (torch.bool, torch.uint16)])
def test_fused_transform_kernel_matches_plain_bitwise(cuda, in_dt, out_dt):
    """Every element equal, at a size that is no multiple of a block, with
    NaN, +-inf and out-of-range values among the float inputs and
    settings whose products land on .5 boundaries."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(100_003).astype(np.float32) * 300
    if in_dt.is_floating_point:
        x[:4] = [np.nan, np.inf, -np.inf, 3e9]
    x = torch.from_numpy(x)
    x = (x.abs() if in_dt in (torch.uint8, torch.bool) else x).to(in_dt)
    for scale, bias, lo, hi in ((1 / 255.0, -0.5, -0.5, 0.5),
                                (0.1, 0.05, -1e9, 1e9),
                                (2.5, -0.5, -np.inf, np.inf)):
        kw = dict(scale=scale, bias=bias, lo=lo, hi=hi, out_dtype=out_dt)
        xc = x.to(cuda)
        n0 = tops.KERNEL.launches
        got = tops.fused_transform(xc, **kw)
        want = tops.fused_transform_plain(xc, **kw)
        torch.cuda.synchronize()
        assert tops.KERNEL.launches == n0 + 1
        assert got.dtype == want.dtype == out_dt
        for other in (want, tops.fused_transform_plain(x, **kw)):
            other = other.to(cuda)
            same = got == other
            if out_dt.is_floating_point:      # NaN where the other has NaN
                same |= got.isnan() & other.isnan()
            assert bool(same.all()), (kw, int((~same).sum()))



# -- B2's backward (flash_backward.cu: the gradient the JAX package leaves to
#    XLA) ------------------------------------------------------------------------

# each gradient's max error over its largest magnitude (chip_smoke.py's
# GRAD_TOL), just above what the card gave (f32 1.5e-6, bf16 7.5e-3): f32
# sums in another order than torch's autograd; bf16: the plain version
# rounds every intermediate product to bf16, the kernel keeps them in f32
# and rounds the gradients once
_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1.6e-2}
_WHISPER_HEADS = dict(H=6, KV=6, hd=64)


def _grad_errs(got, want):
    return [(g.float() - w.float()).abs().max().item()
            / max(w.float().abs().max().item(), 1e-30)
            for g, w in zip(got, want)]


@pytest.mark.parametrize("heads,S,T,causal,window", [
    (_SMOLLM, 200, 200, True, 0), (_SMOLLM, 200, 200, True, 48),
    (_SMOLLM, 64, 130, True, 0), (_JAMBA_HEADS, 130, 130, True, 0),
    (_WHISPER_HEADS, 150, 150, False, 0), (_WHISPER_HEADS, 100, 64, False, 0),
    (dict(H=4, KV=2, hd=16), 37, 37, True, 0),
    (dict(H=4, KV=4, hd=48), 70, 70, True, 0),
    (dict(H=12, KV=4, hd=192), 130, 130, True, 0)],
    ids=["smollm", "window", "s_lt_t", "jamba", "bidirectional", "cross",
         "hd16", "hd48", "hd192"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernel_matches_plain(cuda, heads, S, T, causal,
                                             window, dtype):
    """dq, dk, dv against torch.autograd of the plain version: causal,
    windowed, S < T, GQA and MHA, without the causal mask (S = T and the
    cross case S > T), T no multiple of the 64-key tile, head dims 16 to
    192 (bf16 at 16 and 48 over the CUDA-core forward body); through the
    autograd Function around B2's forward.  bf16 at 64, 128 and 192 and
    f32 at 64 and 128 run a tensor-core backward (bf16 mma, split TF32)
    from the ``*_lse`` forward's logsumexp; the other head dims (f32 at
    192 among them, over the split-TF32 forward) the CUDA-core one after
    the served forward."""
    q, k, v = _dense_qkv(S + T + window, 2, S, T, heads, dtype, cuda)
    dout = _t(np.random.default_rng(S + 2).standard_normal(
        q.shape).astype(np.float32), cuda, dtype)
    want = fops.flash_attention_backward_plain(
        q, k, v, None, dout, causal=causal, sliding_window=window)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    entry = fops.flash_backward_entry((dtype,), heads["hd"], heads["hd"])
    forward = fops.flash_entry(dtype, heads["hd"])
    if fops.backward_takes_lse(q, v):
        forward = fops.LSE_ENTRIES[forward]
    # the backward is a tensor-core entry iff the forward is an _lse twin
    assert (entry in fops.LSE_BACKWARDS) == forward.endswith("_lse")
    assert entry.endswith(("_mma", "_tf32")) == forward.endswith("_lse")
    before = (_entry_counts(fops.FLASH_KERNEL),
              _entry_counts(fops.BACKWARD_KERNEL))
    out = fops.flash_attention(*qkv, causal=causal, sliding_window=window)
    got = torch.autograd.grad(out, qkv, dout)
    torch.cuda.synchronize()
    _assert_one_launch_of(fops.FLASH_KERNEL, before[0], forward)
    _assert_one_launch_of(fops.BACKWARD_KERNEL, before[1], entry)
    errs = _grad_errs(got, want)
    print(f"backward {heads} S={S} T={T} causal={causal} window={window} "
          f"{dtype}: relative errors dq/dk/dv {errs}")
    assert all(torch.isfinite(g.float()).all().item() for g in got)
    assert max(errs) <= _GRAD_TOL[dtype], errs


@pytest.mark.parametrize("S,T,causal", [(130, 130, True), (512, 512, True),
                                        (100, 64, False)])
def test_flash_backward_kernel_matches_plain_at_nemotron_heads(cuda, S, T,
                                                               causal):
    """bf16 at nemotron-4-340b's heads (96/8, 192): the ``*_lse`` forward
    and the tensor-core backward at 192 (a pair of warps to 16 keys in
    dk/dv), causal at S no multiple of a tile and at phase 19's 512, and
    without the mask at S > T."""
    q, k, v = _dense_qkv(S + T + 192, 2, S, T, _NEMOTRON, torch.bfloat16,
                         cuda)
    dout = _t(np.random.default_rng(S).standard_normal(
        q.shape).astype(np.float32), cuda, torch.bfloat16)
    want = fops.flash_attention_backward_plain(q, k, v, None, dout,
                                               causal=causal)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (_entry_counts(fops.FLASH_KERNEL),
              _entry_counts(fops.BACKWARD_KERNEL))
    out = fops.flash_attention(*qkv, causal=causal)
    got = torch.autograd.grad(out, qkv, dout)
    torch.cuda.synchronize()
    _assert_one_launch_of(fops.FLASH_KERNEL, before[0],
                          "flash_attention_bf16_mma_lse")
    _assert_one_launch_of(fops.BACKWARD_KERNEL, before[1],
                          "flash_attention_backward_bf16_mma")
    errs = _grad_errs(got, want)
    print(f"backward nemotron heads S={S} T={T} causal={causal}: relative "
          f"errors dq/dk/dv {errs}")
    assert all(torch.isfinite(g.float()).all().item() for g in got)
    assert max(errs) <= _GRAD_TOL[torch.bfloat16], errs


@pytest.mark.parametrize("S,T,causal,window", [
    (512, 512, True, 0), (130, 130, True, 0), (200, 200, True, 48),
    (100, 64, False, 0)], ids=["causal512", "causal130", "window", "cross"])
@pytest.mark.parametrize("heads", [_SMOLLM, _JAMBA_HEADS],
                         ids=["smollm", "jamba"])
def test_flash_backward_f32_tf32_matches_plain(cuda, heads, S, T, causal,
                                               window):
    """f32 B2' on the split-TF32 tensor-core body at smollm-360m's (15/5
    of 64) and jamba-v0.1's (32/8 of 128) heads: through the autograd
    Function, the ``flash_attention_f32_tf32_lse`` forward, then
    ``flash_attention_backward_f32_tf32``; dq, dk, dv within f32's
    gradient tolerance of torch.autograd of the plain version, causal at
    phase 17's S = 512 and at S no multiple of a tile, windowed, and
    without the mask at S > T; two launches the same bits."""
    q, k, v = _dense_qkv(S + T + heads["hd"], 2, S, T, heads, torch.float32,
                         cuda)
    dout = _t(np.random.default_rng(S + 5).standard_normal(
        q.shape).astype(np.float32), cuda)
    want = fops.flash_attention_backward_plain(
        q, k, v, None, dout, causal=causal, sliding_window=window)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (_entry_counts(fops.FLASH_KERNEL),
              _entry_counts(fops.BACKWARD_KERNEL))
    out = fops.flash_attention(*qkv, causal=causal, sliding_window=window)
    got = torch.autograd.grad(out, qkv, dout, retain_graph=True)
    torch.cuda.synchronize()
    _assert_one_launch_of(fops.FLASH_KERNEL, before[0],
                          "flash_attention_f32_tf32_lse")
    _assert_one_launch_of(fops.BACKWARD_KERNEL, before[1],
                          "flash_attention_backward_f32_tf32")
    errs = _grad_errs(got, want)
    print(f"f32 split-TF32 backward {heads} S={S} T={T} causal={causal} "
          f"window={window}: relative errors dq/dk/dv {errs}")
    assert all(torch.isfinite(g).all().item() for g in got)
    assert max(errs) <= _GRAD_TOL[torch.float32], errs
    again = torch.autograd.grad(out, qkv, dout)
    torch.cuda.synchronize()
    for x, y in zip(got, again):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("heads,S,T,causal,window", [
    (_SMOLLM, 200, 200, True, 0), (_SMOLLM, 200, 200, True, 48),
    (_JAMBA_HEADS, 130, 130, True, 0), (_WHISPER_HEADS, 100, 64, False, 0),
    (_NEMOTRON, 130, 130, True, 0)],
    ids=["smollm", "window", "jamba", "cross", "nemotron"])
def test_f32_lse_entry_matches_served_entry(cuda, heads, S, T, causal,
                                            window):
    """``flash_attention_f32_tf32_lse``: its out equals
    ``flash_attention_f32_tf32``'s bit for bit (random normal operands;
    at nemotron's 192 too, where the 8-warp body runs), its logsumexp
    the plain version's within 1e-5 (operands in {-1, 0, 1}: the scores
    are sums of +-scale, which both compute to f32 rounding)."""
    H, KV, hd = heads["H"], heads["KV"], heads["hd"]
    q, k, v = _dense_qkv(S + T + 3, 2, S, T, heads, torch.float32, cuda)
    served = fops._flash_forward(q, k, v, causal, window)
    out, _ = fops._flash_forward(q, k, v, causal, window, lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), served.view(torch.int32))
    rng = np.random.default_rng(S + 1)
    q, k, v = (_t(rng.integers(-1, 2, (2, n, h, hd)).astype(np.float32),
                  cuda) for n, h in ((S, H), (T, KV), (T, KV)))
    before = _entry_counts(fops.FLASH_KERNEL)
    _, lse = fops._flash_forward(q, k, v, causal, window, lse=True)
    _, want = fops.flash_attention_lse_plain(q, k, v, causal=causal,
                                             sliding_window=window)
    torch.cuda.synchronize()
    _assert_one_launch_of(fops.FLASH_KERNEL, before,
                          "flash_attention_f32_tf32_lse")
    err = (lse - want).abs().max().item()
    assert err <= ATOL_F32, err


@pytest.mark.parametrize("B,S,H", [(2, 77, 8), (1, 128, 128)])
def test_mla_flash_backward_matches_plain(cuda, B, S, H):
    """The MLA entry's gradient (q/k 192, V 128, one rope key a token
    shared by every head: its gradient summed over the heads) against
    torch.autograd of the plain version."""
    ops_in = _mla_operands(S + H + 1, B, S, S, S, H, cuda)
    dout = _t(np.random.default_rng(S).standard_normal(
        (B, S, H, 128)).astype(np.float32), cuda, torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in ops_in]
    want = torch.autograd.grad(fops.mla_flash_attention_plain(*leaves),
                               leaves, dout)
    leaves = [t.clone().requires_grad_() for t in ops_in]
    before = (_entry_counts(fops.FLASH_KERNEL),
              _entry_counts(fops.BACKWARD_KERNEL))
    got = torch.autograd.grad(fops.mla_flash_attention(*leaves), leaves, dout)
    torch.cuda.synchronize()
    _assert_one_launch_of(fops.FLASH_KERNEL, before[0],
                          "flash_attention_mla_bf16_mma_lse")
    _assert_one_launch_of(fops.BACKWARD_KERNEL, before[1],
                          "flash_attention_backward_mla_bf16_mma")
    assert [g.shape for g in got] == [t.shape for t in ops_in]
    errs = _grad_errs(got, want)
    print(f"MLA backward B={B} S={S} H={H}: relative errors "
          f"dq/dk_nope/dk_rope/dv {errs}")
    assert max(errs) <= _GRAD_TOL[torch.bfloat16], errs


def _backward_case(name, device, dtype=torch.bfloat16):
    """(call, operands) of one backward at a small shape: GQA through
    ``flash_attention_backward``, MLA through
    ``mla_flash_attention_backward``, each with its forward's out."""
    if name == "mla":
        ins = _mla_operands(9, 2, 77, 77, 77, 8, device)
        out = fops.mla_flash_attention(*ins)
        dout = torch.randn(out.shape, generator=torch.Generator(
            device="cpu").manual_seed(1)).to(device, dtype)
        return (lambda: fops.mla_flash_attention_backward(*ins, out, dout))
    heads, S, T, causal, window = {
        "smollm": (_SMOLLM, 200, 200, True, 48),
        "jamba": (_JAMBA_HEADS, 130, 130, True, 0),
        "cross": (_WHISPER_HEADS, 100, 64, False, 0)}[name]
    q, k, v = _dense_qkv(S + T, 2, S, T, heads, dtype, device)
    out = fops.flash_attention(q, k, v, causal=causal, sliding_window=window)
    dout = torch.randn(out.shape, generator=torch.Generator(
        device="cpu").manual_seed(2)).to(device, dtype)
    return lambda: fops.flash_attention_backward(
        q, k, v, out, dout, causal=causal, sliding_window=window)


@pytest.mark.parametrize("name", ["smollm", "jamba", "cross", "mla"])
def test_flash_backward_kernel_is_deterministic(cuda, name):
    """Two launches of the tensor-core backward give the same bits (no
    atomics: training's --remat run must give the plain run's losses)."""
    call = _backward_case(name, cuda)
    a, b = call(), call()
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int16), y.view(torch.int16))


def _signs(rng, shape, device):
    """Entries in {-1, 0, 1}: every score q * scale . k is then a multiple
    of one bf16 value, exact in f32 in any summation order, so kernel and
    plain version round the same scores and their logsumexps differ only
    by the exponent and the sums' order."""
    return _t(rng.integers(-1, 2, shape).astype(np.float32), device,
              torch.bfloat16)


@pytest.mark.parametrize("heads,S,T,causal,window", [
    (_SMOLLM, 200, 200, True, 0), (_SMOLLM, 200, 200, True, 48),
    (_JAMBA_HEADS, 130, 130, True, 0), (_WHISPER_HEADS, 100, 64, False, 0),
    (_NEMOTRON, 130, 130, True, 0)],
    ids=["smollm", "window", "jamba", "cross", "nemotron"])
def test_lse_entry_matches_served_entry(cuda, heads, S, T, causal, window):
    """``flash_attention_bf16_mma_lse``: its out equals the served entry's
    bit for bit (random normal operands), its logsumexp the plain
    version's within 1e-5 (operands in {-1, 0, 1})."""
    H, KV, hd = heads["H"], heads["KV"], heads["hd"]
    q, k, v = _dense_qkv(S + T + 1, 2, S, T, heads, torch.bfloat16, cuda)
    served = fops._flash_forward(q, k, v, causal, window)
    out, _ = fops._flash_forward(q, k, v, causal, window, lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), served.view(torch.int16))
    rng = np.random.default_rng(S)
    q, k, v = (_signs(rng, (2, n, h, hd), cuda)
               for n, h in ((S, H), (T, KV), (T, KV)))
    before = _entry_counts(fops.FLASH_KERNEL)
    _, lse = fops._flash_forward(q, k, v, causal, window, lse=True)
    _, want = fops.flash_attention_lse_plain(q, k, v, causal=causal,
                                             sliding_window=window)
    torch.cuda.synchronize()
    _assert_one_launch_of(fops.FLASH_KERNEL, before,
                          "flash_attention_bf16_mma_lse")
    err = (lse - want).abs().max().item()
    assert err <= ATOL_F32, err


def test_mla_lse_entry_matches_served_entry(cuda):
    """``flash_attention_mla_bf16_mma_lse`` likewise, on MLA's own
    operands (the plain logsumexp over ``mla_gqa_operands``)."""
    ins = _mla_operands(3, 2, 77, 77, 77, 16, cuda)
    served = fops._mla_flash_forward(*ins)
    out, _ = fops._mla_flash_forward(*ins, lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), served.view(torch.int16))
    rng = np.random.default_rng(4)
    q, kn, kr, v = (_signs(rng, t.shape, cuda) for t in ins)
    before = _entry_counts(fops.FLASH_KERNEL)
    _, lse = fops._mla_flash_forward(q, kn, kr, v, lse=True)
    k, vp = dops.mla_gqa_operands(kn, kr, v)
    _, want = fops.flash_attention_lse_plain(q, k, vp, causal=True)
    torch.cuda.synchronize()
    _assert_one_launch_of(fops.FLASH_KERNEL, before,
                          "flash_attention_mla_bf16_mma_lse")
    err = (lse - want).abs().max().item()
    assert err <= ATOL_F32, err


def test_flash_backward_plain_is_autograd_of_the_plain_forward():
    """On the CPU the backward wrapper runs its plain version, which is
    torch.autograd of ``flash_attention_plain``; ``flash_attention``
    itself is differentiable there."""
    q, k, v = _dense_qkv(3, 2, 20, 20, dict(H=4, KV=2, hd=16),
                         torch.float32, "cpu")
    dout = torch.from_numpy(np.random.default_rng(4).standard_normal(
        q.shape).astype(np.float32))
    got = fops.flash_attention_backward(q, k, v, None, dout, causal=True,
                                        sliding_window=8)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fops.flash_attention(*leaves, causal=True, sliding_window=8)
    want = torch.autograd.grad(out, leaves, dout)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_flash_backward_rejects_unsupported_operands():
    q, k, v = (torch.zeros((1, 8, 2, 200)) for _ in range(3))
    with pytest.raises(ValueError, match="192"):
        fops.check_backward_operands(q, k, v, q, q, True, 0)
    q, k, v = (torch.zeros((1, 8, 2, 64)) for _ in range(3))
    with pytest.raises(ValueError, match="bad shapes"):
        fops.check_backward_operands(q, k, v, q[..., :32].contiguous(), q,
                                     True, 0)
    with pytest.raises(ValueError, match="contiguous"):
        fops.check_backward_operands(q, k, v.transpose(1, 2).contiguous()
                                     .transpose(1, 2), q, q, True, 0)


# -- the selective scan's backward (B5') and its checkpointing forward --------

# each gradient's largest error over its largest magnitude: f32, the
# kernel's ex2.approx and fused multiply-adds against torch's exp, and its
# sums over steps, lanes and channel blocks in another order; bf16
# gradients (d_dt, d_xs, d_Bc, d_Cc in the model type), one bf16 ulp of
# the largest (2^-8) besides
_SCAN_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}


def _scan_grad_case(seed, B, T, di, N, dtype, device, dtr=7):
    """Scan operands as a Mamba layer makes them (dt from a softplus,
    A < 0, Bc/Cc split views of one (B, T, dtr + 2N) projection, a
    non-zero h0) and cotangents dy, dh_last."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    dt = torch.nn.functional.softplus(f(B, T, di)).to(device, dtype)
    xs = f(B, T, di).to(device, dtype)
    proj = torch.cat([torch.zeros((B, T, dtr)), f(B, T, N), f(B, T, N)],
                     dim=-1).to(device, dtype)
    Bc, Cc = torch.split(proj, [dtr, N, N], dim=-1)[1:]
    A = (-torch.exp(f(di, N) * 0.5)).to(device)
    D, h0 = f(di).to(device), f(B, di, N).to(device)
    return (dt, xs, Bc, Cc, A, D, h0), f(B, T, di).to(device), \
        f(B, di, N).to(device)


def _scan_grad_errs(got, want):
    return [(g.float() - w.float()).abs().max().item()
            / max(w.float().abs().max().item(), 1e-30)
            for g, w in zip(got, want)]


@pytest.mark.parametrize("B,T,di,N", [
    (2, 37, 200, 16), (1, 64, 256, 16), (3, 16, 203, 8), (2, 5, 96, 3),
    (4, 300, 512, 16), (8, 512, 1024, 16), (2, 64, 1000, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_backward_kernel_matches_plain(cuda, B, T, di, N, dtype):
    """B5' from the checkpointing twin's states against
    ``selective_scan_backward_plain``: T not a multiple of the 8-step
    chunk (37, 5, 300), odd di (203), di over several clusters of 256
    channels and not a whole number of them (1000), B = 1, N < 16 (the
    2- and 1-lane channels), a non-zero h0 with an incoming dh_last and, once, without
    one; Bc/Cc as split views; each gradient within the tolerance of its
    largest magnitude, in its input's type; two launches the same bits."""
    ops_in, dy, dh = _scan_grad_case(T + di, B, T, di, N, dtype, cuda)
    n0, b0 = sops.KERNEL.launches, sops.BACKWARD_KERNEL.launches
    _, _, states = sops.selective_scan_ckpt(*ops_in)
    got = sops.selective_scan_backward(*ops_in[:6], states, dy, dh)
    again = sops.selective_scan_backward(*ops_in[:6], states, dy, dh)
    no_dh = sops.selective_scan_backward(*ops_in[:6], states, dy, None)
    torch.cuda.synchronize()
    assert sops.KERNEL.launches == n0 + 1
    assert sops.BACKWARD_KERNEL.launches == b0 + 3
    assert [g.dtype for g in got] == [dtype] * 4 + [torch.float32] * 3
    assert all(g.is_contiguous() for g in got)
    for kern, cot in ((got, dh), (no_dh, None)):
        want = sops.selective_scan_backward_plain(*ops_in, dy, cot)
        errs = _scan_grad_errs(kern, want)
        tols = [_SCAN_GRAD_TOL[dtype]] * 4 \
            + [_SCAN_GRAD_TOL[torch.float32]] * 3
        assert all(e <= t for e, t in zip(errs, tols)), errs
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("B,T,di,N", [(2, 37, 200, 16), (3, 16, 203, 8),
                                      (8, 512, 1024, 16), (2, 5, 96, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_ckpt_entry_matches_served_entry_bitwise(cuda, B, T, di, N,
                                                      dtype):
    """The checkpointing twin's y and h_last equal the served entry's bit
    for bit; its stored states are h0 and the plain scan's states at
    steps 8, 16, ... within the scan's tolerance."""
    ops_in, _, _ = _scan_grad_case(T + di + 1, B, T, di, N, dtype, cuda)
    entry = f"selective_scan_ckpt_{sops._NAMES[dtype]}"
    e0 = sops.KERNEL.entry_launches[entry]
    y, h_last = sops.selective_scan(*ops_in)
    y2, h2, states = sops.selective_scan_ckpt(*ops_in)
    torch.cuda.synchronize()
    assert sops.KERNEL.entry_launches[entry] == e0 + 1
    assert torch.equal(y, y2) and torch.equal(h_last, h2)
    assert states.shape == (B, -(-T // sops.CKPT_STEPS), di, N)
    assert torch.equal(states[:, 0], ops_in[6])
    for c in range(1, states.shape[1]):
        t = c * sops.CKPT_STEPS
        _, want = sops.selective_scan_plain(*(a[:, :t] for a in ops_in[:4]),
                                            *ops_in[4:], None)
        assert (states[:, c] - want).abs().max().item() <= 1e-4


def test_scan_autograd_runs_the_twin_and_b5_backward(cuda):
    """``selective_scan`` under autograd on the card: the checkpointing
    twin once, B5' once, the gradients B5''s; no served entry.  The
    masked call and the slab entry raise under autograd."""
    ops_in, dy, dh = _scan_grad_case(5, 2, 40, 256, 16, torch.bfloat16, cuda)
    leaves = [t.detach().clone().requires_grad_() for t in ops_in]
    before = dict(sops.KERNEL.entry_launches)
    b0 = sops.BACKWARD_KERNEL.launches
    y, h_last = sops.selective_scan(*leaves)
    got = torch.autograd.grad((y, h_last), leaves, (dy, dh))
    torch.cuda.synchronize()
    ran = {e: n - before[e] for e, n in sops.KERNEL.entry_launches.items()
           if n != before[e]}
    assert ran == {"selective_scan_ckpt_bf16": 1}
    assert sops.BACKWARD_KERNEL.launches == b0 + 1
    _, _, states = sops.selective_scan_ckpt(*ops_in)
    want = sops.selective_scan_backward(*ops_in[:6], states, dy, dh)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    t_valid = torch.full((2,), 40, dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="unmasked"):
        sops.selective_scan(*leaves, t_valid)
    pool = torch.zeros((2, 256, 16), device=cuda)
    with pytest.raises(NotImplementedError, match="not differentiable"):
        sops.selective_scan_slab(*leaves[:6], pool, None, None, t_valid)
