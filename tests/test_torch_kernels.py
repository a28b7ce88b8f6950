"""The port's attention kernels and its fused transform (B7) against
the JAX reference and their plain versions.

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
    (dops.KERNEL, ["decode_body.cuh", "common.cuh"]),
    (dops.DENSE_KERNEL, ["decode_body.cuh", "common.cuh"]),
    (dops.QUANT_KERNEL, ["decode_body.cuh", "common.cuh"]),
    (fops.KERNEL, _PREFILL_BODIES), (fops.FLASH_KERNEL, _PREFILL_BODIES),
    (fops.QUANT_KERNEL, ["prefill_tf32.cuh", "common.cuh",
                         "prefill_body.cuh"])])
def test_attention_kernels_share_their_family_body(kernel, bodies):
    """The paged and contiguous entries of each attention family are
    built from shared bodies and the shared helpers: the paged and
    contiguous prefill entries also from the two tensor-core bodies, the
    int8 prefill from the split-TF32 one."""
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


@pytest.mark.parametrize("T", [5, 17, 32])
@pytest.mark.parametrize("heads", [_SMOLLM_PAGED, _JAMBA_PAGED],
                         ids=["smollm", "jamba"])
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
@pytest.mark.parametrize("heads", [_SMOLLM, _JAMBA_HEADS],
                         ids=["smollm", "jamba"])
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


@pytest.mark.parametrize("B,H", [(8, 128), (2, 8)], ids=["one_split",
                                                          "splits"])
@pytest.mark.parametrize("n_valid", [1, 129, 576])
def test_mla_decode_kernel_matches_plain(cuda, B, H, n_valid):
    """B4's MLA entry: k_nope/V for 576 slots, the rope keys read in place
    from a 640-slot latent cache; one split per pair at 128 heads, the
    split-and-combine path at 8 (its partials V-wide); within phase 3's
    tolerance (two bf16 ulps of the largest output, at least 6e-3)."""
    q, kn, kr, v = _mla_operands(n_valid + H, B, 1, 576, 640, H, cuda)
    q = q[:, 0].contiguous()
    before = _entry_counts(dops.DENSE_KERNEL)
    got = dops.mla_decode_attention(q, kn, kr, v, n_valid)
    want = dops.mla_decode_attention_plain(q, kn, kr, v, n_valid)
    torch.cuda.synchronize()
    _assert_one_launch_of(dops.DENSE_KERNEL, before,
                          "decode_attention_mla_bf16")
    assert got.shape == want.shape == (B, H, 128)
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


# -- the split-TF32 prefill body (prefill_tf32.cuh): f32 q at hd 64 / 128 ---

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
@pytest.mark.parametrize("heads", [_SMOLLM_PAGED, _JAMBA_PAGED],
                         ids=["smollm", "jamba"])
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
@pytest.mark.parametrize("heads", [_SMOLLM_PAGED, _JAMBA_PAGED],
                         ids=["smollm", "jamba"])
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
@pytest.mark.parametrize("heads", [_SMOLLM, _JAMBA_HEADS],
                         ids=["smollm", "jamba"])
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

def _split_lengths(B, P, bs, KV):
    """Lengths at the split planner's boundaries for B slots of P pages:
    0, 1, exactly one split, one split + 1, the whole page table, and
    ragged rows between."""
    _, split_keys = dops.split_plan(P * bs, B * KV)
    edge = [0, 1, split_keys, split_keys + 1, P * bs]
    rng = np.random.default_rng(B + P)
    return np.array(edge + list(rng.integers(1, P * bs + 1, B - len(edge))),
                    np.int32)


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
    in one batch; two launches give the same bits."""
    B, P, bs = 8, 40, heads["bs"]
    c = _case(P + heads["hd"], B=B, T=1, max_len=P * bs,
              **dict(heads, P=P))
    lengths = _split_lengths(B, P, bs, heads["KV"])
    args = (_t(c["q"][:, 0], cuda, qdt), _t(c["k"], cuda, kvdt),
            _t(c["v"], cuda, kvdt), _t(c["pt"], cuda), _t(lengths, cuda))
    assert dops.split_plan(P * bs, B * heads["KV"])[0] > 1
    n0 = dops.KERNEL.launches
    got = dops.paged_decode_attention(*args)
    again = dops.paged_decode_attention(*args)
    want = dops.paged_decode_attention_plain(*args)
    torch.cuda.synchronize()
    assert dops.KERNEL.launches == n0 + 2
    assert torch.equal(got, again)
    _check_decode_rows(got, want, lengths, _TOL[kvdt])


@pytest.mark.parametrize("heads", [_SERVED, _JAMBA], ids=["smollm", "jamba"])
def test_decode_quant_split_boundaries_match_plain(cuda, heads):
    """B3 at the same boundaries, within f32's 1e-5; bitwise repeatable."""
    B = 8
    c = _quant_case(heads["hd"] + 3, B=B, T=1, **heads)
    lengths = _split_lengths(B, heads["P"], heads["bs"], heads["KV"])
    args = _quant_args(c, c["q"][:, 0], cuda, lengths=lengths)
    n0 = dops.QUANT_KERNEL.launches
    got = dops.paged_decode_attention_quant(*args)
    again = dops.paged_decode_attention_quant(*args)
    want = dops.paged_decode_attention_quant_plain(*args)
    torch.cuda.synchronize()
    assert dops.QUANT_KERNEL.launches == n0 + 2
    assert torch.equal(got, again)
    _check_decode_rows(got, want, lengths, ATOL_F32)


@pytest.mark.parametrize("qdt,kvdt", [(torch.float32, torch.float32),
                                      (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("heads", [_SMOLLM, _JAMBA_HEADS],
                         ids=["smollm", "jamba"])
def test_dense_decode_split_boundaries_match_plain(cuda, heads, qdt, kvdt):
    """B4 with n_valid at 1, one split's keys, one more, and the whole
    cache; bitwise repeatable."""
    C, B = 584, 8
    n_split, split_keys = dops.split_plan(C, B * heads["KV"])
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
                                            (2, 6, 3, 32, 8, 3)])
def test_plain_paged_decode_quant_matches_pallas_and_reference(ref, B, H, KV,
                                                               hd, bs, P):
    """B3's plain version against the reference's Pallas kernel
    (interpret mode) and its ``paged_attention`` over the dequantized
    gather, within 1e-5 (f32)."""
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

