"""What of B2's tensor-core backward runs without a card: the rule that
sends (dtypes, head dims) to a backward body, the logsumexp that the
``*_lse`` forward entries store (through its plain version, against the
JAX package's masked scores), the backward formula the kernels implement
(P from lse, delta = rowsum(dO * O)) against ``jax.vjp`` of the JAX
package's ``naive_attention``, and the library hash over the new header.

The kernels themselves are held against their plain versions on the card
(``tests/test_torch_kernels.py -k backward``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops

jax = pytest.importorskip("jax")
jnp = jax.numpy
ja = pytest.importorskip("repro.models.attention")

F32, BF16 = torch.float32, torch.bfloat16
ATOL = 1e-5         # f32: the same sums in another order


@pytest.mark.parametrize("dtypes,hd,hdv,mla,entry", [
    ((BF16,), 64, 64, False, "flash_attention_backward_bf16_mma"),
    ((BF16,), 128, 128, False, "flash_attention_backward_bf16_mma"),
    ((BF16,) * 4, 192, 128, True, "flash_attention_backward_mla_bf16_mma"),
    # f32 at 64 and 128 runs the split-TF32 tensor-core body (ids as when
    # it took the CUDA-core one)
    pytest.param((F32,), 64, 64, False, "flash_attention_backward_f32_tf32",
                 id="dtypes3-64-64-False-flash_attention_backward_f32"),
    pytest.param((F32,), 128, 128, False,
                 "flash_attention_backward_f32_tf32",
                 id="dtypes4-128-128-False-flash_attention_backward_f32"),
    ((BF16,), 16, 16, False, "flash_attention_backward_bf16"),
    ((BF16,), 48, 48, False, "flash_attention_backward_bf16"),
    ((F32,), 48, 48, False, "flash_attention_backward_f32"),
    # 192 with V as wide (nemotron-4-340b's heads, or MLA's dims as GQA
    # operands: broadcast rope key, padded V) runs the tensor-core body
    # since it has a 192 instantiation (id as when it took the CUDA-core
    # one); 192 with V 128 as GQA operands is not MLA's operand form: the
    # CUDA-core body
    pytest.param((BF16,), 192, 192, False,
                 "flash_attention_backward_bf16_mma",
                 id="dtypes8-192-192-False-flash_attention_backward_bf16"),
    ((BF16,), 192, 128, False, "flash_attention_backward_bf16"),
    # f32 at 192: the split-TF32 forward (and its *_lse twin) exists, the
    # backward stays on the CUDA-core body; so do f32 at 16 and at 192
    # with V 128
    ((F32,), 192, 192, False, "flash_attention_backward_f32"),
    ((F32,), 16, 16, False, "flash_attention_backward_f32"),
    ((F32,), 192, 128, False, "flash_attention_backward_f32")])
def test_backward_dispatch(dtypes, hd, hdv, mla, entry):
    """bf16 at hd = hdv = 64, 128 or 192, f32 at hd = hdv = 64 or 128
    (``TF32_BACKWARD_HEAD_DIMS``) and MLA's operands at ``MLA_DIMS`` go
    to a tensor-core body, everything else to the CUDA-core body of q's
    type; every entry is one of the library's; a backward is a
    tensor-core entry (``LSE_BACKWARDS``) iff its forward entry has a
    ``*_lse`` twin that ``backward_takes_lse`` makes the autograd Function
    launch (a GQA forward has V as wide as q/k: at hd != hdv the forward
    entry at hd is not this backward's; f32 at 192 has a twin but not
    this backward)."""
    assert fops.flash_backward_entry(dtypes, hd, hdv, mla=mla) == entry
    assert entry in fops.BACKWARD_KERNEL.entries
    tensor_cores = entry.endswith(("_mma", "_tf32"))
    assert (entry in fops.LSE_BACKWARDS) == tensor_cores
    forward = (fops.mla_flash_entry(dtypes, dops.MLA_DIMS) if mla
               else fops.flash_entry(dtypes[0], hd))
    if tensor_cores:
        assert forward in fops.LSE_ENTRIES and (mla or hd == hdv)
    if not mla:
        q, v = torch.empty(1, 1, 1, hd, dtype=dtypes[0]), \
            torch.empty(1, 1, 1, hdv, dtype=dtypes[0])
        assert fops.backward_takes_lse(q, v) == tensor_cores
    for e in fops.LSE_ENTRIES.values():
        assert e in fops.FLASH_KERNEL.entries


@pytest.mark.parametrize("dtype,hd,takes", [
    (F32, 64, True), (F32, 128, True), (F32, 192, False), (F32, 48, False),
    (F32, 16, False), (BF16, 64, True), (BF16, 192, True), (BF16, 48, False)])
def test_backward_takes_lse_by_dtype_and_head_dim(dtype, hd, takes):
    """The autograd Function launches the forward's ``*_lse`` twin exactly
    where the backward is a tensor-core entry: f32 at 64 and 128 (the
    split-TF32 backward) and bf16 at 64, 128 and 192; not f32 at 192,
    whose forward has a twin but whose backward recomputes the logsumexp
    on CUDA cores."""
    q = torch.empty(1, 1, 1, hd, dtype=dtype)
    assert fops.backward_takes_lse(q, q) is takes
    if takes:
        assert fops.LSE_ENTRIES[fops.flash_entry(dtype, hd)] in \
            fops.FLASH_KERNEL.entries


@pytest.mark.parametrize("served,twin", [
    ("flash_attention_bf16_mma", "flash_attention_bf16_mma_lse"),
    ("flash_attention_f32_tf32", "flash_attention_f32_tf32_lse"),
    ("flash_attention_mla_bf16_mma", "flash_attention_mla_bf16_mma_lse")])
def test_lse_entries_are_the_tensor_core_twins(served, twin):
    """Each tensor-core forward entry has its ``*_lse`` twin in the
    library, with the served entry's arguments and the logsumexp's
    pointer after out; no CUDA-core entry has one."""
    assert fops.LSE_ENTRIES[served] == twin
    args = fops.FLASH_KERNEL.entries
    assert served in args and twin in args
    assert len(args[twin]) == len(args[served]) + 1
    assert set(fops.LSE_ENTRIES) == {
        e for e in args if e.endswith(("_mma", "_tf32"))}


@pytest.mark.parametrize("dtypes,dims", [((F32,) * 4, dops.MLA_DIMS),
                                         ((BF16,) * 4, (32, 16, 32))])
def test_mla_backward_dispatch_refuses_what_the_entry_does_not_take(dtypes,
                                                                     dims):
    hd, hdv = dims[0] + dims[1], dims[2]
    with pytest.raises(ValueError, match="MLA"):
        fops.flash_backward_entry(dtypes, hd, hdv, mla=True)


def test_library_hash_covers_the_backward_bodies():
    """The backward library is built from its tensor-core bodies' headers
    (bf16 and split TF32, and the forwards', whose fragments and splits
    they use), so an edit of any of them rebuilds it."""
    names = [f.name for f in build.source_files(fops.BACKWARD_KERNEL.source)]
    assert names[0] == "flash_backward.cu"
    assert sorted(names[1:]) == ["backward_mma.cuh", "backward_tf32.cuh",
                                 "common.cuh", "prefill_mma.cuh",
                                 "prefill_tf32.cuh"]


def _operands(seed, B, S, T, H, KV, hd, hdv=None):
    rng = np.random.default_rng(seed)
    hdv = hdv or hd
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hdv),
                               (B, S, H, hdv)))


# (B, S, T, H, KV, hd, causal, window): GQA causal, a window, no mask
# with more queries than keys, MHA at head_dim 64
_CASES = {"gqa": (2, 19, 19, 6, 2, 16, True, 0),
          "window": (2, 23, 23, 4, 2, 16, True, 5),
          "cross": (2, 13, 7, 4, 4, 8, False, 0),
          "mha64": (1, 9, 9, 2, 2, 64, True, 0)}


def _jax_masked_scores(q, k, causal, window):
    """The JAX package's masked scores (B, KV, G, S, T), f32, as its
    ``naive_attention`` builds them."""
    S, T = q.shape[1], k.shape[1]
    scores = ja._grouped_scores(q * (1.0 / np.sqrt(q.shape[-1])), k)
    s = jnp.arange(S)[:, None]
    t = jnp.arange(T)[None, :]
    mask = jnp.ones((S, T), bool)
    if causal:
        mask &= t <= s
    if window:
        mask &= t > s - window
    return jnp.where(mask[None, None, None], scores.astype(jnp.float32),
                     ja.NEG_INF)


@pytest.mark.parametrize("case", list(_CASES))
def test_lse_plain_matches_jax_logsumexp(case):
    """The plain version of the ``*_lse`` entries: its logsumexp equals
    ``jax.nn.logsumexp`` of the JAX package's masked scores, and its
    output the JAX package's ``naive_attention``, f32 within 1e-5."""
    B, S, T, H, KV, hd, causal, window = _CASES[case]
    q, k, v, _ = _operands(S + hd, B, S, T, H, KV, hd)
    out, lse = fops.flash_attention_lse_plain(
        *map(torch.from_numpy, (q, k, v)), causal=causal,
        sliding_window=window)
    want_lse = jax.nn.logsumexp(_jax_masked_scores(q, k, causal, window),
                                axis=-1).reshape(B, H, S)
    want_out = ja.naive_attention(q, k, v, causal=causal,
                                  sliding_window=window)
    assert lse.shape == (B, H, S) and lse.dtype == F32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=0,
                               atol=ATOL)


def _kernel_formula(q, k, v, dout, causal, window):
    """The gradient as the tensor-core backward computes it, in f32 torch:
    P = exp(S - lse) from the forward's logsumexp (masked pairs 0), delta
    = rowsum(dout * out), dS = P (dout V^T - delta), dq = scale dS K, dk
    = dS^T (q * scale), dv = P^T dout, the group's heads summed."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / np.sqrt(hd)
    out, lse = fops.flash_attention_lse_plain(q, k, v, causal=causal,
                                              sliding_window=window)
    qg = (q * scale).reshape(B, S, KV, G, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k)
    sp = torch.arange(S)[:, None]
    tp = torch.arange(T)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool)
    if causal:
        mask &= tp <= sp
    if window:
        mask &= tp > sp - window
    p = torch.where(mask, torch.exp(s - lse.reshape(B, KV, G, S, 1)), 0.0)
    delta = (dout * out).sum(-1)                          # (B, S, H)
    dog = dout.reshape(B, S, KV, G, -1)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v)
    ds = p * (dp - delta.reshape(B, S, KV, G).permute(0, 2, 3, 1)[..., None])
    dq = scale * torch.einsum("bkgst,btkd->bskgd", ds, k).reshape(q.shape)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    return dq, dk, dv


def _jax_vjp(q, k, v, dout, causal, window):
    out, pull = jax.vjp(lambda a, b, c: ja.naive_attention(
        a, b, c, causal=causal, sliding_window=window), q, k, v)
    return pull(jnp.asarray(dout))


@pytest.mark.parametrize("case", list(_CASES))
def test_backward_formula_matches_jax_vjp(case):
    """The kernels' formula (P from lse, delta = rowsum(dO * O)) equals
    ``jax.vjp`` of the JAX package's ``naive_attention``, f32 within
    1e-5: GQA, a window, no mask with S > T, MHA at head_dim 64."""
    B, S, T, H, KV, hd, causal, window = _CASES[case]
    q, k, v, dout = _operands(S + T + hd, B, S, T, H, KV, hd)
    got = _kernel_formula(*map(torch.from_numpy, (q, k, v, dout)), causal,
                          window)
    want = _jax_vjp(q, k, v, dout, causal, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL, err_msg=name)


def test_backward_plain_matches_jax_grad_at_head_dim_192():
    """``flash_attention_backward_plain``, the version the tensor-core
    body at head_dim 192 (nemotron-4-340b's, V as wide) is held to on the
    card, equals ``jax.grad`` of the JAX package's ``naive_attention``
    against dout, causal GQA (G = 3) at head_dim 192, f32 within 1e-5 (the
    same sums in another order)."""
    B, S, T, H, KV, hd = 2, 21, 21, 6, 2, 192
    q, k, v, dout = _operands(hd, B, S, T, H, KV, hd)
    got = fops.flash_attention_backward_plain(
        *map(torch.from_numpy, (q, k, v)), None, torch.from_numpy(dout),
        causal=True)
    want = jax.grad(lambda a, b, c: jnp.sum(
        ja.naive_attention(a, b, c, causal=True) * dout),
        argnums=(0, 1, 2))(q, k, v)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL, err_msg=name)


def test_mla_backward_formula_matches_jax_vjp():
    """MLA's operands (a rope key shared by every head, V narrower than
    q/k) through ``mla_gqa_operands``: the formula on the concatenated,
    padded operands, dk cut to the nope columns and its rope columns
    summed over the heads, dv cut to V's head dim, against ``jax.vjp`` of
    ``naive_attention`` over the same concatenation built in JAX."""
    B, S, H, nope, rope, vd = 2, 11, 3, 16, 8, 16
    rng = np.random.default_rng(5)
    q, kn, kr, v, dout = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, S, H, nope + rope), (B, S, H, nope), (B, S, rope), (B, S, H, vd),
        (B, S, H, vd)))
    k, vp = dops.mla_gqa_operands(torch.from_numpy(kn), torch.from_numpy(kr),
                                  torch.from_numpy(v))
    dout_p = torch.nn.functional.pad(torch.from_numpy(dout),
                                     (0, nope + rope - vd))
    dq, dk, dvp = _kernel_formula(torch.from_numpy(q), k, vp, dout_p, True, 0)
    got = (dq, dk[..., :nope], dk[..., nope:].sum(dim=2), dvp[..., :vd])

    def mla(q_, kn_, kr_, v_):
        k_ = jnp.concatenate([kn_, jnp.broadcast_to(
            kr_[:, :, None], kn_.shape[:3] + (rope,))], axis=-1)
        v_ = jnp.pad(v_, ((0, 0), (0, 0), (0, 0), (0, nope + rope - vd)))
        return ja.naive_attention(q_, k_, v_, causal=True)[..., :vd]

    _, pull = jax.vjp(mla, q, kn, kr, v)
    want = pull(jnp.asarray(dout))
    for name, g, w in zip(("dq", "dk_nope", "d_rope", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL, err_msg=name)


def test_mla_backward_wrapper_raises_off_the_card():
    """``mla_flash_attention_backward`` is the CUDA entry's wrapper only:
    on the CPU torch differentiates ``mla_flash_attention_plain``, and a
    CPU tensor given to the wrapper raises."""
    ins = [torch.zeros(s) for s in ((1, 6, 2, 24), (1, 6, 2, 16), (1, 6, 8),
                                    (1, 6, 2, 16))]
    with pytest.raises(ValueError, match="no kernel for cpu"):
        fops.mla_flash_attention_backward(*ins, None, torch.zeros(1, 6, 2, 16))
