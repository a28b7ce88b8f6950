"""What of the tensor-core prefill body runs without a card: the rule
that sends (dtype, head_dim) to a body, the per-entry launch count that
shows which body served a run, and the library hash over the new header.
The MLA entries likewise: the rule that sends MLA's operands (dtypes,
nope/rope/v head dims) to them or to the GQA entries, and their plain
versions, which must equal the concatenated, padded operands through the
GQA plain versions, cut to V's head dim, bit for bit.

The kernel itself is held against its plain version on the card
(``tests/test_torch_kernels.py``, ``test_*_mma_*``, ``test_mla_*``).
"""
import shutil

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("q_dtype,kv_dtype,hd,entry", [
    (BF16, BF16, 64, "paged_prefill_attention_bf16_bf16_mma"),
    (BF16, BF16, 128, "paged_prefill_attention_bf16_bf16_mma"),
    (BF16, BF16, 32, "paged_prefill_attention_bf16_bf16"),
    (BF16, BF16, 96, "paged_prefill_attention_bf16_bf16"),
    # (ids as the entries before the split-TF32 body took f32 q)
    pytest.param(F32, BF16, 64, "paged_prefill_attention_f32_bf16_tf32",
                 id="q_dtype4-kv_dtype4-64-paged_prefill_attention_f32_bf16"),
    pytest.param(F32, F32, 128, "paged_prefill_attention_f32_f32_tf32",
                 id="q_dtype5-kv_dtype5-128-paged_prefill_attention_f32_f32"),
    (F32, F32, 96, "paged_prefill_attention_f32_f32"),
    (F32, BF16, 32, "paged_prefill_attention_f32_bf16"),
    # nemotron-4-340b's 192: bf16 on the tensor cores, f32 q in split TF32
    # (8-warp blocks, whose shared memory does not grow with G; ids as
    # when f32 q took the CUDA-core body there)
    (BF16, BF16, 192, "paged_prefill_attention_bf16_bf16_mma"),
    pytest.param(F32, F32, 192, "paged_prefill_attention_f32_f32_tf32",
                 id="q_dtype9-kv_dtype9-192-paged_prefill_attention_f32_f32"),
    pytest.param(F32, BF16, 192, "paged_prefill_attention_f32_bf16_tf32",
                 id="q_dtype10-kv_dtype10-192-"
                    "paged_prefill_attention_f32_bf16")])
def test_paged_prefill_dispatch(q_dtype, kv_dtype, hd, entry):
    """bf16 q and pools at head_dim 64, 128 or 192 go to the bf16
    tensor-core body, f32 q at 64, 128 or 192 to the split-TF32 body; the
    rest to the CUDA-core body."""
    assert fops.paged_prefill_entry(q_dtype, kv_dtype, hd) == entry
    assert entry in fops.KERNEL.entries


@pytest.mark.parametrize("dtype,hd,entry", [
    (BF16, 64, "flash_attention_bf16_mma"),
    (BF16, 128, "flash_attention_bf16_mma"),
    (BF16, 32, "flash_attention_bf16"),
    pytest.param(F32, 64, "flash_attention_f32_tf32",
                 id="dtype3-64-flash_attention_f32"),
    pytest.param(F32, 128, "flash_attention_f32_tf32",
                 id="dtype4-128-flash_attention_f32"),
    (F32, 96, "flash_attention_f32"),
    (BF16, 192, "flash_attention_bf16_mma"),
    pytest.param(F32, 192, "flash_attention_f32_tf32",
                 id="dtype7-192-flash_attention_f32")])
def test_flash_dispatch(dtype, hd, entry):
    assert fops.flash_entry(dtype, hd) == entry
    assert entry in fops.FLASH_KERNEL.entries


@pytest.mark.parametrize("hd,entry", [
    (64, "paged_prefill_attention_quant_f32_tf32"),
    (128, "paged_prefill_attention_quant_f32_tf32"),
    (16, "paged_prefill_attention_quant_f32"),
    (96, "paged_prefill_attention_quant_f32"),
    pytest.param(192, "paged_prefill_attention_quant_f32_tf32",
                 id="192-paged_prefill_attention_quant_f32")])
def test_quant_prefill_dispatch(hd, entry):
    """K2q at head_dim 64, 128 or 192 runs the split-TF32 body (int8
    tiles, folded row scales), elsewhere the CUDA-core body."""
    assert fops.quant_prefill_entry(hd) == entry
    assert entry in fops.QUANT_KERNEL.entries


class _FakeLib:
    """Stands in for a loaded library: each entry returns the code it is
    given (0 = launched), and error strings exist."""

    def __init__(self, entries):
        for e in entries:
            setattr(self, e, lambda rc: rc)

    @staticmethod
    def kernel_error_string(code):
        return b"fake error"


def test_kernel_counts_launches_per_entry(monkeypatch):
    """Every accepted launch adds one to ``launches`` and to its entry's
    count; a refused one adds nothing and raises; ``reset_launches``
    zeroes both."""
    k = build.CudaKernel("k", fops.KERNEL.source,
                         {"body_a": [], "body_b": []})
    assert k.entry_launches == {"body_a": 0, "body_b": 0}
    monkeypatch.setattr(k, "load", lambda: _FakeLib(k.entries))
    k.launch("body_a", 0)
    k.launch("body_b", 0)
    k.launch("body_b", 0)
    with pytest.raises(RuntimeError, match="body_a failed to launch"):
        k.launch("body_a", 7)
    assert k.launches == 3
    assert k.entry_launches == {"body_a": 1, "body_b": 2}
    k.reset_launches()
    assert k.launches == 0
    assert k.entry_launches == {"body_a": 0, "body_b": 0}


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    """On the CPU the wrappers compute their plain versions, whatever the
    dispatch rule would pick on a card."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 8, 6, 64), generator=g).bfloat16()
    k = torch.randn((2, 8, 3, 64), generator=g).bfloat16()
    v = torch.randn((2, 8, 3, 64), generator=g).bfloat16()
    before = dict(fops.FLASH_KERNEL.entry_launches)
    got = fops.flash_attention(q, k, v, causal=True)
    want = fops.flash_attention_plain(q, k, v, causal=True)
    assert torch.equal(got, want)
    assert fops.FLASH_KERNEL.entry_launches == before


@pytest.mark.parametrize("kernel", [fops.KERNEL, fops.FLASH_KERNEL],
                         ids=["paged", "contiguous"])
def test_library_hash_covers_the_tensor_core_body(kernel, tmp_path):
    """Both libraries are built from prefill_mma.cuh (and the int8 one is
    not), so an edit of it changes their library paths."""
    assert "prefill_mma.cuh" in [f.name for f in
                                 build.source_files(kernel.source)]
    assert "prefill_mma.cuh" not in [
        f.name for f in build.source_files(fops.QUANT_KERNEL.source)]
    kernels = kernel.source.parents[2]          # .../kernels
    tree = tmp_path / "kernels"
    for sub in ("csrc", "flash_attention/csrc"):
        shutil.copytree(kernels / sub, tree / sub)
    source = tree / "flash_attention" / "csrc" / kernel.source.name
    before = build.library_path(kernel.name, source)
    assert before.name == build.library_path(kernel.name,
                                             kernel.source).name
    header = tree / "flash_attention" / "csrc" / "prefill_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build.library_path(kernel.name, source) != before


# -- MLA (DeepSeek-V3): shared rope key, V at its own head dim ---------------

MLA = (128, 64, 128)        # DeepSeek-V3's nope, rope, v head dims
SMOKE = (32, 16, 32)        # the deepseek-v3 smoke config's


@pytest.mark.parametrize("dtypes,dims,flash,decode", [
    ((BF16,) * 4, MLA, "flash_attention_mla_bf16_mma",
     "decode_attention_mla_bf16"),
    # f32 at MLA's dims: the GQA operands at q/k 192, the split-TF32
    # bodies (ids as when they were the CUDA-core ones)
    pytest.param((F32,) * 4, MLA, "flash_attention_f32_tf32",
                 "decode_attention_f32_f32_tf32",
                 id="dtypes1-dims1-flash_attention_f32-"
                    "decode_attention_f32_f32"),
    ((F32,) * 4, SMOKE, "flash_attention_f32", "decode_attention_f32_f32"),
    ((BF16,) * 4, SMOKE, "flash_attention_bf16", "decode_attention_bf16_bf16"),
    # q/k 128: the tensor-core decode body at G = 1 (id as before it)
    pytest.param((BF16,) * 4, (64, 64, 128), "flash_attention_bf16_mma",
                 "decode_attention_bf16_bf16_mma",
                 id="dtypes4-dims4-flash_attention_bf16_mma-"
                    "decode_attention_bf16_bf16"),
    pytest.param((F32, BF16, BF16, BF16), MLA, "flash_attention_f32_tf32",
                 "decode_attention_f32_bf16",
                 id="dtypes5-dims5-flash_attention_f32-"
                    "decode_attention_f32_bf16")])
def test_mla_dispatch(dtypes, dims, flash, decode):
    """bf16 throughout at DeepSeek-V3's dims goes to the MLA entries;
    other types or dims (the f32 smoke model's) to the GQA entries over
    the concatenated operands, by ``flash_entry``'s rule at head_dim
    nope + rope.  Every entry exists in its library."""
    assert fops.mla_flash_entry(dtypes, dims) == flash
    assert dops.mla_entry(dtypes, dims) == decode
    assert flash in fops.FLASH_KERNEL.entries
    assert decode in dops.DENSE_KERNEL.entries


def _mla_heads_before(q_nope, q_rope, k_nope, k_rope, v):
    """The operands the model built for the GQA kernels before the MLA
    entries (q = [q_nope, q_rope]; K = [k_nope, the rope key broadcast];
    V zero-padded), written out here as the model had them."""
    qk = k_nope.shape[-1] + k_rope.shape[-1]
    q = torch.cat([q_nope, q_rope], dim=-1)
    dt = torch.promote_types(k_nope.dtype, k_rope.dtype)
    k = torch.cat([k_nope.to(dt), k_rope.to(dt).expand(
        k_nope.shape[:3] + (k_rope.shape[-1],))], dim=-1)
    v = F.pad(v, (0, qk - v.shape[-1]))
    return q.contiguous(), k.contiguous(), v.to(k.dtype).contiguous()


def _mla_case(seed, B, S, T, H, dims, dtype):
    nope, rope, vd = dims
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dtype)
    return (t(B, S, H, nope), t(B, S, H, rope), t(B, T, H, nope),
            t(B, T, 1, rope), t(B, T, H, vd))


@pytest.mark.parametrize("dims", [SMOKE, MLA], ids=["smoke", "deepseek"])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_mla_flash_plain_equals_the_padded_gqa_operands(dims, dtype):
    """``mla_flash_attention`` on the CPU (its plain version) equals
    ``flash_attention_plain`` over the old concatenated, padded operands,
    cut to v_head_dim, bit for bit; and it launches nothing."""
    q_nope, q_rope, k_nope, k_rope, v = _mla_case(1, 2, 9, 9, 3, dims, dtype)
    q, k, vp = _mla_heads_before(q_nope, q_rope, k_nope, k_rope, v)
    want = fops.flash_attention_plain(q, k, vp, causal=True)[..., :dims[2]]
    before = dict(fops.FLASH_KERNEL.entry_launches)
    got = fops.mla_flash_attention(q, k_nope, k_rope[:, :, 0], v)
    assert fops.FLASH_KERNEL.entry_launches == before
    assert got.shape == (2, 9, 3, dims[2]) and got.dtype == want.dtype
    assert torch.equal(got, want)
    assert torch.equal(got, fops.mla_flash_attention_plain(
        q, k_nope, k_rope[:, :, 0], v))


@pytest.mark.parametrize("dims", [SMOKE, MLA], ids=["smoke", "deepseek"])
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("n_valid", [1, 7, 11])
def test_mla_decode_plain_equals_the_padded_gqa_operands(dims, dtype,
                                                         n_valid):
    """``mla_decode_attention`` on the CPU (its plain version) over K/V
    expanded for the first 11 slots and the rope keys of a 16-slot latent
    cache read in place equals ``decode_attention_plain`` over the old
    operands (the cache's first 11 rope keys broadcast, V padded), cut to
    v_head_dim, bit for bit; and it launches nothing."""
    q_nope, q_rope, k_nope, _, v = _mla_case(2, 2, 1, 11, 4, dims, dtype)
    kr_cache = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 16, dims[1])).astype(np.float32)).to(dtype)
    q, k, vp = _mla_heads_before(q_nope, q_rope, k_nope,
                                 kr_cache[:, :11, None], v)
    want = dops.decode_attention_plain(q[:, 0].contiguous(), k, vp,
                                       n_valid)[..., :dims[2]]
    before = dict(dops.DENSE_KERNEL.entry_launches)
    got = dops.mla_decode_attention(q[:, 0].contiguous(), k_nope, kr_cache,
                                    v, n_valid)
    assert dops.DENSE_KERNEL.entry_launches == before
    assert got.shape == (2, 4, dims[2]) and got.dtype == want.dtype
    assert torch.equal(got, want)
