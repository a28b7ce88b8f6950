"""What of the tensor-core prefill body runs without a card: the rule
that sends (dtype, head_dim) to a body, the per-entry launch count that
shows which body served a run, and the library hash over the new header.

The kernel itself is held against its plain version on the card
(``tests/test_torch_kernels.py``, ``test_*_mma_*``).
"""
import shutil

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fops

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("q_dtype,kv_dtype,hd,entry", [
    (BF16, BF16, 64, "paged_prefill_attention_bf16_bf16_mma"),
    (BF16, BF16, 128, "paged_prefill_attention_bf16_bf16_mma"),
    (BF16, BF16, 32, "paged_prefill_attention_bf16_bf16"),
    (BF16, BF16, 96, "paged_prefill_attention_bf16_bf16"),
    (F32, BF16, 64, "paged_prefill_attention_f32_bf16"),
    (F32, F32, 128, "paged_prefill_attention_f32_f32")])
def test_paged_prefill_dispatch(q_dtype, kv_dtype, hd, entry):
    """bf16 q and pools at head_dim 64 or 128 go to the tensor-core body;
    f32 q or pools, and bf16 at any other head_dim, to the CUDA-core
    body."""
    assert fops.paged_prefill_entry(q_dtype, kv_dtype, hd) == entry
    assert entry in fops.KERNEL.entries


@pytest.mark.parametrize("dtype,hd,entry", [
    (BF16, 64, "flash_attention_bf16_mma"),
    (BF16, 128, "flash_attention_bf16_mma"),
    (BF16, 32, "flash_attention_bf16"),
    (F32, 64, "flash_attention_f32"),
    (F32, 128, "flash_attention_f32")])
def test_flash_dispatch(dtype, hd, entry):
    assert fops.flash_entry(dtype, hd) == entry
    assert entry in fops.FLASH_KERNEL.entries


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
