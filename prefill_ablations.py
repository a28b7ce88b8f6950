"""Where the tensor-core prefill body's time goes, on one GPU.

    python3 prefill_ablations.py

Builds the bf16 prefill entries (B2 contiguous, K2 paged) from the body
in this checkout (``csrc/prefill_mma.cuh``) and from copies of it with
one part cut out, under ``build/ablations/``, and times each with
``chip_smoke.py``'s Timer (cold L2, device time) at its phase-3 shapes:

  body       the body as it is (its output checked against the plain
             version, within chip_smoke's bf16 tolerance)
  null       no key tiles: q staged and the output written, nothing else
  loads      the K/V ring runs, the math does not
  math       the math runs over the first tiles again and again, no
             loads after them
  no_mask    the masking branch cut out (diagonal, window edges)
  deep_ring  5 ring stages at head_dim 64, 3 at 128 (from 3 and 2)

The cut copies compute wrong outputs; only their times mean anything.
Each variant is timed twice, in the order given and then reversed, and
one SDPA call computing the same function is timed beside them.  Needs
one CUDA device and nvcc, as chip_smoke.py does.
"""
from __future__ import annotations

import ctypes
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BODY = "flash_attention/csrc/prefill_mma.cuh"
VARIANTS = {
    "body": [],
    "null": [("  const int n_tiles = k_hi >= k_lo ? (k_hi - k_lo) / kKeyTile "
              "+ 1 : 0;", "  const int n_tiles = 0;")],
    "loads": [("    if (!warp_active) continue;", "    continue;")],
    "math": [("      load_tile(it + kStages - 1, (it + kStages - 1) % kStages);",
              "      ;")],
    "no_mask": [("    if (k0 < warp_lo || k0 + kKeyTile - 1 > warp_hi) {",
                 "    if (false) {")],
    "deep_ring": [("launch_hd<Rows, 64, 3>", "launch_hd<Rows, 64, 5>"),
                  ("launch_hd<Rows, 128, 2>", "launch_hd<Rows, 128, 3>")],
}


def build_variants(fops, CudaKernel):
    """One (paged, contiguous) pair of CudaKernels per variant, built from
    a copy of the kernel sources with the variant's edits."""
    src = ROOT / "src" / "repro_torch" / "kernels"
    libs = {}
    for name, edits in VARIANTS.items():
        tree = ROOT / "build" / "ablations" / name / "kernels"
        shutil.rmtree(tree, ignore_errors=True)
        for sub in ("csrc", "flash_attention/csrc"):
            shutil.copytree(src / sub, tree / sub)
        body = tree / BODY
        text = body.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the body no longer holds {old!r}")
            text = text.replace(old, new)
        body.write_text(text)
        csrc = tree / "flash_attention" / "csrc"
        libs[name] = (
            CudaKernel(f"ablate_{name}_paged", csrc / "paged_prefill.cu",
                       fops.KERNEL.entries),
            CudaKernel(f"ablate_{name}_flash", csrc / "flash_prefill.cu",
                       fops.FLASH_KERNEL.entries))
    return libs


def flash_call(kernel, q, k, v, window):
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    kernel.launch("flash_attention_bf16_mma", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), B, S, k.shape[1], H,
                  k.shape[2], hd, 1, window, ctypes.c_float(1 / np.sqrt(hd)),
                  torch.cuda.current_stream().cuda_stream)
    return out


def paged_call(kernel, q, k, v, pt, lengths):
    B, T, H, hd = q.shape
    out = torch.empty_like(q)
    kernel.launch("paged_prefill_attention_bf16_bf16_mma", q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), pt.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), B, T, H, k.shape[2], hd,
                  k.shape[1], pt.shape[1], ctypes.c_float(1 / np.sqrt(hd)),
                  torch.cuda.current_stream().cuda_stream)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        print("prefill_ablations: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels.build import CudaKernel, load_all
    from repro_torch.kernels.flash_attention import ops as fops
    cs.phase_device()
    libs = build_variants(fops, CudaKernel)
    load_all([k for pair in libs.values() for k in pair])
    bf16 = torch.bfloat16
    cases = []   # (tag, which, args, plain output, library call)
    for geo, heads in (("smollm", cs.SMOLLM_HEADS), ("jamba", cs.JAMBA_HEADS)):
        G = heads["H"] // heads["KV"]
        for window in (0, 128):
            # chip_smoke's phase-3 seeds
            seed = 512 + window + (0 if geo == "smollm" else heads["hd"])
            q, k, v = cs._dense_qkv(seed, 8, 512, 512, heads, bf16)
            pos = torch.arange(512, device="cuda")
            mask = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - window)
            cases.append((f"B2 {geo} B=8 S=512 causal"
                          + (f" window {window}" if window else ""), "flash",
                          (q, k, v, window),
                          fops.flash_attention_plain(
                              q, k, v, causal=True, sliding_window=window),
                          cs._sdpa(q, k, v, G, mask=mask if window else None,
                                   causal=not window)))
        args = cs._attn_case(8 * 7 + 32, 8, 32, bf16, bf16, heads)
        cases.append((f"K2 {geo} B=8 T=32", "paged", args,
                      fops.paged_prefill_attention_plain(*args),
                      cs._attn_library_call(*args, 32, False, heads)))
    timer = cs.Timer()
    times = {}
    for name in list(libs) + list(libs)[::-1]:
        paged, flash = libs[name]
        for tag, which, args, want, _ in cases:
            kern, call = (flash, flash_call) if which == "flash" else \
                (paged, paged_call)
            fn = (lambda c=call, kk=kern, a=args: c(kk, *a))
            out = fn()
            torch.cuda.synchronize()
            if name == "body":
                err = (out.float() - want.float()).abs().max().item()
                cs.check(err <= cs.TOL[bf16], f"{tag}: max_abs_err {err}")
            times.setdefault((tag, name), []).append(timer.ms(fn))
    print("ms (two readings each; H100 card line above)".ljust(36)
          + "".join(n.rjust(16) for n in libs) + "SDPA".rjust(10))
    for tag, *_, library in cases:
        print(tag.ljust(36) + "".join(
            " ".join(f"{t:.4f}" for t in times[(tag, n)]).rjust(16)
            for n in libs) + f"{timer.ms(library):10.4f}")


if __name__ == "__main__":
    main()
