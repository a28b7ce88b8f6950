"""Where the tensor-core prefill bodies' time goes, on one GPU.

    python3 prefill_ablations.py [--body mma|tf32|all]

Builds the prefill entries of a body from the sources in this checkout
and from copies of it with one part cut out, under ``build/ablations/``,
and times each with ``chip_smoke.py``'s Timer (cold L2, device time) at
its phase-3 shapes.  The bodies: ``mma`` (``csrc/prefill_mma.cuh``,
bf16: B2 contiguous and K2 paged) and ``tf32`` (``csrc/prefill_tf32.cuh``,
split TF32: f32 B2 contiguous, f32 K2 and K2q over int8 pools).

  body       the body as it is (its output checked against the plain
             version, within chip_smoke's tolerance)
  null       no key tiles: q read and the output written, nothing else
  loads      the K/V ring runs, the math does not
  math       the math runs over the first tiles again and again, no
             loads after them
  no_mask    (mma) the masking branch cut out (diagonal, window edges)
  deep_ring  (mma) 5 ring stages at head_dim 64, 3 at 128 (from 3 and 2)
  min1       (tf32) no register cap at head_dim 128 either (the body
             asks for three blocks a SM there: at most 168 registers)
  min3       (tf32) the 168-register cap at head_dim 64 too (~220
             registers there without it)
  q_regs     (tf32) q's fragments in registers at head_dim 128 too (the
             body stages them in shared memory there)

The cut copies compute wrong outputs; only their times mean anything.
Each variant is timed twice, in the order given and then reversed, and
one SDPA call computing the same function is timed beside them.  Needs
one CUDA device and nvcc, as chip_smoke.py does.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
_CUTS = {
    "null": [("  const int n_tiles = k_hi >= k_lo ? (k_hi - k_lo) / kKeyTile "
              "+ 1 : 0;", "  const int n_tiles = 0;")],
    "loads": [("    if (!warp_active) continue;", "    continue;")],
    "math": [("      load_tile(it + kStages - 1, (it + kStages - 1) % kStages);",
              "      ;")],
}
BODIES = {
    "mma": ("flash_attention/csrc/prefill_mma.cuh", dict(
        body=[], **_CUTS,
        no_mask=[("    if (k0 < warp_lo || k0 + kKeyTile - 1 > warp_hi) {",
                  "    if (false) {")],
        deep_ring=[("launch_hd<Rows, 64, 3>", "launch_hd<Rows, 64, 5>"),
                   ("launch_hd<Rows, 128, 2>", "launch_hd<Rows, 128, 3>")])),
    "tf32": ("flash_attention/csrc/prefill_tf32.cuh", dict(
        body=[], **_CUTS,
        min1=[("kMinBlocks = kHd > 64 ? 3 : 1;", "kMinBlocks = 1;")],
        min3=[("kMinBlocks = kHd > 64 ? 3 : 1;", "kMinBlocks = 3;")],
        q_regs=[("  return kHd > 64;", "  return false;")])),
}


def build_variants(body: str, fops, CudaKernel):
    """One {"paged", "flash", "quant"} set of CudaKernels per variant of
    ``body``, built from a copy of the kernel sources with its edits."""
    path, variants = BODIES[body]
    src = ROOT / "src" / "repro_torch" / "kernels"
    libs = {}
    for name, edits in variants.items():
        tree = ROOT / "build" / "ablations" / body / name / "kernels"
        shutil.rmtree(tree, ignore_errors=True)
        for sub in ("csrc", "flash_attention/csrc"):
            shutil.copytree(src / sub, tree / sub)
        header = tree / path
        text = header.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{body}/{name}: the body no longer holds "
                                   f"{old!r}")
            text = text.replace(old, new)
        header.write_text(text)
        csrc = tree / "flash_attention" / "csrc"
        libs[name] = {
            which: CudaKernel(f"ablate_{body}_{name}_{which}", csrc / source,
                              handle.entries)
            for which, source, handle in (
                ("paged", "paged_prefill.cu", fops.KERNEL),
                ("flash", "flash_prefill.cu", fops.FLASH_KERNEL),
                ("quant", "paged_prefill_quant.cu", fops.QUANT_KERNEL))
            if which != "quant" or body == "tf32"}
    return libs


def _stream():
    return torch.cuda.current_stream().cuda_stream


def flash_call(kernel, entry, q, k, v, window):
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    kernel.launch(entry, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), B, S, k.shape[1], H, k.shape[2], hd, 1,
                  window, ctypes.c_float(1 / np.sqrt(hd)), _stream())
    return out


def paged_call(kernel, entry, q, k, v, pt, lengths):
    B, T, H, hd = q.shape
    out = torch.empty(q.shape, dtype=k.dtype, device=q.device)
    kernel.launch(entry, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  pt.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, T, H,
                  k.shape[2], hd, k.shape[1], pt.shape[1],
                  ctypes.c_float(1 / np.sqrt(hd)), _stream())
    return out


def quant_call(kernel, entry, q, kq, vq, ks, vs, pt, lengths):
    B, T, H, hd = q.shape
    out = torch.empty_like(q)
    kernel.launch(entry, q.data_ptr(), kq.data_ptr(), vq.data_ptr(),
                  ks.data_ptr(), vs.data_ptr(), pt.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), B, T, H, kq.shape[2], hd,
                  kq.shape[1], pt.shape[1], ctypes.c_float(1 / np.sqrt(hd)),
                  _stream())
    return out


def cases(body: str, cs, fops):
    """(tag, which, entry, args, plain output, library call) at phase 3's
    shapes and seeds: B2 contiguous causal (and windowed, for mma) and K2
    at smollm and jamba heads; K2q at smollm heads for tf32."""
    from repro_torch.models.attention import dequantize_kv
    dtype = torch.bfloat16 if body == "mma" else torch.float32
    out = []
    for geo, heads in (("smollm", cs.SMOLLM_HEADS), ("jamba", cs.JAMBA_HEADS)):
        G, hd = heads["H"] // heads["KV"], heads["hd"]
        for window in (0, 128) if body == "mma" else (0,):
            seed = 512 + window + (0 if geo == "smollm" else hd)
            q, k, v = cs._dense_qkv(seed, 8, 512, 512, heads, dtype)
            pos = torch.arange(512, device="cuda")
            mask = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - window)
            out.append((f"B2 {geo} B=8 S=512 causal"
                        + (f" window {window}" if window else ""), "flash",
                        fops.flash_entry(dtype, hd), (q, k, v, window),
                        fops.flash_attention_plain(
                            q, k, v, causal=True, sliding_window=window),
                        cs._sdpa(q, k, v, G, mask=mask if window else None,
                                 causal=not window)))
        args = cs._attn_case(8 * 7 + 32, 8, 32, dtype, dtype, heads)
        out.append((f"K2 {geo} B=8 T=32", "paged",
                    fops.paged_prefill_entry(dtype, dtype, hd), args,
                    fops.paged_prefill_attention_plain(*args),
                    cs._attn_library_call(*args, 32, False, heads)))
    if body == "tf32":
        heads = cs.SMOLLM_HEADS
        q, k, v, pt, lengths = cs._attn_case(8 * 7 + 32 + 1, 8, 32, dtype,
                                             dtype, heads)
        kq, vq, ks, vs = cs._quant_pools(k, v)
        args = (q, kq, vq, ks, vs, pt, lengths)
        out.append(("K2q smollm B=8 T=32", "quant",
                    fops.quant_prefill_entry(heads["hd"]), args,
                    fops.paged_prefill_attention_quant_plain(*args),
                    cs._attn_library_call(q, dequantize_kv(kq, ks),
                                          dequantize_kv(vq, vs), pt, lengths,
                                          32, False, heads)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--body", choices=("mma", "tf32", "all"), default="all")
    bodies = ("mma", "tf32") if (b := ap.parse_args().body) == "all" else (b,)
    if not torch.cuda.is_available():
        print("prefill_ablations: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels.build import CudaKernel, load_all
    from repro_torch.kernels.flash_attention import ops as fops
    cs.phase_device()
    libs = {b: build_variants(b, fops, CudaKernel) for b in bodies}
    load_all([k for body in libs.values() for v in body.values()
              for k in v.values()])
    calls = {"flash": flash_call, "paged": paged_call, "quant": quant_call}
    timer = cs.Timer()
    for body in bodies:
        variants = libs[body]
        rows = cases(body, cs, fops)
        times = {}
        for name in list(variants) + list(variants)[::-1]:
            for tag, which, entry, args, want, _ in rows:
                fn = (lambda c=calls[which], kk=variants[name][which],
                      e=entry, a=args: c(kk, e, *a))
                got = fn()
                torch.cuda.synchronize()
                if name == "body":
                    err = (got.float() - want.float()).abs().max().item()
                    cs.check(err <= cs.TOL[want.dtype],
                             f"{body} {tag}: max_abs_err {err}")
                times.setdefault((tag, name), []).append(timer.ms(fn))
        print(f"{body}: ms (two readings each; H100 card line above)"
              .ljust(36) + "".join(n.rjust(16) for n in variants)
              + "SDPA".rjust(10))
        for tag, *_, library in rows:
            print(tag.ljust(36) + "".join(
                " ".join(f"{t:.4f}" for t in times[(tag, n)]).rjust(16)
                for n in variants) + f"{timer.ms(library):10.4f}")


if __name__ == "__main__":
    main()
