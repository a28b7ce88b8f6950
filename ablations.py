"""Where the tensor-core attention bodies' time goes, on one GPU.

    python3 ablations.py [--body mma|tf32|bwd32|dec8|all]

Builds the entries of a body from the sources in this checkout and from
copies of it with one part cut out or changed, under
``build/ablations/``, and times each with ``chip_smoke.py``'s Timer
(cold L2, device time) at its phase-3 shapes.  The bodies: ``mma``
(``csrc/prefill_mma.cuh``, bf16: B2 contiguous and K2 paged, and B2's
MLA instantiation at DeepSeek-V3's heads, q/k 192 with a shared rope key
and V 128, at phase 3's S = 512 and phase 13(b)'s S = 128), ``tf32``
(``csrc/prefill_tf32.cuh``, split TF32: f32 B2 contiguous at smollm,
jamba and nemotron-4-340b heads, f32 K2 and K2q over int8 pools) and
``bwd32`` (``csrc/backward_tf32.cuh``, B2's f32 backward in split TF32
at smollm's and jamba's heads, B = 8, S = 512, causal, given the
``*_lse`` forward's logsumexp) and ``dec8`` (``decode_attention/csrc/
decode_gqa_mma.cuh`` over int8 pools: B3's
``paged_decode_attention_quant_f32_tf32`` at phase 3's smollm rows and
at jamba's, nemotron-4-340b's and glm4-9b's heads, B = 8, each at the
split plan ``ops.entry_split_plan`` gives it).

  body       the body as it is (its output checked against the plain
             version, within chip_smoke's tolerance)
  null       no key tiles: q read and the output written, nothing else
  loads      the K/V ring runs, the math does not
  math       the math runs over the first tiles again and again, no
             loads after them
  no_mask    (mma) the masking branch cut out (diagonal, window edges)
  deep_ring  (mma) 5 ring stages at head_dim 64, 3 at 128 and at MLA's
             192 / 128 (from 3 and 2)
  mla_warps4 (mma) MLA's blocks of 4 warps (64 rows, 2 blocks a SM, q
             in the last ring stage) instead of 8 (128 rows, 1 a SM)
  min1       (tf32) no register cap at head_dim 128 either (the body
             asks for three blocks a SM there: at most 168 registers)
  min3       (tf32) the 168-register cap at head_dim 64 too (~220
             registers there without it)
  q_regs     (tf32) q's fragments in registers at head_dim 128 too (the
             body stages them in shared memory there)
  cvt_split  (tf32, bwd32) the operands split with cvt.rna.tf32.f32
             where the body rounds in integer arithmetic
             (split_tf32_int: head_dim 192 and the backward); the same
             bits, other instructions
  no_fold    (bwd32) the gradients' products accumulated on the tensor
             cores, k8 step after k8 step, not summed apart and added
  warps4     (dec8) blocks of 4 warps (8 in the body: two a
             sub-partition)
  stages2    (dec8) 2 ring stages at head_dim 64 (4 in the body)
  stages3    (dec8) 3 ring stages at head_dim 128 and 192 (2 in the body)
  no_cluster (dec8) the splits merged through the workspace by the last
             block (the merge where the clusters cannot all be resident),
             not in a cluster's distributed shared memory
  chain      (dec8) Q.K's and P.V's products accumulated on the tensor
             cores, k8 step after k8 step, not summed apart and added
  no_merge   (dec8) the splits' merge cut out (each block writes its own
             partial output; still launched as clusters)
  no_qk      (dec8) no Q.K products (the scores zero; loads, softmax and
             P.V run)
  no_pv      (dec8) no P.V products (V widened and folded in without
             them)

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
    "math": [("      load_tile(it + kStages - 1, (it + kStages - 1) % kStages);",
              "      ;")],
}
# an edit of another header than the body's: (path, old, new)
_CVT = ("flash_attention/csrc/prefill_tf32.cuh",
        "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
        "  return to_tf32(x);")
# the int8 decode body's edits (dec8)
_W4 = ("kInt8Warps = 8;", "kInt8Warps = 4;")
_S2 = ("kInt8Stages = kHd <= 64 ? 4 : 2;", "kInt8Stages = 2;")
_S3 = ("kInt8Stages = kHd <= 64 ? 4 : 2;", "kInt8Stages = kHd <= 64 ? 4 : 3;")
_NO_CLUSTER = ("  if (n_split > 1 && n_split <= kClusterMax) {",
               "  if (false) {")
_NULL8 = ("      k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys : 0;",
          "      0;")
_NO_MERGE = ("  if (n_split == 1) {", "  if (true) {")
_NO_QK = ("      scores_int8<kHd>(s, q_s, ks, gr, tc);",
          "      for (int n = 0; n < kNT; ++n)\n"
          "        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;")
_NO_PV = ("            t32::mma2<true, kGv>(o + 4 * w + e0, ph, pl, vb);",
          "            for (int e = 0; e < kGv; ++e)\n"
          "              o[4 * w + e0 + e][0] += __uint_as_float(\n"
          "                  vb[e][0] ^ vb[e][1] ^ ph[e] ^ pl[e]);")
_QK_CHAIN = ("      t32::mma2<true, kNT>(s, qh, ql, kb);",
             "      t32::mma2<false, kNT>(s, qh, ql, kb);")
_PV_CHAIN = ("            t32::mma2<true, kGv>(o + 4 * w + e0, ph, pl, vb);",
             "            t32::mma2<false, kGv>(o + 4 * w + e0, ph, pl, vb);")
BODIES = {
    "mma": ("flash_attention/csrc/prefill_mma.cuh", dict(
        body=[], **_CUTS,
        loads=[("    if (!warp_active || (kWarpSkip && k0 > warp_top)) continue;",
                "    continue;")],
        no_mask=[("    if (k0 < warp_lo || k0 + kKeyTile - 1 > warp_hi) {",
                  "    if (false) {")],
        deep_ring=[("launch_hd<Rows, 64, 64, 3, 4>",
                    "launch_hd<Rows, 64, 64, 5, 4>"),
                   ("launch_hd<Rows, 128, 128, 2, 4>",
                    "launch_hd<Rows, 128, 128, 3, 4>"),
                   ("kMlaWarps = 8, kMlaStages = 2;",
                    "kMlaWarps = 8, kMlaStages = 3;")],
        mla_warps4=[("kMlaWarps = 8, kMlaStages = 2;",
                     "kMlaWarps = 4, kMlaStages = 2;")])),
    "tf32": ("flash_attention/csrc/prefill_tf32.cuh", dict(
        body=[], **_CUTS,
        loads=[("    if (!warp_active) continue;", "    continue;")],
        min1=[("kMinBlocks = kHd == 128 ? 3 : 1;", "kMinBlocks = 1;")],
        min3=[("kMinBlocks = kHd == 128 ? 3 : 1;", "kMinBlocks = 3;")],
        q_regs=[("  return kHd > 64;", "  return false;")],
        cvt_split=[_CVT])),
    "bwd32": ("flash_attention/csrc/backward_tf32.cuh", dict(
        body=[], cvt_split=[_CVT],
        no_fold=[("      mma3<true, kGroup>(c + n0, ah, al, bh, bl);",
                  "      mma3<false, kGroup>(c + n0, ah, al, bh, bl);")])),
    "dec8": ("decode_attention/csrc/decode_gqa_mma.cuh", dict(
        body=[], warps4=[_W4], stages2=[_S2], stages3=[_S3],
        no_cluster=[_NO_CLUSTER], chain=[_QK_CHAIN, _PV_CHAIN],
        null=[_NULL8], no_merge=[_NO_MERGE], no_qk=[_NO_QK],
        no_pv=[_NO_PV])),
}


def build_variants(body: str, fops, CudaKernel):
    """One {"paged", "flash", "quant"} set of CudaKernels per variant of
    ``body`` ({"decode8"} for dec8), built from a copy of the kernel
    sources with its edits."""
    from repro_torch.kernels.decode_attention import ops as dops
    path, variants = BODIES[body]
    src = ROOT / "src" / "repro_torch" / "kernels"
    libs = {}
    for name, edits in variants.items():
        tree = ROOT / "build" / "ablations" / body / name / "kernels"
        shutil.rmtree(tree, ignore_errors=True)
        for sub in ("csrc", "flash_attention/csrc", "decode_attention/csrc"):
            shutil.copytree(src / sub, tree / sub)
        for edit in edits:
            where, old, new = edit if len(edit) == 3 else (path, *edit)
            header = tree / where
            text = header.read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"{body}/{name}: {where} no longer holds "
                                   f"{old!r}")
            header.write_text(text.replace(old, new))
        csrc = tree / "flash_attention" / "csrc"
        if body == "dec8":
            libs[name] = {"decode8": CudaKernel(
                f"ablate_{body}_{name}", tree / "decode_attention" / "csrc"
                / "paged_decode_quant.cu", dops.QUANT_KERNEL.entries)}
            continue
        sources = (("backward", "flash_backward.cu", fops.BACKWARD_KERNEL),) \
            if body == "bwd32" else (
                ("paged", "paged_prefill.cu", fops.KERNEL),
                ("flash", "flash_prefill.cu", fops.FLASH_KERNEL),
                ("quant", "paged_prefill_quant.cu", fops.QUANT_KERNEL))
        libs[name] = {
            which: CudaKernel(f"ablate_{body}_{name}_{which}", csrc / source,
                              handle.entries)
            for which, source, handle in sources
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


def mla_call(kernel, entry, q, k_nope, k_rope, v):
    B, S, H, hd = q.shape
    out = torch.empty(q.shape[:3] + v.shape[-1:], dtype=q.dtype,
                      device=q.device)
    kernel.launch(entry, q.data_ptr(), k_nope.data_ptr(), k_rope.data_ptr(),
                  v.data_ptr(), out.data_ptr(), B, S, k_nope.shape[1], H,
                  ctypes.c_float(1 / np.sqrt(hd)), _stream())
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


def decode8_call(kernel, entry, q, kq, vq, ks, vs, pt, lengths):
    from repro_torch.kernels.decode_attention import ops as dops
    B, H, hd = q.shape
    out = torch.empty_like(q)
    kernel.launch(entry, q.data_ptr(), kq.data_ptr(), vq.data_ptr(),
                  ks.data_ptr(), vs.data_ptr(), pt.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), B, H, kq.shape[2], hd,
                  kq.shape[1], pt.shape[1], ctypes.c_float(1 / np.sqrt(hd)),
                  *dops._split_args(q, kq.shape[1] * pt.shape[1],
                                    kq.shape[2], entry=entry,
                                    kv_dtype=torch.int8), _stream())
    return out


def backward_call(kernel, entry, q, k, v, out, dout, lse):
    B, S, H, hd = q.shape
    grads = [torch.empty_like(t) for t in (q, k, v)]
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    kernel.launch(entry, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), dout.data_ptr(),
                  *(g.data_ptr() for g in grads), lse.data_ptr(),
                  delta.data_ptr(), B, S, k.shape[1], H, k.shape[2], hd, hd,
                  1, 0, ctypes.c_float(1 / np.sqrt(hd)), _stream())
    return grads


def cases(body: str, cs, fops):
    """(tag, which, entry, args, plain output, library call) at phase 3's
    shapes and seeds: B2 contiguous causal (and windowed, for mma) and K2
    at smollm and jamba heads; for mma B2's MLA entry at S = 512 and 128
    (random operands; ``which`` "mla", the flash library); K2q at smollm
    heads and B2 at nemotron-4-340b's (96/8 of 192) for tf32; for bwd32
    B2's f32 backward at phase 3's smollm and jamba rows (its plain
    output the gradients of ``flash_attention_backward_plain``, the
    library call SDPA's backward: its forward and backward less its
    forward)."""
    from repro_torch.models.attention import dequantize_kv
    dtype = torch.bfloat16 if body == "mma" else torch.float32
    out = []
    if body == "dec8":
        from repro_torch.kernels.decode_attention import ops as dops
        q, k, v, pt, lengths = cs._attn_case(8 * 7 + 2, 8, 1, dtype, dtype,
                                             cs.SMOLLM_HEADS)
        shapes = [("smollm phase 3", cs.SMOLLM_HEADS,
                   (q[:, 0].contiguous(), k, v, pt, lengths))]
        for geo, heads, n_keys in (("jamba", cs.JAMBA_HEADS, 544),
                                   ("nemotron", cs.NEMOTRON_HEADS, 544),
                                   ("glm4", cs.GLM4_HEADS, 4160),
                                   ("glm4", cs.GLM4_HEADS, 8192)):
            args, *_ = cs._gqa_decode_case(dops, True, heads, 8, n_keys,
                                           dtype, seed=n_keys + heads["hd"])
            shapes.append((f"{geo} {n_keys} keys", heads, args))
        for tag, heads, (q, k, v, pt, lengths) in shapes:
            kq, vq, ks, vs = cs._quant_pools(k, v)
            args = (q, kq, vq, ks, vs, pt, lengths)
            out.append((f"B3 {tag} B=8", "decode8",
                        dops.quant_decode_entry(heads["H"] // heads["KV"],
                                                heads["hd"]), args,
                        dops.paged_decode_attention_quant_plain(*args),
                        cs._attn_library_call(
                            q[:, None], dequantize_kv(kq, ks),
                            dequantize_kv(vq, vs), pt, lengths, 1, True,
                            heads)))
        return out
    if body == "bwd32":
        for case in cs.BACKWARD_CASES:
            geo, heads, dt, S, T, causal, window = case
            if dt != dtype or not causal or window or geo not in (
                    "smollm", "jamba"):
                continue
            _, (q, k, v), _ = cs.backward_case(*case)
            g = torch.Generator(device="cpu").manual_seed(S + T)
            dout = torch.randn(q.shape, generator=g).to("cuda", dtype)
            o, lse = fops._flash_forward(q, k, v, True, 0, lse=True)
            out.append((f"B2' {geo} B=8 S={S} causal", "backward",
                        fops.flash_backward_entry((dtype,), heads["hd"],
                                                  heads["hd"]),
                        (q, k, v, o, dout, lse),
                        fops.flash_attention_backward_plain(q, k, v, o, dout),
                        ("sdpa_backward", q, k, v, dout,
                         heads["H"] // heads["KV"])))
        return out
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
    if body == "mma":
        gen = torch.Generator(device="cpu").manual_seed(192)
        H, nope, rope, vd = 128, 128, 64, 128
        for S in (512, 128):
            q, kn, kr, v = (torch.randn(shape, generator=gen).to("cuda", dtype)
                            for shape in ((8, S, H, nope + rope),
                                          (8, S, H, nope), (8, S, rope),
                                          (8, S, H, vd)))
            k = torch.cat([kn, kr[:, :, None].expand(8, S, H, rope)], dim=-1)
            out.append((f"B2 MLA B=8 S={S} causal", "mla",
                        "flash_attention_mla_bf16_mma", (q, kn, kr, v),
                        fops.mla_flash_attention_plain(q, kn, kr, v),
                        cs._sdpa(q, k, v, 1, causal=True)))
    if body == "tf32":
        heads = cs.NEMOTRON_HEADS
        q, k, v = cs._dense_qkv(cs.NEMOTRON_CTX + heads["hd"] + 1, 8,
                                cs.NEMOTRON_CTX, cs.NEMOTRON_CTX, heads, dtype)
        out.append((f"B2 nemotron B=8 S={cs.NEMOTRON_CTX} causal", "flash",
                    fops.flash_entry(dtype, heads["hd"]), (q, k, v, 0),
                    fops.flash_attention_plain(q, k, v, causal=True),
                    cs._sdpa(q, k, v, heads["H"] // heads["KV"],
                             causal=True)))
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
    ap.add_argument("--body", choices=("mma", "tf32", "bwd32", "dec8", "all"),
                    default="all")
    bodies = ("mma", "tf32", "bwd32", "dec8") \
        if (b := ap.parse_args().body) == "all" else (b,)
    if not torch.cuda.is_available():
        print("ablations: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels.build import CudaKernel, load_all
    from repro_torch.kernels.flash_attention import ops as fops
    cs.phase_device()
    libs = {b: build_variants(b, fops, CudaKernel) for b in bodies}
    load_all([k for body in libs.values() for v in body.values()
              for k in v.values()])
    calls = {"flash": flash_call, "paged": paged_call, "quant": quant_call,
             "mla": mla_call, "backward": backward_call,
             "decode8": decode8_call}
    libraries = {"flash": "flash", "paged": "paged", "quant": "quant",
                 "mla": "flash", "backward": "backward", "decode8": "decode8"}
    timer = cs.Timer()
    for body in bodies:
        variants = libs[body]
        rows = cases(body, cs, fops)
        times = {}
        for name in list(variants) + list(variants)[::-1]:
            for tag, which, entry, args, want, _ in rows:
                fn = (lambda c=calls[which],
                      kk=variants[name][libraries[which]], e=entry,
                      a=args: c(kk, e, *a))
                got = fn()
                torch.cuda.synchronize()
                if which == "backward":
                    # every variant's error logged: no_fold's is the drift
                    # of the unfolded sums
                    err = cs._grad_err(got, want)
                    print(f"{body} {name} {tag}: relative gradient error "
                          f"{err:.3e}", flush=True)
                    tol = cs.GRAD_TOL[got[0].dtype]
                    cs.check(name != "body" or err <= tol,
                             f"{body} {tag}: relative gradient error {err}")
                elif which == "decode8":
                    # every variant's error logged: the _chain variants
                    # sum in another order
                    err = (got.float() - want.float()).abs().max().item()
                    print(f"{body} {name} {tag}: max_abs_err {err:.3e}",
                          flush=True)
                    cs.check(name != "body" or err <= cs.TOL[want.dtype],
                             f"{body} {tag}: max_abs_err {err}")
                elif name == "body":
                    err = (got.float() - want.float()).abs().max().item()
                    # the MLA rows: one bf16 ulp of the largest output
                    tol = cs.TOL[want.dtype] if which != "mla" else \
                        max(cs.DENSE_BF16_TOL["flash_attention"],
                            cs._bf16_ulp(want))
                    cs.check(err <= tol, f"{body} {tag}: max_abs_err {err}")
                times.setdefault((tag, name), []).append(timer.ms(fn))
        print(f"{body}: ms (two readings each; H100 card line above)"
              .ljust(36) + "".join(n.rjust(16) for n in variants)
              + "SDPA".rjust(10))
        for tag, *_, library in rows:
            lib_ms = cs._sdpa_backward_ms(timer, *library[1:]) \
                if isinstance(library, tuple) else timer.ms(library)
            print(tag.ljust(36) + "".join(
                " ".join(f"{t:.4f}" for t in times[(tag, n)]).rjust(16)
                for n in variants) + f"{lib_ms:10.4f}")


if __name__ == "__main__":
    main()
