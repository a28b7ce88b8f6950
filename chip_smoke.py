"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without its
result line):
  1. device    — the card's name and power limit; TF32 off.
  2. build     — compile the nine hand-written CUDA kernels (one nvcc
                 each, in parallel) from the sources in this checkout;
                 log the registers, spills and shared memory of the
                 tensor-core prefill bodies (prefill_mma.cuh, bf16;
                 prefill_tf32.cuh, split TF32) per head_dim and K/V type,
                 and of the split decode body (decode_body.cuh).
  3. kernels   — each kernel against its plain PyTorch version at the
                 served shapes, with its time beside the plain version's,
                 one library call's (where one exists) and its bound:
                 paged decode / prefill attention (K1/K2) at smollm-360m
                 heads (15/5, head_dim 64; batch 4 and 8, lengths up to
                 ~600) and at jamba heads (32/8, head_dim 128); the
                 launch floor (a one-thread kernel under the same Timer);
                 the selective scan (B5) at d_inner 8192, d_state 16, B/C
                 as split views of one x_proj output: batch 8, T = 1 and
                 32, cold and with carried state and t_valid, and cold at
                 T = 512 (batch 8 and 1), then its slab entry in place at
                 batch 8, T = 1 and 32 (a fresh row, idle rows on a live
                 row's and an unowned slab, the dump row; unowned slabs
                 bit-identical); the top-k gating (B6) at 8 and 256
                 tokens x 16 experts, top-2, a tie-laden case, and 256
                 tokens x 4 (top-4), 64 and 256 experts (top-8); the
                 dense engine's contiguous flash
                 prefill (B2) at batch 8, S = 512, causal and with a
                 128-token window, f32 and bf16, smollm and jamba heads
                 (bf16 K2 and B2 must run their tensor-core entries, the
                 ``*_mma`` ones, f32 ones the ``*_tf32`` ones), and its
                 dense decode (B4)
                 at batch 8, a 584-slot cache, smollm and jamba heads, a
                 partly filled cache and a full (wrapped) ring; the int8
                 paged decode (B3) and int8 paged prefill (K2q) at smollm
                 heads, f32 q over int8 pools with per-row scales (batch 4
                 and 8; T = 32 for K2q, on its ``_tf32`` entry); the fused
                 transform (B7) at e4's (64, 224, 224, 3) uint8 -> f32 and
                 uint8 -> uint8, bit-exact.  Then the split decode body at
                 its split boundaries (K1, B3: rows of 0, 1, one split, one
                 split + 1 and all P * bs keys in one batch; B4: n_valid 1,
                 one split, one more, the whole cache), each decode entry
                 twice (the same bits), and the split-TF32 body's edges
                 (lengths 0, page straddles, T = 5 and 17; windows 16 and
                 128 at S = 77).
  4. engine    — small f32 models serve the same prompts on the GPU
                 (through the kernels) and on the CPU (plain path); the
                 greedy tokens must be equal.  Paged: 2 layers at
                 smollm-360m's head geometry (K1, K2), and one jamba
                 period at smoke width (8 layers, 4 experts; K1, K2, B5,
                 B6), and the smollm-shaped model over an int8 pool (B3,
                 K2q; K1/K2 must not launch).  Dense (paged=False): the
                 same smollm-shaped model (B2, B4), with a 48-token sliding
                 window whose ring wraps (B2, B4), and the smoke jamba (B2,
                 B4, B5, B6); the paged kernels must not launch there.  B5
                 runs its slab entry in the paged step and the dense
                 decode, its plain entry only in the dense prefill wave.
  5. main path — ``repro_torch.launch.serve`` serves smollm-360m at full
                 width (random weights from seed 0, bf16 KV) through the
                 stream pipeline; K1 and K2 must have launched, K2 only
                 through its tensor-core entry.  Then a
                 profiler trace of the same engine: device busy share, the
                 kernels that take the device time, and the device-to-host
                 copies per step (2.22; under 2.5 checked: no decode call
                 reads a device tensor on the host).
  6. jamba     — the engine serves jamba-v0.1 at full width, one period
                 (8 layers: 1 attention + 7 mamba, 4 MoE with 16 experts
                 top-2; bf16, random weights from seed 0 made on the
                 card), 16 requests of 512 prompt tokens, 32 new tokens,
                 batch 8; the four paged-path kernels must have launched
                 and the dense ones must not, B5 only through its slab
                 entry.  Then a profiler trace of the same engine (as
                 every trace: device operations per device step).
  7. dense     — ``repro_torch.launch.serve --paged off`` serves
                 smollm-360m at full width and depth through the stream
                 pipeline on the dense engine (bf16 cache, batch 8,
                 capacity 584 as the launcher derives it, 16 requests of
                 up to 512 prompt tokens, 64 new, burst 8); B2
                 (contiguous, only through its tensor-core entry) and B4
                 must have launched and K1/K2 must not.  Then a profiler
                 trace.
  8. int8      — smollm-360m at full width and depth with f32 weights
                 (random, seed 0) serves phase 5's 16 requests through the
                 pipeline over an int8 pool (batch 8, chunk 32, burst 8);
                 B3 and K2q (only through its ``_tf32`` entry) must have
                 launched and K1/K2 must not.  Then
                 the same model over an f32 pool (K2 only through
                 ``paged_prefill_attention_f32_f32_tf32``): greedy-token agreement
                 logged, bytes per block f32/int8 = 512/136 asserted.
                 Then a profiler trace of the int8 engine.
  9. preproc   — ``videotestsrc ! tensor_converter ! tensor_transform
                 option=<e4 chain> backend=fused ! tensor_sink`` parsed
                 and run at 224x224x3 frames, then batched by
                 ``tensor_aggregator`` to e4's (64, 224, 224, 3); outputs
                 equal the numpy chain within 1e-6 and B7 must have
                 launched; frames per second and the host copies against
                 B7's device time are logged.
 10. front door — (a) at phase 4's size (the 2-layer f32 smollm-headed
                 model, the same over an int8 pool, the smoke jamba): the
                 requests go on the batch lane under one schedule, a
                 decoding slot preempted (spilled to host, restored into
                 other blocks), a mid-prefill slot preempted (restarted)
                 and one ``engine_step`` fault (every survivor spilled,
                 the pools rebuilt); the card's tokens must equal the CPU
                 port's under the same schedule and its own run without
                 it, and each path's kernels must launch (K1/K2; B3/K2q;
                 K1/K2, B5's slab entry, B6).  (b) smollm-360m at full
                 width and depth (bf16, bf16 pool; batch 8, chunk 32,
                 burst 8) behind a ``TensorQueryServer`` on
                 127.0.0.1:0: one client sends 8 batch-lane requests
                 (512-token prompts, 64 new) and, once all 8 stream, 8
                 interactive ones (128-512 tokens), which preempt batch
                 slots; all 16 must end ok with 64 tokens, every
                 preempted request restored, the pool clean after
                 ``drain``, K1 and K2 (``_mma``) launched.  TTFT by lane
                 (p50/p99, the client's clock), tok/s and peak memory are
                 logged, with the share of tokens equal to a direct run
                 without the server (bf16 need not be batch-invariant).
                 Then a second engine serves the 8 batch prompts with an
                 ``engine_step`` fault mid-decode (one restart), and a
                 full-width gather -> scatter -> gather of 37 blocks of
                 every layer's pool must be bit-exact.
Two lines before the last is a JSON object with one entry per kernel
(K1/K2 launches from phase 5, B5/B6 from phase 6, B2-contiguous/B4 from
phase 7, B3/K2q from phase 8, B7 from phase 9); then the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``.  The
whole run takes ~4-7 minutes on one H100, the build included.
"""
from __future__ import annotations

import gc
import importlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
TOL_REASON = ("bf16: the plain version rounds q*scale, the scores and the "
              "normalized probabilities to bf16 as the reference does; the "
              "kernel keeps scores in f32 and rounds the unnormalized "
              "probabilities; outputs are bf16 (8 significant bits)")
# bf16 tolerances of the dense engine's kernels, each just above the
# largest error seen on the card at these inputs: B2's outputs reach
# |out| ~ 3, where one bf16 ulp is 1.56e-2, and it differs by one ulp;
# B4's, averaged over 544+ keys, stay below 0.5, where an ulp is
# 1.95e-3, and it differs by up to two
DENSE_BF16_TOL = {"flash_attention": 2e-2, "decode_attention": 6e-3}
SCAN_TOL = 1e-4
SCAN_TOL_REASON = ("scan outputs are f32 of magnitude ~10: the kernel's "
                   "expf and fused multiply-adds against torch's exp and "
                   "separate products, and its sequential d_state sum "
                   "against einsum's")
PAGED_KERNELS = ("paged_decode_attention", "paged_prefill_attention")
DENSE_KERNELS = ("flash_attention", "decode_attention")
QUANT_KERNELS = ("paged_decode_attention_quant",
                 "paged_prefill_attention_quant")
ATTN_KERNELS = PAGED_KERNELS + DENSE_KERNELS + QUANT_KERNELS
# a CUDA trace also records the runtime calls that issue the device work
# (cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, ...)
RUNTIME_CALL = re.compile(r"cu(da)?[A-Z]")
E4_CHAIN = "typecast:float32,divide:255.0,subtract:0.5,clamp:-0.5:0.5"
SMOLLM_HEADS = dict(H=15, KV=5, hd=64)   # smollm-360m: 15 query, 5 KV heads
JAMBA_HEADS = dict(H=32, KV=8, hd=128)   # jamba-v0.1: 32 query, 8 KV heads
BS, P, MAX_LEN = 16, 40, 600       # block size, pages per slot, lengths
REPLACES = {
    "paged_decode_attention": "src/repro/kernels/decode_attention/kernel.py:195",
    "paged_prefill_attention": "src/repro/kernels/flash_attention/kernel.py:67",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:67",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:240",
    "selective_scan": "src/repro/kernels/ssm_scan/kernel.py:53",
    "gating_topk": "src/repro/kernels/moe_gating/kernel.py:35",
    "paged_decode_attention_quant":
        "src/repro/kernels/decode_attention/kernel.py:141",
    # the int8 form of K2 (the reference dequantizes in XLA for T > 1)
    "paged_prefill_attention_quant":
        "src/repro/kernels/flash_attention/kernel.py:67",
    "fused_transform": "src/repro/kernels/transform/kernel.py:31"}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def reset(kernels) -> None:
    for k in kernels:
        k.reset_launches()


def check_served_by(kernels, name: str, entry: str, tag: str) -> None:
    """Every launch of kernel ``name`` since the last reset was of its C
    entry ``entry`` (which body served the run), and there was one."""
    k = next(k for k in kernels if k.name == name)
    check(k.launches > 0 and k.entry_launches[entry] == k.launches,
          f"{tag}: {name} launched {k.entry_launches}, not all {entry}")
    log(f"[{tag}] {name} launches by entry: "
        f"{ {e: n for e, n in k.entry_launches.items() if n} }")


# -- phase 1 --------------------------------------------------------------------

def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# -- phase 2 --------------------------------------------------------------------

def phase_build(kernels) -> None:
    from repro_torch.kernels.build import load_all
    t0 = time.perf_counter()
    paths = load_all(kernels)
    log(f"[build] {len(paths)} kernels built in "
        f"{time.perf_counter() - t0:.2f}s")
    for k, p in zip(kernels, paths):
        text = p.with_suffix(".log").read_text()
        report = [ln.strip() for ln in text.splitlines()
                  if "registers" in ln or "spill" in ln]
        log(f"[build] {k.name}: {p.relative_to(ROOT)}; "
            + " | ".join(report[:6]))
        _log_body_build(k.name, text)


def _log_body_build(name: str, text: str) -> None:
    """The redesigned bodies' instantiations in a ptxas report, registers
    and spills each: the tensor-core bodies (prefill_mma.cuh, bf16;
    prefill_tf32.cuh, split TF32) with head_dim and ring stages from the
    mangled template arguments and the dynamic shared memory the launch
    asks for (K and V tiles x stages x keys x padded rows, plus the int8
    row scales, and q at head_dim 128 in the TF32 body), and the split
    decode body (decode_body.cuh) by its types."""
    elt = {"f": 4, "13__nv_bfloat16": 2, "a": 1}
    fn, props = None, []
    for ln in text.splitlines() + ["Compiling entry function 'end'"]:
        if "Compiling entry function" in ln:
            if fn and "prefill_mma_kernel" in fn:
                targs = fn.split("prefill_mma_kernel", 1)[1]
                hd, stages = map(int, re.findall(r"Li(\d+)E", targs))
                smem = 2 * stages * 64 * (hd + 8) * 2
                log(f"[build] {name} tensor-core body hd {hd}: {stages} ring "
                    f"stages, {smem} bytes of dynamic shared memory; "
                    + " | ".join(props))
            elif fn and "prefill_tf32_kernel" in fn:
                targs = fn.split("prefill_tf32_kernel", 1)[1]
                hd, stages = map(int, re.findall(r"Li(\d+)E", targs)[-2:])
                kv = next(t for t in ("13__nv_bfloat16", "f", "a")
                          if targs.startswith("I" + t))
                quant = "RowScales" in targs
                # the ring, and q (64 rows x hd + 4 f32) at hd 128
                smem = stages * (2 * 32 * (hd * elt[kv] + 16)
                                 + (2 * 32 * 4 if quant else 0)) \
                    + (4 * 64 * (hd + 4) if hd > 64 else 0)
                log(f"[build] {name} split-TF32 body kv "
                    f"{ {'f': 'f32', 'a': 'int8'}.get(kv, 'bf16')} hd {hd}: "
                    f"{stages} ring stages, {smem} bytes of dynamic shared "
                    f"memory; " + " | ".join(props))
            elif fn and "decode_kernel" in fn:
                targs = fn.split("decode_kernel", 1)[1]
                names = {"f": "f32", "13__nv_bfloat16": "bf16", "a": "int8"}
                qt, kvt = re.match(r"I(13__nv_bfloat16|f)(S2_|13__nv_bfloat16"
                                   r"|f|a)", targs).groups()
                rows = "paged" if "PagedRows" in targs else "contiguous"
                log(f"[build] {name} split decode body q {names[qt]} kv "
                    f"{names.get(kvt, names[qt])} {rows}: "
                    + " | ".join(props))
            fn, props = ln, []
        elif "registers" in ln or "spill" in ln:
            props.append(ln.strip())


# -- phase 3 --------------------------------------------------------------------

class Timer:
    """Mean device time of ``fn`` over ``iters`` launches, each on a cold
    L2 (a 64 MB buffer is rewritten before every launch: in serving, the
    other layers' weights and K/V pass through the 50 MB L2 between two
    calls for the same layer).  Before each launch the GPU spins for
    ~1 ms, so the host has enqueued the whole launch before the start
    event runs and the interval holds device time only, not the
    wrapper's Python."""

    SPIN_CYCLES = 2_000_000

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 30, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        events = []
        for _ in range(iters):
            torch.cuda._sleep(self.SPIN_CYCLES)
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events) / iters


def _attn_case(seed, B, T, qdt, kvdt, heads):
    """Served-shape inputs: shuffled page tables over a pool with spare
    blocks, cached lengths spread from one page up to MAX_LEN."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    H, KV, hd = heads["H"], heads["KV"], heads["hd"]
    nb = B * P + 7
    q = torch.randn((B, T, H, hd), generator=g).to("cuda", qdt)
    k = torch.randn((nb, BS, KV, hd), generator=g).to("cuda", kvdt)
    v = torch.randn((nb, BS, KV, hd), generator=g).to("cuda", kvdt)
    pt = torch.stack([torch.randperm(nb, generator=g)[:P]
                      for _ in range(B)]).to("cuda", torch.int32)
    # at least one page per slot: a slot with two or three keys outputs
    # nearly one V row, where one bf16 ulp of |v| ~ 4 exceeds the tolerance
    lengths = torch.linspace(BS, MAX_LEN - T, B).round().to(torch.int32)
    lengths = lengths[torch.randperm(B, generator=g)].to("cuda")
    return q, k, v, pt, lengths


def _visible_keys(lengths, T, decode: bool):
    """(B, T) keys each query row attends to, from this run's data."""
    cap = P * BS
    if decode:                            # lengths = valid keys
        return lengths.clamp(max=cap)[:, None]
    t = torch.arange(T, device=lengths.device)[None, :]
    return (lengths[:, None] + t + 1).clamp(max=cap)


def _bound(n_bytes: float, ops: float, dtype):
    """The larger of bytes over HBM bandwidth and operations over the
    peak rate for ``dtype``, in ms, and which of the two it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _attn_bound_ms(q, k, lengths, T, decode, heads):
    """Least time for the same work: the bytes it must move (q, the K/V
    rows of the keys this data makes visible, the page-table entries they
    sit in, lengths, out) and its operations (QK and PV, multiply and
    add) at the peak rate for the K/V type."""
    B, H, hd, KV = q.shape[0], heads["H"], heads["hd"], heads["KV"]
    vis = _visible_keys(lengths, T, decode)
    keys = vis.max(dim=1).values                      # rows read per slot
    kv_bytes = int(keys.sum()) * KV * hd * k.element_size() * 2
    pages = int(((keys + BS - 1) // BS).sum()) * 4
    qo_bytes = q.numel() * (q.element_size() + k.element_size())
    return _bound(kv_bytes + pages + qo_bytes + B * 4,
                  4 * H * hd * int(vis.sum()), k.dtype)


def _attn_library_call(q, k, v, pt, lengths, T, decode, heads):
    """One PyTorch call computing the same function (timed only as a
    yardstick; the port never calls it): SDPA over K/V gathered through
    the page table and expanded to the query heads beforehand."""
    from repro_torch.models.attention import paged_gather
    G = heads["H"] // heads["KV"]
    B = q.shape[0]
    kg = paged_gather(k, pt).transpose(1, 2).repeat_interleave(G, dim=1)
    vg = paged_gather(v, pt).transpose(1, 2).repeat_interleave(G, dim=1)
    qh = q.reshape(B, T, heads["H"], heads["hd"]).transpose(1, 2)
    qh = qh.to(kg.dtype)
    kpos = torch.arange(kg.shape[2], device=q.device)[None, None, :]
    last = (lengths - 1)[:, None] if decode else \
        lengths[:, None] + torch.arange(T, device=q.device)[None, :]
    mask = (kpos <= last[:, :, None])[:, None]        # (B, 1, T, C)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qh, kg, vg, attn_mask=mask)


def _time_row(timer, kern, plain, args, library, bound):
    ms = timer.ms(lambda: kern(*args))
    plain_ms = timer.ms(lambda: plain(*args))
    lib_ms = timer.ms(library) if library is not None else None
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=lib_ms)


def _fmt(row) -> str:
    lib = "n/a" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
    return (f" kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"library_ms={lib} bound_ms={row['bound_ms']:.5f} "
            f"({row['bound_by']})")


def phase_attention(timer: Timer):
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    specs = [
        ("paged_decode_attention", dops.paged_decode_attention,
         dops.paged_decode_attention_plain, 1, True, dops.KERNEL),
        ("paged_prefill_attention", fops.paged_prefill_attention,
         fops.paged_prefill_attention_plain, 32, False, fops.KERNEL)]
    f32, bf16 = torch.float32, torch.bfloat16
    geometries = [("smollm", SMOLLM_HEADS, (4, 8),
                   [(f32, f32), (f32, bf16), (bf16, bf16)]),
                  ("jamba", JAMBA_HEADS, (8,), [(f32, f32), (bf16, bf16)])]
    served = {}
    for name, kern, plain, T, decode, handle in specs:
        for geo, heads, batches, combos in geometries:
            for B in batches:
                for qdt, kvdt in combos:
                    q, k, v, pt, lengths = _attn_case(B * 7 + T, B, T, qdt,
                                                      kvdt, heads)
                    if decode:
                        q = q[:, 0].contiguous()
                    args = (q, k, v, pt, lengths)
                    n0 = handle.launches
                    entry = None if decode else \
                        fops.paged_prefill_entry(qdt, kvdt, heads["hd"])
                    e0 = handle.entry_launches.get(entry, 0)
                    out = kern(*args)
                    torch.cuda.synchronize()
                    check(handle.launches == n0 + 1, f"{name} did not launch")
                    check(entry is None
                          or handle.entry_launches[entry] == e0 + 1,
                          f"{name} did not launch {entry}")
                    want = plain(*args)
                    check(torch.isfinite(out.float()).all().item(),
                          f"{name}: non-finite output")
                    err = (out.float() - want.float()).abs().max().item()
                    tol = TOL[kvdt]
                    tag = (f"{name} {geo} heads {heads['H']}/{heads['KV']} "
                           f"hd {heads['hd']} B={B} T={T} q={str(qdt)[6:]} "
                           f"kv={str(kvdt)[6:]}"
                           + ("" if entry is None else f" [{entry}]"))
                    check(err <= tol, f"{tag}: max_abs_err {err} > {tol}")
                    line = f"[kernels] {tag}: max_abs_err={err:.3e} (tol {tol})"
                    if qdt == kvdt:
                        row = _time_row(
                            timer, kern, plain, args,
                            _attn_library_call(*args, T, decode, heads),
                            _attn_bound_ms(q, k, lengths, T, decode, heads))
                        line += _fmt(row)
                        if geo == "smollm" and B == 8 and kvdt == bf16:
                            served[name] = dict(max_abs_err=err, **row)
                    log(line)
    log(f"[kernels] attention tolerance: f32 1e-5; {TOL_REASON}")
    return served


JAMBA_DT_RANK = 256      # jamba-v0.1: ceil(4096 / 16)


def _split_bc(Bc, Cc, dtr=JAMBA_DT_RANK):
    """Bc, Cc as the served path hands them to the scan: ``torch.split``
    views of one (B, T, dt_rank + 2N) x_proj output."""
    B, T, N = Bc.shape
    proj = torch.cat([torch.zeros((B, T, dtr), dtype=Bc.dtype,
                                  device=Bc.device), Bc, Cc], dim=-1)
    _, b, c = torch.split(proj, [dtr, N, N], dim=-1)
    return b, c


def _scan_case(seed, B, T, di, N, dtype, carried):
    """Selective-scan inputs as a Mamba layer makes them: dt from a
    softplus, A = -(1..N) per channel (the init's A_log), D = 1, Bc and
    Cc split views of one projection; with ``carried``, a random state
    slab and t_valid spread over [0, T]."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    dt = torch.nn.functional.softplus(torch.randn((B, T, di), generator=g))
    xs = torch.randn((B, T, di), generator=g)
    Bc = torch.randn((B, T, N), generator=g)
    Cc = torch.randn((B, T, N), generator=g)
    A = -torch.arange(1, N + 1, dtype=torch.float32).expand(di, N)
    D = torch.ones(di)
    if carried:
        h0 = torch.randn((B, di, N), generator=g)
        t_valid = torch.randint(0, T + 1, (B,), generator=g, dtype=torch.int32)
        t_valid[0], t_valid[-1] = 0, T
    else:
        h0 = torch.zeros((B, di, N))
        t_valid = torch.full((B,), T, dtype=torch.int32)
    dt, xs, Bc, Cc = (a.to("cuda", dtype) for a in (dt, xs, Bc, Cc))
    return (dt, xs) + _split_bc(Bc, Cc) + tuple(
        a.contiguous().to("cuda") for a in (A, D, h0, t_valid))


def _scan_bound_ms(dt, xs, Bc, Cc, A, D, t_valid, state_in: int,
                   state_out: int, extra: int = 0):
    """Bytes: dt, xs, the B and C columns, A, D and t_valid read once,
    ``state_in`` state slabs read (0 for a cold start) and ``state_out``
    written, y written, plus ``extra`` (row indices); operations: per
    valid position, channel and state element the exp, the dt*A and
    dt*x*B products, the state update and the C dot product (~7 f32
    operations), plus D*x."""
    B, T, di = dt.shape
    N = Bc.shape[-1]
    ins = [dt, xs, A, D, t_valid]
    n_bytes = sum(a.numel() * a.element_size() for a in ins) \
        + 2 * B * T * N * Bc.element_size() \
        + (state_in + state_out) * di * N * 4 + B * T * di * 4 + extra
    positions = int(t_valid.clamp(max=T).sum())
    return _bound(n_bytes, positions * di * (7 * N + 3), torch.float32)


def _slab_case(seed, T, dtype):
    """The served slab step (B = 8, d_inner 8192, d_state 16): a pool of
    8 slabs plus the dump row; rows 0-5 live (row 0 fresh: lengths 0,
    row 2 partly valid), row 6 idle on row 1's slab (a stale slot id),
    row 7 idle on slab 6, which no live row owns; rows 6 and 7 both
    write the dump.  Returns (scan operands, pool, read, write, live
    rows, slabs no row may touch)."""
    B, di, N = 8, 8192, 16
    dt, xs, Bc, Cc, A, D, _, _ = _scan_case(seed, B, T, di, N, dtype, False)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    pool = torch.randn((B + 1, di, N), generator=g).to("cuda")
    slots = torch.tensor([3, 0, 5, 1, 7, 2, 0, 6])
    lengths = torch.tensor([0, 100, 37, 500, 5, 200, 64, 9])
    t_valid = torch.tensor([T, T, max(T // 2, 1), T, T, T, 0, 0],
                           dtype=torch.int32)
    dump = B
    read = torch.where(lengths == 0, -1, slots)
    write = torch.where(t_valid > 0, slots, dump)
    ops = (dt, xs, Bc, Cc, A, D)
    return (ops, pool, read.to("cuda"), write.to("cuda"),
            t_valid.to("cuda"), list(range(6)), [4, 6])


def phase_scan(timer: Timer, floor_ms: float):
    """B5 through both entries.  The plain entry: T = 1 and 32, cold and
    carried (bf16 timed, f32 checked at T = 32 carried), and cold at
    T = 512 (the dense engine's prefill wave at B = 8, and B = 1, where
    the grid is 256 blocks: the case a time-split scan would serve).
    The slab entry at the served step shapes (T = 1 decode, T = 32
    chunk) in place, with a fresh row, idle rows on a live row's and on
    an unowned slab, and the dump row.  Returns the T = 32 slab row: the
    main path's entry."""
    from repro_torch.kernels.ssm_scan import ops as sops
    cases = [(8, T, carried, dtype) for T in (1, 32)
             for carried in (False, True)
             for dtype in (torch.bfloat16, torch.float32)
             if dtype == torch.bfloat16 or (carried and T == 32)]
    cases += [(8, 512, False, torch.bfloat16), (1, 512, False, torch.bfloat16)]
    for B, T, carried, dtype in cases:
        args = _scan_case(T + carried + B, B, T, 8192, 16, dtype, carried)
        n0 = sops.KERNEL.launches
        y, h = sops.selective_scan(*args)
        torch.cuda.synchronize()
        check(sops.KERNEL.launches == n0 + 1, "selective_scan did not launch")
        wy, wh = sops.selective_scan_plain(*args)
        check(bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
              "selective_scan: non-finite output")
        err = max((y - wy).abs().max().item(), (h - wh).abs().max().item())
        tag = (f"selective_scan B={B} T={T} di=8192 N=16 {str(dtype)[6:]} "
               + ("carried h0 + t_valid" if carried else "cold")
               + ", Bc/Cc split views")
        check(err <= SCAN_TOL, f"{tag}: max_abs_err {err}")
        line = f"[kernels] {tag}: max_abs_err={err:.3e} (tol {SCAN_TOL})"
        if dtype == torch.bfloat16:
            dt, xs, Bc, Cc, A, D, h0, t_valid = args
            row = _time_row(timer, sops.selective_scan,
                            sops.selective_scan_plain, args, None,
                            _scan_bound_ms(dt, xs, Bc, Cc, A, D, t_valid,
                                           B if carried else 0, B))
            line += _fmt(row)
        log(line)
    served = None
    for T in (1, 32):
        ops, pool, read, write, t_valid, live, untouched = _slab_case(
            T, T, torch.bfloat16)
        got, want = pool.clone(), pool.clone()
        entry = "selective_scan_slab_bf16"
        n0 = sops.KERNEL.entry_launches[entry]
        y = sops.selective_scan_slab(*ops, got, read, write, t_valid)
        torch.cuda.synchronize()
        check(sops.KERNEL.entry_launches[entry] == n0 + 1,
              f"{entry} did not launch")
        wy = sops.selective_scan_slab_plain(*ops, want, read, write, t_valid)
        check(bool(torch.isfinite(y).all() and torch.isfinite(got).all()),
              "selective_scan_slab: non-finite output")
        slabs = write[live].tolist()
        err = max((y[live] - wy[live]).abs().max().item(),
                  (got[slabs] - want[slabs]).abs().max().item())
        tag = (f"selective_scan_slab B=8 T={T} di=8192 N=16 bfloat16 in "
               f"place, read {read.tolist()} write {write.tolist()}")
        check(err <= SCAN_TOL, f"{tag}: max_abs_err {err}")
        check(all(torch.equal(got[i], pool[i]) for i in untouched),
              f"{tag}: a slab no live row owns changed")

        def run(*a, _pool=pool.clone()):
            return sops.selective_scan_slab(*a[:6], _pool, *a[6:])

        def plain(*a, _pool=pool.clone()):
            return sops.selective_scan_slab_plain(*a[:6], _pool, *a[6:])

        args = ops + (read, write, t_valid)
        reads = len({r for r in read.tolist() if r >= 0})
        row = _time_row(timer, run, plain, args, None, _scan_bound_ms(
            *ops, t_valid, reads, len(set(write.tolist())), 2 * 8 * 8))
        log(f"[kernels] {tag}: max_abs_err={err:.3e} (tol {SCAN_TOL}); "
            f"slabs {untouched} bit-identical" + _fmt(row)
            + (f" launch_floor_ms={floor_ms:.4f}" if T == 1 else ""))
        if T == 32:
            served = dict(max_abs_err=err, **row)
    log(f"[kernels] scan tolerance: {SCAN_TOL}; {SCAN_TOL_REASON}")
    return served


def phase_floor(timer: Timer) -> float:
    """The launch floor: one one-thread kernel (``torch.cuda._sleep(1)``)
    under the same Timer, the least any launch can read here."""
    ms = timer.ms(lambda: torch.cuda._sleep(1))
    log(f"[kernels] launch floor: a one-thread kernel under the same "
        f"Timer, {ms:.4f} ms")
    return ms


def phase_gating(timer: Timer, floor_ms: float):
    from repro_torch.kernels.moe_gating import ops as gops
    served = None
    cases = [(8, 16, 2, False), (256, 16, 2, False), (256, 16, 2, True),
             (256, 4, 4, False), (256, 64, 8, False), (256, 256, 8, False)]
    for T, E, k, tied in cases:
        g = torch.Generator(device="cpu").manual_seed(T + tied + E)
        if tied:   # a 3-level grid: most rows hold exact ties
            scores = torch.randint(0, 3, (T, E), generator=g).float() / 4
        else:
            scores = torch.softmax(torch.randn((T, E), generator=g), dim=-1)
        scores = scores.to("cuda")
        n0 = gops.KERNEL.launches
        vals, idx = gops.gating_topk(scores, k)
        torch.cuda.synchronize()
        check(gops.KERNEL.launches == n0 + 1, "gating_topk did not launch")
        wv, wi = gops.gating_topk_plain(scores, k)
        exact = torch.equal(vals, wv) and torch.equal(idx, wi)
        tag = f"gating_topk T={T} E={E} k={k}" + (" ties" if tied else "")
        check(exact, f"{tag}: kernel and plain version differ")
        err = (vals - wv).abs().max().item()
        row = _time_row(timer, gops.gating_topk, gops.gating_topk_plain,
                        (scores, k), lambda: torch.topk(scores, k),
                        _bound(T * E * 4 + T * k * 8, 2 * T * k * E,
                               torch.float32))
        log(f"[kernels] {tag}: exact (values and indices)" + _fmt(row)
            + f" launch_floor_ms={floor_ms:.4f}")
        if (T, E, tied) == (256, 16, False):
            served = dict(max_abs_err=err, **row)
    log("[kernels] gating tolerance: exact; library call: torch.topk")
    return served


def _dense_qkv(seed, B, S, T, heads, dtype):
    g = torch.Generator(device="cpu").manual_seed(seed)
    H, KV, hd = heads["H"], heads["KV"], heads["hd"]
    return tuple(torch.randn(shape, generator=g).to("cuda", dtype)
                 for shape in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd)))


def _sdpa(q, k, v, G, mask=None, causal=False):
    """One SDPA call on (B, S, H, hd) q and K/V expanded to the query
    heads beforehand (the yardstick; the port never calls it)."""
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(G, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(G, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qh, kh, vh, attn_mask=mask, is_causal=causal)


def phase_dense_kernels(timer: Timer):
    """The dense engine's kernels at its served shapes: the contiguous
    flash prefill (B2) at B=8, S=T=512 and the dense decode (B4) at B=8
    over a 584-slot cache, the capacity phase 7 serves at."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    served = {}
    B, S = 8, 512
    cases = [(geo, heads, dt, w)
             for geo, heads in (("smollm", SMOLLM_HEADS), ("jamba", JAMBA_HEADS))
             for dt in (torch.float32, torch.bfloat16) for w in (0, 128)]
    for geo, heads, dtype, window in cases:
        H, KV, hd = heads["H"], heads["KV"], heads["hd"]
        seed = S + window if geo == "smollm" else S + window + hd
        q, k, v = _dense_qkv(seed, B, S, S, heads, dtype)
        n0 = fops.FLASH_KERNEL.launches
        entry = fops.flash_entry(dtype, hd)
        e0 = fops.FLASH_KERNEL.entry_launches[entry]
        out = fops.flash_attention(q, k, v, causal=True,
                                   sliding_window=window)
        torch.cuda.synchronize()
        check(fops.FLASH_KERNEL.launches == n0 + 1
              and fops.FLASH_KERNEL.entry_launches[entry] == e0 + 1,
              f"flash_attention did not launch {entry}")
        want = fops.flash_attention_plain(q, k, v, causal=True,
                                          sliding_window=window)
        check(torch.isfinite(out.float()).all().item(),
              "flash_attention: non-finite output")
        err = (out.float() - want.float()).abs().max().item()
        tol = TOL[dtype] if dtype == torch.float32 \
            else DENSE_BF16_TOL["flash_attention"]
        tag = (f"flash_attention (contiguous) {geo} heads {H}/{KV} hd "
               f"{hd} B={B} S=T={S} causal"
               + (f" window {window}" if window else "")
               + f" {str(dtype)[6:]} [{entry}]")
        check(err <= tol, f"{tag}: max_abs_err {err} > {tol}")
        pos = torch.arange(S, device="cuda")
        visible = (pos[None, :] <= pos[:, None])
        if window:
            visible &= pos[None, :] > pos[:, None] - window
        # q, k, v read once; out (q's shape and type) written once
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) \
            * q.element_size()
        ops = 4 * B * H * hd * int(visible.sum())
        library = _sdpa(q, k, v, H // KV, mask=None if not window
                        else visible, causal=not window)
        row = _time_row(timer, lambda *a: fops.flash_attention(
                            *a, causal=True, sliding_window=window),
                        lambda *a: fops.flash_attention_plain(
                            *a, causal=True, sliding_window=window),
                        (q, k, v), library,
                        _bound(n_bytes, ops, dtype))
        log(f"[kernels] {tag}: max_abs_err={err:.3e} (tol {tol})"
            + _fmt(row))
        if geo == "smollm" and dtype == torch.bfloat16 and not window:
            served["flash_attention"] = dict(max_abs_err=err, **row)
    C = 584
    for geo, heads in (("smollm", SMOLLM_HEADS), ("jamba", JAMBA_HEADS)):
        H, KV, hd = heads["H"], heads["KV"], heads["hd"]
        for n_valid, fill in ((544, "partly filled"), (C, "wrapped ring")):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = _dense_qkv(n_valid + hd, B, 1, C, heads, dtype)
                q = q[:, 0].contiguous()
                n0 = dops.DENSE_KERNEL.launches
                out = dops.decode_attention(q, k, v, n_valid)
                torch.cuda.synchronize()
                check(dops.DENSE_KERNEL.launches == n0 + 1,
                      "decode_attention did not launch")
                want = dops.decode_attention_plain(q, k, v, n_valid)
                check(torch.isfinite(out.float()).all().item(),
                      "decode_attention: non-finite output")
                err = (out.float() - want.float()).abs().max().item()
                tol = TOL[dtype] if dtype == torch.float32 \
                    else DENSE_BF16_TOL["decode_attention"]
                tag = (f"decode_attention (dense) {geo} heads {H}/{KV} hd "
                       f"{hd} B={B} C={C} n_valid={n_valid} ({fill}) "
                       f"{str(dtype)[6:]}")
                check(err <= tol, f"{tag}: max_abs_err {err} > {tol}")
                es = k.element_size()
                n_bytes = (q.numel() * (q.element_size() + es)
                           + 2 * B * n_valid * KV * hd * es)
                mask = (torch.arange(C, device="cuda") < n_valid)
                library = _sdpa(q[:, None], k, v, H // KV,
                                mask=mask[None, None, None, :])
                row = _time_row(timer, dops.decode_attention,
                                dops.decode_attention_plain,
                                (q, k, v, n_valid), library,
                                _bound(n_bytes, 4 * B * H * hd * n_valid,
                                       dtype))
                log(f"[kernels] {tag}: max_abs_err={err:.3e} (tol {tol})"
                    + _fmt(row))
                if geo == "smollm" and n_valid == 544 \
                        and dtype == torch.bfloat16:
                    served["decode_attention"] = dict(max_abs_err=err, **row)
    log(f"[kernels] dense attention tolerance: f32 1e-5; bf16 "
        f"{DENSE_BF16_TOL} (the kernels round scores and probabilities "
        f"where the plain version does, but the unnormalized probabilities "
        f"of an online softmax; outputs are bf16)")
    return served


def _quant_pools(k, v):
    """int8 pools and their f32 per-row scales from f32 pools, by the
    port's quantizer (the reference's arithmetic)."""
    from repro_torch.models.attention import quantize_kv
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    return kq, vq, ks, vs


def _quant_bound_ms(q, lengths, T, decode, heads):
    """Least time for the int8 kernels' work: q (f32) read and out (f32)
    written once; per visible row one int8 K and V row of KV x hd and
    their 2 x KV f32 scales, the page-table entries and lengths; the QK
    and PV operations (multiply and add) at the f32 peak: the reference
    dequantizes to f32 and computes in f32."""
    B, H, hd, KV = q.shape[0], heads["H"], heads["hd"], heads["KV"]
    vis = _visible_keys(lengths, T, decode)
    keys = vis.max(dim=1).values
    kv_bytes = int(keys.sum()) * KV * (2 * hd + 2 * 4)
    pages = int(((keys + BS - 1) // BS).sum()) * 4
    return _bound(kv_bytes + pages + 2 * q.numel() * 4 + B * 4,
                  4 * H * hd * int(vis.sum()), torch.float32)


def phase_quant_kernels(timer: Timer):
    """B3 (T = 1) and K2q (T = 32) at smollm heads over int8 pools made
    from _attn_case's f32 pools, f32 q; the library call is SDPA over the
    cache dequantized and gathered beforehand."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models.attention import dequantize_kv
    served = {}
    specs = [("paged_decode_attention_quant",
              dops.paged_decode_attention_quant,
              dops.paged_decode_attention_quant_plain, 1, True,
              dops.QUANT_KERNEL),
             ("paged_prefill_attention_quant",
              fops.paged_prefill_attention_quant,
              fops.paged_prefill_attention_quant_plain, 32, False,
              fops.QUANT_KERNEL)]
    f32 = torch.float32
    heads = SMOLLM_HEADS
    for name, kern, plain, T, decode, handle in specs:
        for B in (4, 8):
            q, k, v, pt, lengths = _attn_case(B * 7 + T + 1, B, T, f32, f32,
                                              heads)
            if decode:
                q = q[:, 0].contiguous()
            kq, vq, ks, vs = _quant_pools(k, v)
            args = (q, kq, vq, ks, vs, pt, lengths)
            n0 = handle.launches
            entry = None if decode else fops.quant_prefill_entry(heads["hd"])
            e0 = handle.entry_launches.get(entry, 0)
            out = kern(*args)
            torch.cuda.synchronize()
            check(handle.launches == n0 + 1, f"{name} did not launch")
            check(entry is None or handle.entry_launches[entry] == e0 + 1,
                  f"{name} did not launch {entry}")
            want = plain(*args)
            check(out.dtype == f32 and torch.isfinite(out).all().item(),
                  f"{name}: non-finite or non-f32 output")
            err = (out - want).abs().max().item()
            tol = TOL[f32]
            tag = (f"{name} smollm heads 15/5 hd 64 B={B} T={T} q=float32 "
                   f"kv=int8 (+f32 row scales)"
                   + ("" if entry is None else f" [{entry}]"))
            check(err <= tol, f"{tag}: max_abs_err {err} > {tol}")
            row = _time_row(
                timer, kern, plain, args,
                _attn_library_call(q, dequantize_kv(kq, ks),
                                   dequantize_kv(vq, vs), pt, lengths, T,
                                   decode, heads),
                _quant_bound_ms(q, lengths, T, decode, heads))
            log(f"[kernels] {tag}: max_abs_err={err:.3e} (tol {tol})"
                + _fmt(row))
            if B == 8:
                served[name] = dict(max_abs_err=err, **row)
    log("[kernels] int8 attention tolerance: 1e-5 (f32 outputs; the "
        "kernels dequantize each row with one f32 product, as the plain "
        "version does, and sum in another order)")
    return served


def phase_splits() -> None:
    """The split decode body at its split boundaries and the split-TF32
    prefill body at its edges, each against its plain version: K1 and B3
    with rows of 0, 1, one split's keys, one more and all P * bs keys in
    one batch (a row with no keys outputs 0), B4 at n_valid 1, one split,
    one more and the whole cache; two launches of each decode entry must
    give the same bits.  f32 K2 and K2q with a slot that has nothing
    cached, a chunk straddling a page and T = 5 and 17; f32 B2 with 16-
    and 128-token windows and S = 77."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    f32, bf16 = torch.float32, torch.bfloat16
    B = 8
    for geo, heads in (("smollm", SMOLLM_HEADS), ("jamba", JAMBA_HEADS)):
        KV = heads["KV"]
        n_split, split_keys = dops.split_plan(P * BS, B * KV)
        edge = torch.tensor([0, 1, split_keys, split_keys + 1, P * BS, 7,
                             300, 555], dtype=torch.int32, device="cuda")
        for qdt, kvdt in ((f32, f32), (f32, bf16), (bf16, bf16), ("q8", f32)):
            q, k, v, pt, _ = _attn_case(17 + KV, B, 1, f32 if qdt == "q8"
                                        else qdt, kvdt, heads)
            q = q[:, 0].contiguous()
            if qdt == "q8":
                kern, plain = (dops.paged_decode_attention_quant,
                               dops.paged_decode_attention_quant_plain)
                kq, vq, ks, vs = _quant_pools(k, v)
                args, tol, what = (q, kq, vq, ks, vs, pt, edge), TOL[f32], \
                    "paged_decode_attention_quant (B3) f32/int8"
            else:
                kern, plain = (dops.paged_decode_attention,
                               dops.paged_decode_attention_plain)
                args, tol, what = (q, k, v, pt, edge), TOL[kvdt], \
                    f"paged_decode_attention (K1) {str(qdt)[6:]}/{str(kvdt)[6:]}"
            out, again = kern(*args), kern(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            check(torch.equal(out, again), f"{what}: two launches differ")
            check(not out[0].any().item(), f"{what}: a row with no keys "
                  "is not 0")
            err = (out[1:].float() - want[1:].float()).abs().max().item()
            check(err <= tol, f"{what} {geo} split boundaries: max_abs_err "
                  f"{err} > {tol}")
            log(f"[splits] {what} {geo} B={B} lengths {edge.tolist()} "
                f"({n_split} splits of {split_keys}): max_abs_err={err:.3e} "
                f"(tol {tol}); bitwise repeatable; empty row 0")
        C = 584
        n_split, split_keys = dops.split_plan(C, B * KV)
        for dtype in (f32, bf16):
            tol = TOL[f32] if dtype == f32 \
                else DENSE_BF16_TOL["decode_attention"]
            errs = []
            for n_valid in (1, split_keys, split_keys + 1, C):
                q, k, v = _dense_qkv(n_valid + 3, B, 1, C, heads, dtype)
                q = q[:, 0].contiguous()
                out = dops.decode_attention(q, k, v, n_valid)
                again = dops.decode_attention(q, k, v, n_valid)
                want = dops.decode_attention_plain(q, k, v, n_valid)
                torch.cuda.synchronize()
                check(torch.equal(out, again),
                      f"decode_attention n_valid {n_valid}: launches differ")
                errs.append((out.float() - want.float()).abs().max().item())
                check(errs[-1] <= tol, f"decode_attention (B4) {geo} "
                      f"n_valid {n_valid}: max_abs_err {errs[-1]} > {tol}")
            log(f"[splits] decode_attention (B4) {geo} {str(dtype)[6:]} "
                f"n_valid 1/{split_keys}/{split_keys + 1}/{C} ({n_split} "
                f"splits of {split_keys} at C): max_abs_err "
                f"{max(errs):.3e} (tol {tol}); bitwise repeatable")
    # the split-TF32 prefill body at its edges
    for geo, heads in (("smollm", SMOLLM_HEADS), ("jamba", JAMBA_HEADS)):
        for T in (5, 17):
            for kvdt in (f32, bf16, "int8"):
                q, k, v, pt, lengths = _attn_case(
                    T + heads["hd"], 4, T, f32, f32 if kvdt == "int8"
                    else kvdt, heads)
                lengths[0], lengths[1] = 0, 2 * BS - 3
                if kvdt == "int8":
                    kq, vq, ks, vs = _quant_pools(k, v)
                    args = (q, kq, vq, ks, vs, pt, lengths)
                    kern, plain, handle, entry = (
                        fops.paged_prefill_attention_quant,
                        fops.paged_prefill_attention_quant_plain,
                        fops.QUANT_KERNEL,
                        fops.quant_prefill_entry(heads["hd"]))
                else:
                    args = (q, k, v, pt, lengths)
                    kern, plain, handle, entry = (
                        fops.paged_prefill_attention,
                        fops.paged_prefill_attention_plain, fops.KERNEL,
                        fops.paged_prefill_entry(f32, kvdt, heads["hd"]))
                e0 = handle.entry_launches[entry]
                out = kern(*args)
                want = plain(*args)
                torch.cuda.synchronize()
                check(entry.endswith("_tf32")
                      and handle.entry_launches[entry] == e0 + 1,
                      f"{entry} did not launch")
                err = (out.float() - want.float()).abs().max().item()
                tol = TOL[bf16 if kvdt == bf16 else f32]
                check(err <= tol, f"[{entry}] {geo} T={T}: max_abs_err "
                      f"{err} > {tol}")
                log(f"[splits] {entry} {geo} B=4 T={T} lengths "
                    f"{lengths.tolist()}: max_abs_err={err:.3e} (tol {tol})")
        for window in (16, 128):
            q, k, v = _dense_qkv(77 + window, 2, 77, 77, heads, f32)
            e0 = fops.FLASH_KERNEL.entry_launches["flash_attention_f32_tf32"]
            out = fops.flash_attention(q, k, v, causal=True,
                                       sliding_window=window)
            want = fops.flash_attention_plain(q, k, v, causal=True,
                                              sliding_window=window)
            torch.cuda.synchronize()
            check(fops.FLASH_KERNEL.entry_launches["flash_attention_f32_tf32"]
                  == e0 + 1, "flash_attention_f32_tf32 did not launch")
            err = (out - want).abs().max().item()
            check(err <= TOL[f32], f"flash_attention_f32_tf32 {geo} window "
                  f"{window}: max_abs_err {err}")
            log(f"[splits] flash_attention_f32_tf32 {geo} B=2 S=T=77 window "
                f"{window}: max_abs_err={err:.3e} (tol {TOL[f32]})")


def phase_transform(timer: Timer):
    """B7 at e4's pre-processing shape, (64, 224, 224, 3) uint8: the e4
    chain to f32 (scale 1/255, bias -0.5, clip +-0.5) and a uint8 ->
    uint8 affine that saturates; bit-exact against the plain version."""
    from repro_torch.kernels.transform import ops as tops
    g = torch.Generator(device="cpu").manual_seed(9)
    x = torch.randint(0, 256, (64, 224, 224, 3), generator=g,
                      dtype=torch.uint8).to("cuda")
    served = None
    for tag, kw in (
            ("uint8 -> float32, e4 chain (scale 1/255, bias -0.5, "
             "clip +-0.5)",
             dict(scale=1 / 255.0, bias=-0.5, lo=-0.5, hi=0.5,
                  out_dtype=torch.float32)),
            ("uint8 -> uint8 (scale 1.5, bias -20, saturating)",
             dict(scale=1.5, bias=-20.0, out_dtype=torch.uint8))):
        n0 = tops.KERNEL.launches
        out = tops.fused_transform(x, **kw)
        torch.cuda.synchronize()
        check(tops.KERNEL.launches == n0 + 1, "fused_transform did not launch")
        want = tops.fused_transform_plain(x, **kw)
        check(out.dtype == want.dtype and torch.equal(out, want),
              f"fused_transform {tag}: kernel and plain version differ")
        err = (out.float() - want.float()).abs().max().item()
        n = x.numel()
        row = _time_row(timer, lambda a: tops.fused_transform(a, **kw),
                        lambda a: tops.fused_transform_plain(a, **kw), (x,),
                        None, _bound(n * (1 + out.element_size()), 4 * n,
                                     torch.float32))
        log(f"[kernels] fused_transform (64, 224, 224, 3) {tag}: exact"
            + _fmt(row))
        if served is None:
            served = dict(max_abs_err=err, **row)
    log("[kernels] fused_transform tolerance: exact; no single PyTorch "
        "call computes it (library_ms null)")
    return served


# -- phase 4 --------------------------------------------------------------------

def phase_engine(kernels) -> None:
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    smollm2 = get_config("smollm-360m").replace(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    jamba = get_config("jamba-v0.1-52b", smoke=True)
    scan_gate = ("selective_scan", "gating_topk")
    cases = [
        ("paged 2-layer f32 smollm heads", smollm2, True, None,
         PAGED_KERNELS),
        ("paged 2-layer f32 smollm heads, int8 KV", smollm2, True, "int8",
         QUANT_KERNELS),
        ("paged jamba-v0.1 smoke (8 layers, 4 experts, f32)", jamba, True,
         None, PAGED_KERNELS + scan_gate),
        ("dense 2-layer f32 smollm heads", smollm2, False, None,
         DENSE_KERNELS),
        ("dense 2-layer f32 smollm heads, 48-token window (ring wraps)",
         smollm2.replace(sliding_window=48), False, None, DENSE_KERNELS),
        ("dense jamba-v0.1 smoke (8 layers, 4 experts, f32)", jamba, False,
         None, DENSE_KERNELS + scan_gate)]
    for tag, cfg, paged, kv_dtype, path in cases:
        kw = dict(batch_size=4, capacity=128, max_new_tokens=8, burst=4,
                  paged=paged, kv_dtype=kv_dtype)
        if paged:
            kw.update(prefill_chunk=32, block_size=16)
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in (37, 5, 70, 18, 33, 50)]
        cpu_model = build_model(cfg, device="cpu")
        cpu_params = cpu_model.init(seed=0)
        want = ServeEngine(cpu_model, cpu_params, device="cpu",
                           **kw).serve(prompts)
        gpu_model = build_model(cfg, device="cuda")
        gpu_params = bridge.to_torch(cpu_params, "cuda")
        reset(kernels)
        eng = ServeEngine(gpu_model, gpu_params, device="cuda", **kw)
        got = eng.serve(prompts)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in kernels}
        check(eng.n_step_failures == 0,
              f"{tag}: {eng.n_step_failures} failed steps")
        for a, b in zip(want, got):
            check(b.status == "ok", f"{tag} request {b.request_id}: {b.status}")
            check(np.array_equal(a.tokens, b.tokens),
                  f"{tag} request {a.request_id}: cpu {a.tokens} != "
                  f"cuda {b.tokens}")
        check(all(launches[n] > 0 for n in path),
              f"{tag}: engine run missed a kernel: {launches}")
        other = [n for n in ATTN_KERNELS if n not in path]
        check(all(launches[n] == 0 for n in other),
              f"{tag}: another path's attention kernels launched: "
              f"{launches}")
        if "selective_scan" in path:
            # the paged step and the dense decode run the slab entry; the
            # dense prefill wave the plain entry's cold start
            scan = next(k for k in kernels if k.name == "selective_scan")
            e = scan.entry_launches
            check(e["selective_scan_slab_f32"] > 0
                  and (e["selective_scan_f32"] > 0) != paged,
                  f"{tag}: selective_scan entries {e}")
            log(f"[engine] {tag}: selective_scan launches by entry "
                f"{ {n: c for n, c in e.items() if c} }")
        log(f"[engine] {tag}: {len(prompts)} requests, greedy tokens on "
            f"cuda == cpu ({sum(len(r.tokens) for r in got)} tokens); "
            f"launches {launches}")


# -- phase 5 --------------------------------------------------------------------

def phase_main_path(kernels):
    from repro_torch.launch import serve
    argv = ["--arch", "smollm-360m", "--kv-dtype", "bf16", "--requests", "16",
            "--batch", "8", "--prompt-len", "512", "--max-new", "64",
            "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    out = serve.main(argv)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    eng = out["engine"]
    check(out["n_results"] == 16 and out["total_tokens"] == 16 * 64,
          f"served {out['n_results']} requests / {out['total_tokens']} tokens")
    # (a short micro-batch is padded to its power-of-2 bucket with zero
    # rows, which the engine serves too)
    check(eng.n_evictions >= 16, f"{eng.n_evictions} requests finished")
    check(all(launches[n] > 0 for n in PAGED_KERNELS),
          f"main path missed a kernel: {launches}")
    check(all(launches[n] == 0 for n in DENSE_KERNELS + QUANT_KERNELS),
          f"the paged bf16 path launched another path's kernel: {launches}")
    check_served_by(kernels, "paged_prefill_attention",
                    "paged_prefill_attention_bf16_bf16_mma", "main")
    decoded = eng.n_device_steps
    log(f"[main] smollm-360m full width (32 layers, d 960, 15/5 heads, "
        f"vocab 49152, bf16): {out['total_tokens'] / out['wall_s']:.1f} tok/s "
        f"({out['total_tokens']} tokens in {out['wall_s']:.2f}s, pipeline)")
    per_tok = {n: round(c / out["total_tokens"], 3) for n, c in launches.items()}
    log(f"[main] launches {launches} ({per_tok} per served token) over "
        f"{decoded} device steps "
        f"({eng.n_prefill_chunks} mixed, {decoded - eng.n_prefill_chunks} "
        f"decode) x 32 layers; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, eng


def phase_trace(eng, tag: str, n: int = 8, prompt_len: int = 512):
    """Where the device time goes: the engine serves ``n`` more requests
    (``prompt_len``-token prompts, its max_new_tokens each, direct) under
    a CUDA-only profiler trace; device busy share = summed kernel time
    over the wall time of the serve (one stream: kernels do not
    overlap).  Returns (device-to-host copies per device step, {device
    operation: calls per device step})."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, eng.model.cfg.vocab_size,
                            prompt_len).astype(np.int32) for _ in range(n)]
    steps0, waves0 = eng.n_device_steps, eng.n_prefills
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = eng.serve(prompts, timeout_s=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(all(r.status == "ok" and len(r.tokens) == eng.max_new_tokens
              for r in res), f"[{tag}] traced serve failed")
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    check(busy_us > 0, "the profiler recorded no device time")
    steps = eng.n_device_steps - steps0
    waves = "" if eng.paged else \
        f" + {eng.n_prefills - waves0} prefill waves"
    log(f"[{tag}] trace: {n} x {prompt_len}-token prompts, "
        f"{eng.max_new_tokens} new tokens, direct: wall "
        f"{wall * 1e3:.1f} ms over {steps} device steps{waves} "
        f"({wall * 1e3 / steps:.2f} ms/step), device busy "
        f"{busy_us / 1e3:.1f} ms = {busy_us / 1e4 / wall:.1f}% "
        f"(idle {100 - busy_us / 1e4 / wall:.1f}%)")
    for key, us, cnt in rows[:10]:
        log(f"[{tag}]   {us / 1e3:9.2f} ms {cnt:7d} calls  {key[:90]}")
    # the hand-written kernels, wherever they rank
    for key, us, cnt in rows:
        if any(n in key for n in ("kern::", "selective_scan_kernel",
                                  "gating_topk_kernel")):
            log(f"[{tag}]   kernel {us / 1e3:9.2f} ms {cnt:7d} calls  "
                f"{key[:90]}")
    d2h = sum(cnt for key, _, cnt in rows if "DtoH" in key)
    log(f"[{tag}] device-to-host copies (host syncs): {d2h} = "
        f"{d2h / steps:.2f} per device step")
    ops = {key: cnt for key, _, cnt in rows if not RUNTIME_CALL.match(key)}
    n_ops = sum(ops.values())
    log(f"[{tag}] device operations (kernels, copies, fills): {n_ops} = "
        f"{n_ops / steps:.1f} per device step")
    return d2h / steps, {key: cnt / steps for key, cnt in ops.items()}


# -- phase 6 --------------------------------------------------------------------

JAMBA_PLEN, JAMBA_NEW = 512, 32


def jamba_engine(pkg: str = "repro_torch", params=None):
    """Phase 6's model and engine: jamba-v0.1 at full width, one period
    of its layer pattern, batch 8, prefill chunk 32, burst 8, one state
    slab per slot, from the port package importable as ``pkg``
    (kernel_ab.py builds another checkout's the same way).  ``params``:
    random bf16 weights made on the card from seed 0 when not given.
    Returns (engine, params)."""
    configs, models, serving = (importlib.import_module(f"{pkg}.{m}")
                                for m in ("configs", "models", "serving"))
    cfg = configs.get_config("jamba-v0.1-52b").replace(n_layers=8)
    model = models.build_model(cfg, device="cuda")
    if params is None:
        params = model.init(seed=0)
    eng = serving.ServeEngine(
        model, params, batch_size=8, capacity=JAMBA_PLEN + JAMBA_NEW,
        max_new_tokens=JAMBA_NEW, prefill_chunk=32, block_size=16, burst=8,
        kv_dtype="bf16", num_state_slots=8, device="cuda")
    return eng, params


def jamba_prompts(vocab_size: int):
    """Phase 6's 16 requests of ``JAMBA_PLEN`` prompt tokens."""
    rng = np.random.default_rng(6)
    return [rng.integers(0, vocab_size, JAMBA_PLEN).astype(np.int32)
            for _ in range(16)]


def phase_jamba(kernels):
    """jamba-v0.1 at full width, one period of its layer pattern (the
    whole 32-layer model, ~104 GB in bf16, does not fit one 80 GB card):
    16 requests of 512 prompt tokens, 32 new tokens each, batch 8,
    prefill chunk 32, burst 8, one state slab per slot."""
    t0 = time.perf_counter()
    eng, params = jamba_engine()
    torch.cuda.synchronize()
    model, max_new = eng.model, JAMBA_NEW
    cfg = model.cfg
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"[jamba] {cfg.arch_id} one period: 8 layers "
        f"{[d for d in model.period_descs]}, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, {cfg.moe.n_experts} experts "
        f"top-{cfg.moe.top_k}, d_expert {cfg.moe.d_expert}, vocab "
        f"{cfg.vocab_size}, bf16: {n_params / 1e9:.2f}B parameters made on "
        f"the card with the engine in {time.perf_counter() - t0:.1f}s")
    prompts = jamba_prompts(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    t0 = time.perf_counter()
    res = eng.serve(prompts, timeout_s=900)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    check(all(r.status == "ok" and len(r.tokens) == max_new for r in res),
          f"jamba: {[(r.status, len(r.tokens)) for r in res]}")
    check(all(int(r.tokens.min()) >= 0 and int(r.tokens.max()) < cfg.vocab_size
              for r in res), "jamba: token outside the vocab")
    check(all(launches[n] > 0 for n in PAGED_KERNELS
              + ("selective_scan", "gating_topk")),
          f"jamba path missed a kernel: {launches}")
    check(all(launches[n] == 0 for n in DENSE_KERNELS),
          f"the paged path launched a dense kernel: {launches}")
    check_served_by(kernels, "paged_prefill_attention",
                    "paged_prefill_attention_bf16_bf16_mma", "jamba")
    check_served_by(kernels, "selective_scan", "selective_scan_slab_bf16",
                    "jamba")
    total = sum(len(r.tokens) for r in res)
    steps, mixed = eng.n_device_steps, eng.n_prefill_chunks
    per_tok = {n: round(c / total, 3) for n, c in launches.items()}
    log(f"[jamba] served {len(res)}/16 requests ok, {total} tokens in "
        f"{wall:.2f}s = {total / wall:.1f} tok/s (direct); {steps} device "
        f"steps ({mixed} mixed, {steps - mixed} decode), "
        f"{wall * 1e3 / steps:.1f} ms/step")
    log(f"[jamba] launches {launches} ({per_tok} per served token); peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; slabs "
        f"{eng.pool_stats()['num_state_slots']}")
    return launches, eng


# -- phase 7 --------------------------------------------------------------------

def phase_dense(kernels):
    """smollm-360m at full width and depth on the dense engine, through
    the stream pipeline: bf16 cache, batch 8, 16 requests of up to 512
    prompt tokens (left-padded by the pipeline to the longest), 64 new
    tokens, burst 8; the launcher sizes the cache at prompt-len + max-new
    + 8 = 584 positions."""
    from repro_torch.launch import serve
    argv = ["--arch", "smollm-360m", "--kv-dtype", "bf16", "--paged", "off",
            "--requests", "16", "--batch", "8", "--prompt-len", "512",
            "--max-new", "64", "--burst", "8",
            "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    out = serve.main(argv)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    eng = out["engine"]
    check(not eng.paged and eng.capacity == 512 + 64 + 8,
          f"the dense phase ran paged={eng.paged}, capacity {eng.capacity}")
    check(out["n_results"] == 16 and out["total_tokens"] == 16 * 64,
          f"served {out['n_results']} requests / {out['total_tokens']} tokens")
    check(all(launches[n] > 0 for n in DENSE_KERNELS),
          f"dense path missed a kernel: {launches}")
    check(all(launches[n] == 0 for n in PAGED_KERNELS),
          f"the dense path launched a paged kernel: {launches}")
    check_served_by(kernels, "flash_attention", "flash_attention_bf16_mma",
                    "dense")
    check(eng.n_step_failures == 0 and eng.n_restarts == 0,
          f"dense: {eng.n_step_failures} failed steps, {eng.n_restarts} "
          "restarts")
    ls = eng.loop_stats()
    cache_mb = sum(a.numel() * a.element_size()
                   for a in _leaves(eng._cache)) / 1e6
    log(f"[dense] smollm-360m full width (32 layers, d 960, 15/5 heads, "
        f"vocab 49152, bf16), dense engine: "
        f"{out['total_tokens'] / out['wall_s']:.1f} tok/s "
        f"({out['total_tokens']} tokens in {out['wall_s']:.2f}s, pipeline)")
    per_tok = {n: round(c / out["total_tokens"], 3) for n, c in launches.items()}
    log(f"[dense] {ls['n_device_steps']} device steps, {eng.n_prefills} "
        f"prefill waves, {eng.n_joins} joins, {ls['n_bursts']} bursts, "
        f"{ls['n_host_syncs']} host syncs (token drains) + "
        f"{ls['n_flag_reads']} blocking reads of the active flags, "
        f"{ls['n_state_uploads']} state uploads; dense cache "
        f"{eng.capacity} positions, {cache_mb:.1f} MB; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[dense] launches {launches} ({per_tok} per served token)")
    return launches, eng


# -- phase 8 --------------------------------------------------------------------

def phase_int8(kernels):
    """smollm-360m at full width and depth with f32 weights (a bf16 model
    cannot serve over an int8 pool, in the reference either) serving
    phase 5's requests through the pipeline over an int8 pool, then over
    an f32 pool for the token agreement and the bytes per block."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    cfg = get_config("smollm-360m").replace(param_dtype="float32",
                                            compute_dtype="float32")
    model = build_model(cfg, device="cuda")
    params = model.init(seed=0)
    requests = serve.make_requests(cfg.vocab_size, 16, 512)
    kw = dict(batch_size=8, capacity=512 + 64 + 8, max_new_tokens=64,
              prefill_chunk=32, block_size=16, burst=8, device="cuda")
    tokens, engines = {}, {}
    for kv_dtype in ("int8", "f32"):
        eng = ServeEngine(model, params, kv_dtype=kv_dtype, **kw)
        torch.cuda.reset_peak_memory_stats()
        reset(kernels)
        t0 = time.perf_counter()
        out = serve.serve_pipeline(eng, requests, batch=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        total = sum(np.asarray(b.data).size for b in out)
        check(len(out) == 16 and total == 16 * 64,
              f"int8 phase ({kv_dtype}): {len(out)} results, {total} tokens")
        tokens[kv_dtype] = {b.meta["request"]: np.asarray(b.data)
                            for b in out}
        engines[kv_dtype] = eng
        path = QUANT_KERNELS if kv_dtype == "int8" else PAGED_KERNELS
        check(all(launches[n] > 0 for n in path),
              f"{kv_dtype} pool: path missed a kernel: {launches}")
        check(all(launches[n] == 0 for n in ATTN_KERNELS if n not in path),
              f"{kv_dtype} pool: another path's kernel launched: {launches}")
        if kv_dtype == "f32":
            check_served_by(kernels, "paged_prefill_attention",
                            "paged_prefill_attention_f32_f32_tf32", "int8")
        else:
            check_served_by(kernels, "paged_prefill_attention_quant",
                            "paged_prefill_attention_quant_f32_tf32", "int8")
        ls, ps = eng.loop_stats(), eng.pool_stats()
        per_tok = {n: round(c / total, 3) for n, c in launches.items()}
        log(f"[int8] smollm-360m full width (32 layers, d 960, 15/5 heads, "
            f"vocab 49152, f32 weights), {ps['kv_dtype']} pool: "
            f"{total / wall:.1f} tok/s ({total} tokens in {wall:.2f}s, "
            f"pipeline); {ls['n_device_steps']} device steps "
            f"({eng.n_prefill_chunks} mixed), {ls['n_host_syncs']} host "
            f"syncs + {ls['n_flag_reads']} flag reads; "
            f"{ps['bytes_per_block']} bytes/block, "
            f"{ps['pool_bytes'] / 1e6:.1f} MB pool; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"[int8] launches {launches} ({per_tok} per served token)")
        if kv_dtype == "int8":
            launches8 = launches
    agree = sum(int((tokens["int8"][i] == tokens["f32"][i]).sum())
                for i in range(16))
    first = sum(int(tokens["int8"][i][0] == tokens["f32"][i][0])
                for i in range(16))
    log(f"[int8] greedy tokens equal to the f32 pool's: {agree}/{16 * 64} "
        f"({100 * agree / (16 * 64):.1f}%); first tokens {first}/16 "
        f"(logged, not gated: int8 KV is a bounded drift, not identity)")
    b8 = engines["int8"].kv_bytes_per_block()
    b32 = engines["f32"].kv_bytes_per_block()
    hd = cfg.resolved_head_dim
    check(b32 * (2 * hd + 2 * 4) == b8 * (2 * hd * 4),
          f"bytes per block f32/int8 = {b32}/{b8}, not 512/136")
    log(f"[int8] bytes per block f32/int8 = {b32}/{b8} = {b32 / b8:.4f} "
        f"(= 512/136: 2 x 64 x 4 bytes against 2 x 64 + 2 x 4)")
    del engines["f32"]
    return launches8, engines["int8"]


# -- phase 9 --------------------------------------------------------------------

def phase_preproc(kernels):
    """The e4 pre-processing chain on B7 through the port's parser: one
    frame at a time, then 64 frames stacked by tensor_aggregator."""
    from repro_torch.core import parse_pipeline
    from repro_torch.core.elements.sources import VideoTestSrc
    from repro_torch.core.elements.transform import (apply_chain_numpy,
                                                     parse_chain)
    from repro_torch.kernels.transform import ops as tops
    chain = parse_chain(E4_CHAIN)
    src = VideoTestSrc("ref")
    frames = {}

    def frame(i):
        if i not in frames:
            frames[i] = src.create(i).data
        return frames[i]

    launches = 0
    for tag, n_frames, batch in (("per frame", 64, 0), ("batched", 128, 64)):
        agg = (f"tensor_aggregator frames_in={batch} stack=true ! "
               if batch else "")
        pipe = parse_pipeline(
            f"videotestsrc num_buffers={n_frames} ! tensor_converter ! {agg}"
            f"tensor_transform option={E4_CHAIN} backend=fused ! "
            "tensor_sink name=out keep=true")
        reset(kernels)
        t0 = time.perf_counter()
        pipe.start()
        try:
            check(pipe["out"].eos_seen.wait(timeout=300),
                  f"preproc {tag}: pipeline did not drain")
            pipe.check_bus()
        finally:
            pipe.stop()
        wall = time.perf_counter() - t0
        outs = [np.asarray(b.data) for b in pipe["out"].buffers]
        n_out = n_frames // batch if batch else n_frames
        check(len(outs) == n_out, f"preproc {tag}: {len(outs)} outputs")
        err = 0.0
        for j, out in enumerate(outs):
            idx = range(j * batch, (j + 1) * batch) if batch else [j]
            want = (np.stack([frame(i) for i in idx]) if batch
                    else frame(j))
            want = apply_chain_numpy(want, chain)
            check(out.shape == want.shape and out.dtype == np.float32,
                  f"preproc {tag}: {out.shape} {out.dtype}")
            err = max(err, float(np.abs(out - want).max()))
        check(err <= 1e-6, f"preproc {tag}: max_abs_err {err} > 1e-6")
        launches += tops.KERNEL.launches
        check(tops.KERNEL.launches == n_out,
              f"preproc {tag}: B7 launched {tops.KERNEL.launches} times")
        log(f"[preproc] {tag}: {n_frames} frames of 224x224x3 uint8 -> "
            f"{outs[0].shape} f32 through the parsed pipeline in "
            f"{wall:.3f}s = {n_frames / wall:.1f} frames/s; max_abs_err "
            f"vs the numpy chain {err:.3e} (tol 1e-6); B7 launches "
            f"{tops.KERNEL.launches}")
    # what one batch costs the element: upload, kernel, download
    x = np.stack([frame(i) for i in range(64)])
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xd = torch.from_numpy(x).to("cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    # the spin keeps the start event behind the enqueued launch, so the
    # interval holds device time only (as Timer does)
    torch.cuda._sleep(Timer.SPIN_CYCLES)
    events[0].record()
    y = tops.fused_transform(xd, scale=1 / 255.0, bias=-0.5, lo=-0.5,
                             hi=0.5, out_dtype=torch.float32)
    events[1].record()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    y.cpu().numpy()
    t3 = time.perf_counter()
    log(f"[preproc] one (64, 224, 224, 3) batch: host-to-device copy "
        f"{(t1 - t0) * 1e3:.3f} ms (9.6 MB), B7 "
        f"{events[0].elapsed_time(events[1]):.4f} ms on the device, "
        f"device-to-host copy {(t3 - t2) * 1e3:.3f} ms (38.5 MB)")
    return launches


# -- phase 10 -------------------------------------------------------------------

FRONT_PLEN, FRONT_NEW = 512, 64
FAULT_STEP_A = 6        # phase 10(a): the engine_step fault's arrival
FAULT_STEP_B = 20       # phase 10(b): 16 mixed steps of prefill, then bursts


def serve_scheduled(eng, prompts, decode_rid: int, prefill_rid: int):
    """Serve ``prompts`` on the batch lane through ``eng.step()``,
    preempting ``prefill_rid`` while it is still mid-prefill and
    ``decode_rid`` once it holds two tokens; the schedule depends on the
    step count alone, so the card and the CPU run the same one.  Returns
    the results in request order."""
    rids = [eng.submit(p, lane="batch") for p in prompts]
    todo = {decode_rid, prefill_rid}
    for _ in range(10000):
        if not eng.has_work:
            break
        for s in list(eng._slots):
            if s is None or s.rid not in todo:
                continue
            prefilled = s.prefill_off >= len(s.prompt)
            if (s.rid == prefill_rid and not prefilled) or (
                    s.rid == decode_rid and prefilled and len(s.tokens) >= 2):
                check(eng.preempt(s.rid), f"preempt {s.rid} refused")
                todo.discard(s.rid)
        eng.step()
    check(not eng.has_work and not todo,
          f"scheduled serve: work left {eng.has_work}, not preempted {todo}")
    return eng.wait(rids, timeout_s=60)


def phase_front_door_small(kernels) -> None:
    """Phase 10(a): preemption, restore and a paged restart at phase 4's
    size, on the card against the CPU port under the same schedule."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import Fault, FaultPlan, ServeEngine
    smollm2 = get_config("smollm-360m").replace(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    jamba = get_config("jamba-v0.1-52b", smoke=True)
    scan_gate = ("selective_scan", "gating_topk")
    cases = [("2-layer f32 smollm heads", smollm2, None, PAGED_KERNELS),
             ("2-layer f32 smollm heads, int8 KV", smollm2, "int8",
              QUANT_KERNELS),
             ("jamba-v0.1 smoke (8 layers, 4 experts, f32)", jamba, None,
              PAGED_KERNELS + scan_gate)]
    kw = dict(batch_size=4, capacity=128, max_new_tokens=8, burst=4,
              prefill_chunk=32, block_size=16)
    for tag, cfg, kv_dtype, path in cases:
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in (37, 5, 70, 18, 33, 50)]
        cpu_model = build_model(cfg, device="cpu")
        cpu_params = cpu_model.init(seed=0)

        def plan():
            return FaultPlan([Fault(point="engine_step", nth=FAULT_STEP_A)])
        want = serve_scheduled(
            ServeEngine(cpu_model, cpu_params, device="cpu",
                        kv_dtype=kv_dtype, fault_plan=plan(), **kw),
            prompts, decode_rid=0, prefill_rid=2)
        gpu_model = build_model(cfg, device="cuda")
        gpu_params = bridge.to_torch(cpu_params, "cuda")
        plain = ServeEngine(gpu_model, gpu_params, device="cuda",
                            kv_dtype=kv_dtype, **kw).serve(prompts,
                                                           lane="batch")
        reset(kernels)
        eng = ServeEngine(gpu_model, gpu_params, device="cuda",
                          kv_dtype=kv_dtype, fault_plan=plan(), **kw)
        got = serve_scheduled(eng, prompts, decode_rid=0, prefill_rid=2)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in kernels}
        for a, b, c in zip(want, got, plain):
            check(a.status == b.status == c.status == "ok",
                  f"[front] {tag} request {b.request_id}: {a.status} "
                  f"{b.status} {c.status}")
            check(np.array_equal(a.tokens, b.tokens),
                  f"[front] {tag} request {a.request_id}: cpu {a.tokens} "
                  f"!= cuda {b.tokens} under the schedule")
            check(np.array_equal(b.tokens, c.tokens),
                  f"[front] {tag} request {b.request_id}: preempted "
                  f"{b.tokens} != plain {c.tokens}")
        check(eng.n_restarts == 1 and eng.n_preemptions >= 2
              and eng.n_restores >= 1,
              f"[front] {tag}: restarts {eng.n_restarts}, preemptions "
              f"{eng.n_preemptions}, restores {eng.n_restores}")
        ps = eng.pool_stats()
        check(ps["n_live"] == ps["n_reserved"] == 0
              and ps.get("n_state_live", 0) == 0, f"[front] {tag}: {ps}")
        check(all(launches[n] > 0 for n in path),
              f"[front] {tag}: the run missed a kernel: {launches}")
        check(all(launches[n] == 0 for n in ATTN_KERNELS if n not in path),
              f"[front] {tag}: another path's kernel launched: {launches}")
        if "selective_scan" in path:
            e = next(k for k in kernels
                     if k.name == "selective_scan").entry_launches
            check(e["selective_scan_slab_f32"] > 0
                  and e["selective_scan_f32"] == 0,
                  f"[front] {tag}: selective_scan entries {e}")
        log(f"[front] {tag}: {len(prompts)} batch-lane requests, "
            f"{eng.n_preemptions} preemptions ({eng.n_restores} restored), "
            f"{eng.n_restarts} restart; tokens on cuda == cpu under the "
            f"schedule == cuda without it; launches "
            f"{ {n: c for n, c in launches.items() if c} }")


def _percentiles(xs):
    return (f"p50 {np.percentile(xs, 50) * 1e3:.1f} ms, "
            f"p99 {np.percentile(xs, 99) * 1e3:.1f} ms")


def phase_front_door(kernels, card: str) -> None:
    """Phase 10(b): smollm-360m at full width behind the tensor-query
    server, with interactive requests preempting batch-lane slots; then
    a paged restart mid-decode on a second engine, and a full-width spill
    round trip."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import (Fault, FaultPlan, ServeEngine,
                                     TensorQueryClient, TensorQueryServer)
    cfg = get_config("smollm-360m")
    model = build_model(cfg, device="cuda")
    params = model.init(seed=0)
    kw = dict(batch_size=8, capacity=FRONT_PLEN + FRONT_NEW + 8,
              max_new_tokens=FRONT_NEW, prefill_chunk=32, block_size=16,
              burst=8, kv_dtype="bf16", device="cuda")
    rng = np.random.default_rng(10)
    batch = [rng.integers(0, cfg.vocab_size, FRONT_PLEN).astype(np.int32)
             for _ in range(8)]
    inter = [rng.integers(0, cfg.vocab_size,
                          int(rng.integers(128, FRONT_PLEN + 1)))
             .astype(np.int32) for _ in range(8)]
    eng = ServeEngine(model, params, **kw)
    srv = TensorQueryServer(eng, port=0, max_wait_ms=5.0,
                            pad_to=FRONT_PLEN).start()
    # what earlier phases left allocated (reference cycles freed first)
    # counts in the peak too: log it beside the peak
    gc.collect()
    base = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    t0 = time.perf_counter()
    try:
        cli = TensorQueryClient("127.0.0.1", srv.port)
        try:
            bq = [cli.submit(p, lane="batch") for p in batch]
            deadline = time.monotonic() + 300
            while not all(cli._requests[q].stream for q in bq):
                check(time.monotonic() < deadline,
                      "[front] the batch-lane requests never streamed")
                time.sleep(0.005)
            iq = [cli.submit(p, lane="interactive") for p in inter]
            results = [cli.result(q, timeout=600) for q in bq + iq]
        finally:
            cli.close()
        wall = time.perf_counter() - t0
        drained = srv.drain(timeout=60)
    finally:
        srv.stop()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(r.status == "ok" and len(r.tokens) == FRONT_NEW
              for r in results),
          f"[front] {[(r.lane, r.status, len(r.tokens)) for r in results]}")
    check(eng.n_preemptions >= 1 and eng.n_restores == eng.n_preemptions,
          f"[front] preemptions {eng.n_preemptions}, restores "
          f"{eng.n_restores}")
    ps = eng.pool_stats()
    check(drained and ps["n_live"] == ps["n_reserved"] == 0,
          f"[front] drained {drained}, pool {ps}")
    check(all(launches[n] > 0 for n in PAGED_KERNELS),
          f"[front] the served path missed a kernel: {launches}")
    check_served_by(kernels, "paged_prefill_attention",
                    "paged_prefill_attention_bf16_bf16_mma", "front")
    total = sum(len(r.tokens) for r in results)
    ttft = {lane: [r.ttft_s for r in results if r.lane == lane]
            for lane in ("batch", "interactive")}
    log(f"[front] smollm-360m full width (32 layers, bf16, bf16 pool) "
        f"behind TensorQueryServer on 127.0.0.1: 8 batch + 8 interactive "
        f"requests, {total} tokens in {wall:.2f}s = {total / wall:.1f} "
        f"tok/s; TTFT batch {_percentiles(ttft['batch'])}, interactive "
        f"{_percentiles(ttft['interactive'])}; preemptions "
        f"{eng.n_preemptions}, restores {eng.n_restores}, restarts "
        f"{eng.n_restarts}; engine requests {eng.n_requests} (bucket "
        f"padding rows included); peak memory {peak:.2f} GiB "
        f"({base:.2f} GiB allocated when the phase began); {card}")
    log(f"[front] launches {launches}")
    # the same prompts direct, no server, no preemption
    direct = eng.serve(batch + inter, timeout_s=600)
    same = sum(int((a.tokens == b.tokens).sum())
               for a, b in zip(direct, results))
    log(f"[front] tokens equal to a direct run without the server: "
        f"{same}/{16 * FRONT_NEW} (logged, not gated: bf16 at full width "
        f"need not be batch-invariant)")
    n = eng.allocator.blocks_for(FRONT_PLEN + FRONT_NEW)
    top = eng.allocator.num_blocks
    with torch.inference_mode():
        src = torch.arange(n, device="cuda")
        dst = torch.arange(top - n, top, device="cuda")
        first = model.gather_paged_pages(eng._paged_cache, src, 0)
        model.scatter_paged_pages(eng._paged_cache, first, dst, 0)
        again = model.gather_paged_pages(eng._paged_cache, dst, 0)
        check(all(torch.equal(a, b)
                  for a, b in zip(_leaves(first), _leaves(again))),
              "[front] full-width gather -> scatter -> gather differs")
    mb = sum(a.numel() * a.element_size() for a in _leaves(first)) / 1e6
    log(f"[front] full-width spill round trip: {n} blocks x 32 layers "
        f"(K and V, {mb:.1f} MB) gathered, scattered to other blocks, "
        "gathered again: bit-exact")
    del eng, direct
    feng = ServeEngine(model, params,
                       fault_plan=FaultPlan([Fault(point="engine_step",
                                                   nth=FAULT_STEP_B)]),
                       **kw)
    t0 = time.perf_counter()
    fres = feng.serve(batch, timeout_s=600)
    wall = time.perf_counter() - t0
    check(all(r.status == "ok" and len(r.tokens) == FRONT_NEW
              for r in fres),
          f"[front] fault run {[(r.status, len(r.tokens)) for r in fres]}")
    ps = feng.pool_stats()
    check(feng.n_restarts == 1 and feng.n_step_failures == 1
          and ps["n_live"] == ps["n_reserved"] == 0,
          f"[front] fault run: restarts {feng.n_restarts}, pool {ps}")
    same = sum(int((a.tokens == b.tokens).sum())
               for a, b in zip(fres, results[:8]))
    log(f"[front] engine_step fault at step {FAULT_STEP_B} (mid-decode): "
        f"1 restart, {feng.n_preemptions} slots spilled and "
        f"{feng.n_restores} restored, 8/8 ok in {wall:.2f}s; tokens equal "
        f"to the server run's batch lane: {same}/{8 * FRONT_NEW} (logged)")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.moe_gating import ops as gops
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.transform import ops as tops
    kernels = [dops.KERNEL, fops.KERNEL, sops.KERNEL, gops.KERNEL,
               fops.FLASH_KERNEL, dops.DENSE_KERNEL, dops.QUANT_KERNEL,
               fops.QUANT_KERNEL, tops.KERNEL]
    t_start = time.perf_counter()
    card = phase_device()
    phase_build(kernels)
    timer = Timer()
    served = phase_attention(timer)
    floor_ms = phase_floor(timer)
    served["selective_scan"] = phase_scan(timer, floor_ms)
    served["gating_topk"] = phase_gating(timer, floor_ms)
    served.update(phase_dense_kernels(timer))
    served.update(phase_quant_kernels(timer))
    phase_splits()
    served["fused_transform"] = phase_transform(timer)
    del timer
    phase_engine(kernels)
    launches5, eng = phase_main_path(kernels)
    d2h, _ = phase_trace(eng, "main")
    # the split decode reads no device tensor on the host: 2.22 copies per
    # step before and after it (a read per decode call would add 32)
    check(d2h < 2.5, f"[main] {d2h:.3f} device-to-host copies per step")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    launches6, eng = phase_jamba(kernels)
    phase_trace(eng, "jamba", n=8, prompt_len=512)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    launches7, eng = phase_dense(kernels)
    phase_trace(eng, "dense", n=8, prompt_len=512)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    launches8, eng = phase_int8(kernels)
    phase_trace(eng, "int8", n=8, prompt_len=512)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    launches9 = phase_preproc(kernels)
    gc.collect()
    torch.cuda.empty_cache()
    phase_front_door_small(kernels)
    phase_front_door(kernels, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches = {"paged_decode_attention": launches5["paged_decode_attention"],
                "paged_prefill_attention": launches5["paged_prefill_attention"],
                "selective_scan": launches6["selective_scan"],
                "gating_topk": launches6["gating_topk"],
                "flash_attention": launches7["flash_attention"],
                "decode_attention": launches7["decode_attention"],
                "fused_transform": launches9}
    launches.update({n: launches8[n] for n in QUANT_KERNELS})
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")
    rows = [dict(name=k.name, route="cuda",
                 source=str(k.source.relative_to(ROOT)),
                 replaces=REPLACES[k.name], launches=launches[k.name],
                 **served[k.name]) for k in kernels]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
