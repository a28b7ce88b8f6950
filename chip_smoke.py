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
                 selective scan (B5) at batch 8, d_inner 8192, d_state 16,
                 T = 1 and 32, cold and with carried state and t_valid; the
                 top-k gating (B6) at 8 and 256 tokens x 16 experts, top-2,
                 and a tie-laden case; the dense engine's contiguous flash
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
                 B4, B5, B6); the paged kernels must not launch there.
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
                 and the dense ones must not.
                 Then a profiler trace of the same engine.
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
Two lines before the last is a JSON object with one entry per kernel
(K1/K2 launches from phase 5, B5/B6 from phase 6, B2-contiguous/B4 from
phase 7, B3/K2q from phase 8, B7 from phase 9); then the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``.  The
whole run takes ~4-6 minutes on one H100, the build included.
"""
from __future__ import annotations

import gc
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


def _scan_case(seed, B, T, di, N, dtype, carried):
    """Selective-scan inputs as a Mamba layer makes them: dt from a
    softplus, A = -(1..N) per channel (the init's A_log), D = 1; with
    ``carried``, a random state slab and t_valid spread over [0, T]."""
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
    return tuple(a.to("cuda", dtype) for a in (dt, xs, Bc, Cc)) + tuple(
        a.contiguous().to("cuda") for a in (A, D, h0, t_valid))


def _scan_bound_ms(args, carried: bool):
    """Bytes: every input read once (h0 only when a state is carried),
    y and h_last written once; operations: per valid position, channel
    and state element the exp, the dt*A and dt*x*B products, the state
    update and the C dot product (~7 f32 operations), plus D*x."""
    dt, xs, Bc, Cc, A, D, h0, t_valid = args
    B, T, di = dt.shape
    N = Bc.shape[-1]
    ins = [dt, xs, Bc, Cc, A, D, t_valid] + ([h0] if carried else [])
    n_bytes = sum(a.numel() * a.element_size() for a in ins) \
        + (B * T * di + B * di * N) * 4
    positions = int(t_valid.clamp(max=T).sum())
    return _bound(n_bytes, positions * di * (7 * N + 3), torch.float32)


def phase_scan(timer: Timer):
    from repro_torch.kernels.ssm_scan import ops as sops
    served = None
    for T in (1, 32):
        for carried in (False, True):
            for dtype in (torch.bfloat16, torch.float32):
                if dtype == torch.float32 and not (carried and T == 32):
                    continue
                args = _scan_case(T + carried, 8, T, 8192, 16, dtype, carried)
                n0 = sops.KERNEL.launches
                y, h = sops.selective_scan(*args)
                torch.cuda.synchronize()
                check(sops.KERNEL.launches == n0 + 1,
                      "selective_scan did not launch")
                wy, wh = sops.selective_scan_plain(*args)
                check(bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
                      "selective_scan: non-finite output")
                err = max((y - wy).abs().max().item(),
                          (h - wh).abs().max().item())
                tag = (f"selective_scan B=8 T={T} di=8192 N=16 "
                       f"{str(dtype)[6:]} "
                       + ("carried h0 + t_valid" if carried else "cold"))
                check(err <= SCAN_TOL, f"{tag}: max_abs_err {err}")
                line = f"[kernels] {tag}: max_abs_err={err:.3e} (tol {SCAN_TOL})"
                if dtype == torch.bfloat16:
                    row = _time_row(timer, sops.selective_scan,
                                    sops.selective_scan_plain, args, None,
                                    _scan_bound_ms(args, carried))
                    line += _fmt(row)
                    if T == 32 and carried:
                        served = dict(max_abs_err=err, **row)
                log(line)
    log(f"[kernels] scan tolerance: {SCAN_TOL}; {SCAN_TOL_REASON}")
    return served


def phase_gating(timer: Timer):
    from repro_torch.kernels.moe_gating import ops as gops
    served = None
    E, k = 16, 2
    for T, tied in ((8, False), (256, False), (256, True)):
        g = torch.Generator(device="cpu").manual_seed(T + tied)
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
        log(f"[kernels] {tag}: exact (values and indices)" + _fmt(row))
        if T == 256 and not tied:
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


def phase_trace(eng, tag: str, n: int = 8, prompt_len: int = 512) -> float:
    """Where the device time goes: the engine serves ``n`` more requests
    (``prompt_len``-token prompts, its max_new_tokens each, direct) under
    a CUDA-only profiler trace; device busy share = summed kernel time
    over the wall time of the serve (one stream: kernels do not
    overlap)."""
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
        if "kern::" in key:
            log(f"[{tag}]   kernel {us / 1e3:9.2f} ms {cnt:7d} calls  "
                f"{key[:90]}")
    d2h = sum(cnt for key, _, cnt in rows if "DtoH" in key)
    log(f"[{tag}] device-to-host copies (host syncs): {d2h} = "
        f"{d2h / steps:.2f} per device step")
    return d2h / steps


# -- phase 6 --------------------------------------------------------------------

def phase_jamba(kernels):
    """jamba-v0.1 at full width, one period of its layer pattern (the
    whole 32-layer model, ~104 GB in bf16, does not fit one 80 GB card):
    16 requests of 512 prompt tokens, 32 new tokens each, batch 8,
    prefill chunk 32, burst 8, one state slab per slot."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    cfg = get_config("jamba-v0.1-52b").replace(n_layers=8)
    model = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"[jamba] {cfg.arch_id} one period: 8 layers "
        f"{[d for d in model.period_descs]}, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, {cfg.moe.n_experts} experts "
        f"top-{cfg.moe.top_k}, d_expert {cfg.moe.d_expert}, vocab "
        f"{cfg.vocab_size}, bf16: {n_params / 1e9:.2f}B parameters made on "
        f"the card in {time.perf_counter() - t0:.1f}s")
    max_new, plen = 32, 512
    eng = ServeEngine(model, params, batch_size=8, capacity=plen + max_new,
                      max_new_tokens=max_new, prefill_chunk=32, block_size=16,
                      burst=8, kv_dtype="bf16", num_state_slots=8,
                      device="cuda")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
               for _ in range(16)]
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
    served["selective_scan"] = phase_scan(timer)
    served["gating_topk"] = phase_gating(timer)
    served.update(phase_dense_kernels(timer))
    served.update(phase_quant_kernels(timer))
    phase_splits()
    served["fused_transform"] = phase_transform(timer)
    del timer
    phase_engine(kernels)
    launches5, eng = phase_main_path(kernels)
    d2h = phase_trace(eng, "main")
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
