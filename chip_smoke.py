"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without its
result line):
  1. device    — the card's name and power limit; TF32 off.
  2. build     — compile the hand-written CUDA kernels (one nvcc each, in
                 parallel) from the sources in this checkout.
  3. kernels   — each kernel against its plain PyTorch version at the
                 served shapes (smollm-360m heads, block 16, batch 4 and
                 8, lengths up to ~600), with its time beside the plain
                 version's, one library call's, and its bound.
  4. engine    — a 2-layer f32 model at smollm-360m's head geometry serves
                 the same prompts on the GPU (through the kernels) and on
                 the CPU (plain path): the greedy tokens must be equal.
  5. main path — ``repro_torch.launch.serve`` serves smollm-360m at full
                 width (random weights from seed 0, bf16 KV) through the
                 stream pipeline; both kernels must have launched.  Then
                 a profiler trace of the same engine: device busy share
                 and the kernels that take the device time.
The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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
HEADS = dict(H=15, KV=5, hd=64)    # smollm-360m: 15 query, 5 KV heads
BS, P, MAX_LEN = 16, 40, 600       # block size, pages per slot, lengths


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


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
        report = [ln.strip() for ln in p.with_suffix(".log").read_text()
                  .splitlines() if "registers" in ln or "spill" in ln]
        log(f"[build] {k.name}: {p.relative_to(ROOT)}; "
            + " | ".join(report[:6]))


# -- phase 3 --------------------------------------------------------------------

def _case(seed, B, T, qdt, kvdt, dev):
    """Served-shape inputs: shuffled page tables over a pool with spare
    blocks, cached lengths spread from one page up to MAX_LEN."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    H, KV, hd = HEADS["H"], HEADS["KV"], HEADS["hd"]
    nb = B * P + 7
    q = torch.randn((B, T, H, hd), generator=g).to(dev, qdt)
    k = torch.randn((nb, BS, KV, hd), generator=g).to(dev, kvdt)
    v = torch.randn((nb, BS, KV, hd), generator=g).to(dev, kvdt)
    pt = torch.stack([torch.randperm(nb, generator=g)[:P]
                      for _ in range(B)]).to(dev, torch.int32)
    # at least one page per slot: a slot with two or three keys outputs
    # nearly one V row, where one bf16 ulp of |v| ~ 4 exceeds the tolerance
    lengths = torch.linspace(BS, MAX_LEN - T, B).round().to(torch.int32)
    lengths = lengths[torch.randperm(B, generator=g)].to(dev)
    return q, k, v, pt, lengths


class Timer:
    """Mean device time of ``fn`` over ``iters`` launches, each on a cold
    L2 (a 64 MB buffer is rewritten before every launch: in serving, the
    31 other layers' K/V pass through the 50 MB L2 between two calls for
    the same layer).  Before each launch the GPU spins for ~1 ms, so the
    host has enqueued the whole launch before the start event runs and
    the interval holds device time only, not the wrapper's Python."""

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


def _visible_keys(lengths, T, decode: bool):
    """(B, T) keys each query row attends to, from this run's data."""
    cap = P * BS
    if decode:                            # lengths = valid keys
        return lengths.clamp(max=cap)[:, None]
    t = torch.arange(T, device=lengths.device)[None, :]
    return (lengths[:, None] + t + 1).clamp(max=cap)


def _bound_ms(q, k, lengths, T, decode):
    """Least time for the same work: the larger of the bytes it must move
    (q, the K/V rows of the keys this data makes visible, the page-table
    entries they sit in, lengths, out) over HBM bandwidth and its
    operations (QK and PV, multiply and add) over the peak rate for the
    K/V type."""
    B, H, hd = q.shape[0], HEADS["H"], HEADS["hd"]
    KV = HEADS["KV"]
    vis = _visible_keys(lengths, T, decode)
    keys = vis.max(dim=1).values                      # rows read per slot
    kv_bytes = int(keys.sum()) * KV * hd * k.element_size() * 2
    pages = int(((keys + BS - 1) // BS).sum()) * 4
    qo_bytes = q.numel() * (q.element_size() + k.element_size())
    n_bytes = kv_bytes + pages + qo_bytes + B * 4
    ops = 4 * H * hd * int(vis.sum())
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[k.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _library_call(q, k, v, pt, lengths, T, decode):
    """One PyTorch call computing the same function (timed only as a
    yardstick; the port never calls it): SDPA over K/V gathered through
    the page table and expanded to the query heads beforehand."""
    from repro_torch.models.attention import paged_gather
    G = HEADS["H"] // HEADS["KV"]
    B = q.shape[0]
    kg = paged_gather(k, pt).transpose(1, 2).repeat_interleave(G, dim=1)
    vg = paged_gather(v, pt).transpose(1, 2).repeat_interleave(G, dim=1)
    qh = q.reshape(B, T, HEADS["H"], HEADS["hd"]).transpose(1, 2)
    qh = qh.to(kg.dtype)
    kpos = torch.arange(kg.shape[2], device=q.device)[None, None, :]
    last = (lengths - 1)[:, None] if decode else \
        lengths[:, None] + torch.arange(T, device=q.device)[None, :]
    mask = (kpos <= last[:, :, None])[:, None]        # (B, 1, T, C)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qh, kg, vg, attn_mask=mask)


def phase_kernels(timer: Timer):
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    specs = [
        ("paged_decode_attention", dops.paged_decode_attention,
         dops.paged_decode_attention_plain, 1, True, dops.KERNEL),
        ("paged_prefill_attention", fops.paged_prefill_attention,
         fops.paged_prefill_attention_plain, 32, False, fops.KERNEL)]
    combos = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
              (torch.bfloat16, torch.bfloat16)]
    served = {}
    for name, kern, plain, T, decode, handle in specs:
        for B in (4, 8):
            for qdt, kvdt in combos:
                q, k, v, pt, lengths = _case(B * 7 + T, B, T, qdt, kvdt,
                                             "cuda")
                if decode:
                    q = q[:, 0].contiguous()
                args = (q, k, v, pt, lengths)
                n0 = handle.launches
                out = kern(*args)
                torch.cuda.synchronize()
                check(handle.launches == n0 + 1, f"{name} did not launch")
                want = plain(*args)
                check(torch.isfinite(out.float()).all().item(),
                      f"{name}: non-finite output")
                err = (out.float() - want.float()).abs().max().item()
                tol = TOL[kvdt]
                tag = (f"{name} B={B} T={T} q={str(qdt)[6:]} "
                       f"kv={str(kvdt)[6:]}")
                check(err <= tol, f"{tag}: max_abs_err {err} > {tol}")
                line = f"[kernels] {tag}: max_abs_err={err:.3e} (tol {tol})"
                if qdt == kvdt:
                    ms = timer.ms(lambda: kern(*args))
                    plain_ms = timer.ms(lambda: plain(*args))
                    lib_ms = timer.ms(_library_call(*args, T, decode))
                    bound, by = _bound_ms(q, k, lengths, T, decode)
                    line += (f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                             f"library_ms={lib_ms:.4f} bound_ms={bound:.5f}"
                             f" ({by})")
                    if B == 8 and kvdt == torch.bfloat16:
                        served[name] = dict(
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound, bound_by=by, library_ms=lib_ms)
                log(line)
    log(f"[kernels] tolerance: f32 1e-5; {TOL_REASON}")
    return served


# -- phase 4 --------------------------------------------------------------------

def phase_engine(kernels) -> None:
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    cfg = get_config("smollm-360m").replace(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (37, 5, 70, 18, 33, 50)]
    kw = dict(batch_size=4, capacity=128, max_new_tokens=8,
              prefill_chunk=32, block_size=16, burst=4)
    cpu_model = build_model(cfg, device="cpu")
    cpu_params = cpu_model.init(seed=0)
    want = ServeEngine(cpu_model, cpu_params, device="cpu", **kw).serve(prompts)
    gpu_model = build_model(cfg, device="cuda")
    gpu_params = bridge.to_torch(cpu_params, "cuda")
    for k in kernels:
        k.launches = 0
    got = ServeEngine(gpu_model, gpu_params, device="cuda", **kw).serve(prompts)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    for a, b in zip(want, got):
        check(b.status == "ok", f"request {b.request_id}: {b.status}")
        check(np.array_equal(a.tokens, b.tokens),
              f"request {a.request_id}: cpu {a.tokens} != cuda {b.tokens}")
    check(all(n > 0 for n in launches.values()),
          f"engine run missed a kernel: {launches}")
    log(f"[engine] 2-layer f32 smollm heads: {len(prompts)} requests, "
        f"greedy tokens on cuda == cpu ({sum(len(r.tokens) for r in got)} "
        f"tokens); launches {launches}")


# -- phase 5 --------------------------------------------------------------------

def phase_main_path(kernels):
    from repro_torch.launch import serve
    argv = ["--arch", "smollm-360m", "--kv-dtype", "bf16", "--requests", "16",
            "--batch", "8", "--prompt-len", "512", "--max-new", "64",
            "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    out = serve.main(argv)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    eng = out["engine"]
    check(out["n_results"] == 16 and out["total_tokens"] == 16 * 64,
          f"served {out['n_results']} requests / {out['total_tokens']} tokens")
    # (a short micro-batch is padded to its power-of-2 bucket with zero
    # rows, which the engine serves too)
    check(eng.n_evictions >= 16, f"{eng.n_evictions} requests finished")
    check(all(n > 0 for n in launches.values()),
          f"main path missed a kernel: {launches}")
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


def phase_trace(eng) -> None:
    """Where the device time goes on the main path: the phase-5 engine
    serves 8 more requests (512-token prompts, 64 new tokens, direct)
    under a CUDA-only profiler trace; device busy share = summed kernel
    time over the wall time of the serve (one stream: kernels do not
    overlap)."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, eng.model.cfg.vocab_size, 512).astype(np.int32)
               for _ in range(8)]
    steps0 = eng.n_device_steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = eng.serve(prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(all(r.status == "ok" and len(r.tokens) == 64 for r in res),
          "traced serve failed")
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    check(busy_us > 0, "the profiler recorded no device time")
    steps = eng.n_device_steps - steps0
    log(f"[trace] 8 x 512-token prompts, 64 new tokens, direct: wall "
        f"{wall * 1e3:.1f} ms over {steps} device steps "
        f"({wall * 1e3 / steps:.2f} ms/step), device busy "
        f"{busy_us / 1e3:.1f} ms = {busy_us / 1e4 / wall:.1f}% "
        f"(idle {100 - busy_us / 1e4 / wall:.1f}%)")
    for key, us, n in rows[:8]:
        log(f"[trace]   {us / 1e3:9.2f} ms {n:7d} calls  {key[:90]}")


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    kernels = [dops.KERNEL, fops.KERNEL]
    card = phase_device()
    phase_build(kernels)
    served = phase_kernels(Timer())
    phase_engine(kernels)
    launches, eng = phase_main_path(kernels)
    phase_trace(eng)
    replaces = {
        "paged_decode_attention":
            "src/repro/kernels/decode_attention/kernel.py:195",
        "paged_prefill_attention":
            "src/repro/kernels/flash_attention/kernel.py:67"}
    rows = [dict(name=k.name, route="cuda",
                 source=str(k.source.relative_to(ROOT)),
                 replaces=replaces[k.name], launches=launches[k.name],
                 **served[k.name]) for k in kernels]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
