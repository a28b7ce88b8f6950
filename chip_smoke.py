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
                 one split, one more, the whole cache, and its MLA entry
                 at B = 2, where 128 heads split), each decode entry
                 twice (the same bits), and the split-TF32 body's edges
                 (lengths 0, page straddles, T = 5 and 17; windows 16 and
                 128 at S = 77).  K2 also at the speculative verify shape
                 (smollm heads, B = 8, T = 5, bf16, ``_mma``) and the
                 draft's T = 2 catch-up, timed.  B2 contiguous and B4 at
                 DeepSeek-V3's MLA heads on MLA's own operands (128 heads,
                 q 192 = 128 + 64, k_nope and V 128 per head, one rope key
                 of 64 per token shared by every head; B = 8, S = 512
                 causal; a 640-slot latent cache, 576 valid, its rope keys
                 read in place; bf16) through their MLA entries
                 (``flash_attention_mla_bf16_mma``, the tensor-core body
                 at q/k 192 and V 128; ``decode_attention_mla_bf16``),
                 SDPA on the broadcast rope key and V beside, and the
                 numbers of the padded-operand form logged beside.  Then
                 B2 and B4 at the shapes phases 15 and 16 serve: B2
                 without the causal mask at whisper-tiny's encoder (6/6
                 heads of 64, B = 8, S = T = 1500, timed), with more
                 queries than keys (S = 100, T = 64) and at hd 128 (S =
                 T = 300), bf16 on ``_mma`` and f32 on ``_tf32``; B2
                 causal at qwen2-vl-72b's heads (64/8, hd 128, S = 1152,
                 timed); B4 over whisper's 1500-slot cross cache and at
                 qwen2-vl's heads (1183 of 1184 slots), timed in bf16.
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
 11. sampling and speculation — (a) at phase 4's size (the 2-layer f32
                 smollm-headed model; the draft is its first layer, the
                 same embedding and head): seeded sampling (temperature
                 0.8, top_k 16, seed 11) paged and dense, the card's
                 tokens equal to the CPU port's and paged == dense on the
                 card (B2/B4 in the dense run, K1/K2 in the paged); greedy
                 speculation (spec_k 4) equal to the CPU port's and to the
                 card's own non-speculative run, sampled speculation equal
                 to the CPU port's, K1 and K2 launched.  (b) smollm-360m at
                 full width (bf16, bf16 pool; batch 8, chunk 32; 16
                 requests of up to 512 prompt tokens, 64 new): the
                 launcher's pipeline at ``--temperature 0.8 --top-k 50
                 --seed 0`` (tok/s beside phase 5's greedy tok/s; the
                 sampler's device operations and ms per call at (8,
                 49152), the greedy argmax's beside them; a profiler trace
                 of the sampled engine); the engine directly with a
                 self-draft at spec_k 4, greedy (accept rate, tokens per
                 round, tok/s against the same prompts without
                 speculation, the share of equal tokens logged; K2 must
                 run at T = 5, through ``_mma``); the launcher at
                 ``--spec-k 4 --draft-config smollm-360m --temperature
                 0.8`` (all 16 ok, accept rate logged).
 12. xLSTM     — (a) the 2-layer f32 xlstm-350m smoke stack (one mLSTM,
                 one sLSTM) paged and dense: the card's greedy tokens equal
                 the CPU port's; no kernel launches (the blocks are plain
                 torch, as the reference's).  (b) xlstm-350m at full width
                 and depth (24 layers, d 1024, 4 heads of 512, 21 mLSTM +
                 3 sLSTM; bf16 over the default f32 cache_dtype, random
                 weights from seed 0): 8 requests of 128 prompt tokens, 16
                 new, through the launcher's pipeline, paged (batch 8,
                 chunk 32, burst 8, 8 slabs); tok/s, the slab bytes per
                 slot, then a profiler trace (device operations per step,
                 busy share); then request 0 preempted after two tokens
                 and restored through the batch lane, its tokens equal to
                 an unpreempted run's; then ``--arch xlstm-350m`` through
                 the launcher (paged, 8 requests).
 13. MLA       — (a) the deepseek-v3 smoke model (2 layers, f32, q/k head
                 48, v head 32, 4 experts) on the dense engine in both
                 decode forms: the card's tokens equal the CPU port's (B2,
                 B6, and B4 in the expanded form); the two forms' decode
                 logits on the card within 2e-3 (the reference's bound).
                 (b) deepseek-v3-671b at full width (d 7168, 128 heads,
                 q rank 1536, kv rank 512, vocab 129280) cut to 4 of its
                 61 layers: the 3 dense-prefix layers (d_ff 18432) and 1
                 MoE layer (256 experts top-8, 1 shared), plus the MTP
                 leaves (~16B bf16 parameters, ~32 GB): 8 requests of 128
                 prompt tokens, 16 new, batch 8, bf16 latent cache, in the
                 expanded form (B2 through ``flash_attention_mla_bf16_mma``,
                 B4 through ``decode_attention_mla_bf16``, B6) with a
                 profiler trace (and the operand-building copies), then
                 the absorbed form (B2, B6); then layer 0's served
                 operands through B2 (S = 128) and B4 (129 and 144 valid
                 slots) against their plain versions with phase 3's MLA
                 tolerances, and timed.  (a) runs the GQA entries over
                 the concatenated operands (f32, other dims).
 14. forward   — (a) ``apply`` (the full-sequence forward) of phase 4's
                 f32 models (the 2-layer smollm-headed stack; the jamba,
                 deepseek and xLSTM smoke stacks) on the card against the
                 CPU port, logits and aux within 1e-3 of the largest
                 logit, each path's kernels launched (B2; B5, B6; none
                 for xLSTM); ``SingleShot(model="smollm-360m:smoke",
                 framework="torch")`` on the card against the CPU.  (b)
                 smollm-360m at full width and depth (bf16): ``apply``
                 on (8, 512) tokens through ``SingleShot(fn=...,
                 framework="torch")``, B2 once a layer through ``_mma``;
                 its last row's argmax against ``prefill``'s.
 15. whisper   — whisper-tiny at full width and depth (4 + 4 layers, d
                 384, 6 heads, 1500 frames, vocab 51865, bf16; no cut) on
                 the dense engine: ``generate_batch`` of 8 x 4-token
                 prompts with (8, 1500, 384) frames from numpy seed 0, 64
                 new tokens; B2 through ``_mma`` 3 times a layer (the
                 encoder's and the cross-attention without the causal
                 mask), B4 twice a layer and step (self, and cross over
                 all 1500 slots).  The smoke config in f32: card tokens
                 equal the CPU port's.  Then a trace.
 16. VLM       — qwen2-vl-72b at full width (d 8192, 64/8 heads of 128,
                 M-RoPE, d_ff 29568, vocab 152064, bf16) cut to 8 of 80
                 layers (~9.5B random parameters made on the card):
                 ``generate_batch`` of 8 requests of 1024 patch rows and
                 128 text tokens, 32 new; B2 (``_mma``) once a layer, B4
                 once a layer and step.  Then a trace.
Two lines before the last is a JSON object with one entry per kernel
(K1/K2 launches from phase 5, B5/B6 from phase 6, B2-contiguous/B4 from
phase 7, B3/K2q from phase 8, B7 from phase 9; ``launches_phase11``:
phase 11's gated card runs; ``launches_phase13``: phase 13(b)'s two
runs; ``mla_heads``: B2's and B4's phase-3 rows at the MLA heads;
``mla_served``: the same at phase 13(b)'s shapes; ``launches_phase14``
to ``launches_phase16``: those phases' runs; ``slice_shapes``: B2's and
B4's phase-3 rows at phases 15 and 16's shapes); then
the card's name and power limit; the last line is ``{"ok": true,
"device": {...}}``.  The whole run takes ~5-9 minutes on one H100, the
build included.
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
SPEC_K = 4                         # phase 11's draft tokens per round
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
    prefill_tf32.cuh, split TF32) with head_dim (q/k and V: they differ
    for MLA), ring stages and warps a block from the mangled template
    arguments and the
    dynamic shared memory the launch asks for (K and V tiles x stages x
    keys x padded rows, plus the int8 row scales, and q at head_dim 128
    in the TF32 body), and the split decode body (decode_body.cuh) by its
    types and row policy."""
    elt = {"f": 4, "13__nv_bfloat16": 2, "a": 1}
    fn, props = None, []
    for ln in text.splitlines() + ["Compiling entry function 'end'"]:
        if "Compiling entry function" in ln:
            if fn and "prefill_mma_kernel" in fn:
                targs = fn.split("prefill_mma_kernel", 1)[1]
                hd, vd, stages, warps = map(int, re.findall(r"Li(\d+)E",
                                                            targs))
                # the ring, and q after it where it does not fit a stage
                stage, q = 64 * ((hd + 8) + (vd + 8)), warps * 16 * (hd + 8)
                smem = 2 * (stages * stage + (q if q > stage else 0))
                form = "MLA " if "MlaRows" in targs else ""
                log(f"[build] {name} tensor-core body {form}hd {hd} v {vd}: "
                    f"{warps} warps, {stages} ring stages, {smem} bytes of "
                    f"dynamic shared memory; " + " | ".join(props))
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
                rows = ("paged" if "PagedRows" in targs else "MLA"
                        if "MlaRows" in targs else "contiguous")
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
    def case(name, kern, plain, T, decode, handle, geo, heads, B, qdt,
             kvdt):
        """Check one shape against the plain version (and that it ran its
        entry); time it where q and K/V share a type.  Returns (max abs
        error, timing row or None)."""
        q, k, v, pt, lengths = _attn_case(B * 7 + T, B, T, qdt, kvdt, heads)
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
        check(entry is None or handle.entry_launches[entry] == e0 + 1,
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
        row = None
        if qdt == kvdt:
            row = _time_row(timer, kern, plain, args,
                            _attn_library_call(*args, T, decode, heads),
                            _attn_bound_ms(q, k, lengths, T, decode, heads))
            line += _fmt(row)
        log(line)
        return err, row

    served = {}
    for name, kern, plain, T, decode, handle in specs:
        for geo, heads, batches, combos in geometries:
            for B in batches:
                for qdt, kvdt in combos:
                    err, row = case(name, kern, plain, T, decode, handle,
                                    geo, heads, B, qdt, kvdt)
                    if row is not None and geo == "smollm" and B == 8 \
                            and kvdt == bf16:
                        served[name] = dict(max_abs_err=err, **row)
    # the speculative verify step: T = spec_k + 1 = 5 tokens per row
    # (phase 11's shape), and the draft's T = 2 catch-up
    for T in (SPEC_K + 1, 2):
        case("paged_prefill_attention", fops.paged_prefill_attention,
             fops.paged_prefill_attention_plain, T, False, fops.KERNEL,
             "smollm", SMOLLM_HEADS, 8, bf16, bf16)
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


MLA_HEADS = dict(H=128, KV=128, hd=192, v_hd=128)  # deepseek-v3: 128 + 64


def _bf16_ulp(want) -> float:
    """One bf16 ulp at the largest magnitude of ``want`` (8 significant
    bits): the MLA rows' tolerance unit, since their outputs reach
    |out| > 4 (one ulp 3.1e-2), past the smollm rows' |out| ~ 3."""
    amax = want.float().abs().max().item()
    return 2.0 ** (np.floor(np.log2(amax)) - 7) if amax > 0 else 0.0


def _mla_bound(H, n_scores, qk, vd, q_rows, kv_rows, rope=0):
    """Bytes (q at the q/k head and the output at v_head_dim; per visible
    key its K rows and V rows, bf16, each once) and operations (QK at qk,
    PV at v_head_dim, multiply and add).  ``rope``: the width of the rope
    key that every head of a token shares, counted once per token as the
    MLA entries read it; 0 counts it per head, as the padded operands
    (the key broadcast to every head) held it."""
    k_row = H * qk if not rope else H * (qk - rope) + rope
    n_bytes = 2 * (q_rows * H * (qk + vd) + kv_rows * (k_row + H * vd))
    return _bound(n_bytes, 2 * H * (qk + vd) * n_scores, torch.bfloat16)


# The MLA rows of the padded-operand form (the rope key broadcast to every
# head, V zero-padded to 192, the CUDA-core prefill body), measured on an
# "NVIDIA H100 80GB HBM3, 700.00 W" card (PERF.md §6): logged beside this
# run's
PADDED_MLA = {"phase 3 B2": "16.1882 ms, plain 4.8346, SDPA 0.2755",
            "phase 3 B4": "0.2156 ms, plain 1.5519, SDPA 0.1638",
            "served B2": "1.2561 ms, plain 0.6327, SDPA 0.0708",
            "served B4": "0.0791 ms (144 valid), plain 0.3329, SDPA 0.0625"}


def _mla_flash_row(timer, q, k_nope, k_rope, v, tag, padded):
    """B2's MLA entry on these operands (q (B, S, H, 192), k_nope and V
    (B, S, H, 128), the shared rope key (B, S, 64); causal, S = T): one
    launch of ``flash_attention_mla_bf16_mma``, the output within one bf16
    ulp of the plain version's largest, then timed beside the plain
    version and SDPA (on K with the rope key broadcast beforehand, V
    unpadded: the padded form's yardstick call).  The bound counts the
    rope key once per token; the padded form's, per head, is logged beside
    it, and so are ``padded``, that form's numbers."""
    from repro_torch.kernels.flash_attention import ops as fops
    B, S, H, hd = q.shape
    rope, vd = k_rope.shape[-1], v.shape[-1]
    entry = "flash_attention_mla_bf16_mma"
    check(fops.mla_flash_entry((q.dtype, k_nope.dtype, k_rope.dtype,
                                v.dtype), (hd - rope, rope, vd)) == entry,
          f"{tag}: the MLA operands do not go to {entry}")
    e0 = fops.FLASH_KERNEL.entry_launches[entry]
    out = fops.mla_flash_attention(q, k_nope, k_rope, v)
    torch.cuda.synchronize()
    check(fops.FLASH_KERNEL.entry_launches[entry] == e0 + 1,
          f"{tag}: flash_attention did not launch {entry}")
    want = fops.mla_flash_attention_plain(q, k_nope, k_rope, v)
    check(out.shape == want.shape == (B, S, H, vd)
          and torch.isfinite(out.float()).all().item(),
          f"{tag}: non-finite output or shape {tuple(out.shape)}")
    diff = (out.float() - want.float()).abs()
    err = diff.max().item()
    at = want.flatten()[diff.flatten().argmax()].float().item()
    # one ulp, as the smollm rows (the kernel rounds the unnormalized
    # probabilities, the plain version the normalized ones)
    tol = max(DENSE_BF16_TOL["flash_attention"], _bf16_ulp(want))
    tag = (f"{tag} [{entry}]; the largest error at |out| = {abs(at):.3f} "
           f"(|out| <= {want.float().abs().max().item():.3f})")
    check(err <= tol, f"{tag}: max_abs_err {err} > {tol}")
    del out, want, diff
    k_full = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, rope)],
                       dim=-1)
    n_scores = B * S * (S + 1) // 2
    row = _time_row(timer, fops.mla_flash_attention,
                    fops.mla_flash_attention_plain, (q, k_nope, k_rope, v),
                    _sdpa(q, k_full, v, 1, causal=True),
                    _mla_bound(H, n_scores, hd, vd, B * S, B * S, rope))
    old = _mla_bound(H, n_scores, hd, vd, B * S, B * S)[0]
    log(f"{tag}: max_abs_err={err:.3e} (tol {tol})" + _fmt(row)
        + f"; bound with the rope key per head {old:.5f}; padded operands: {padded}")
    return dict(max_abs_err=err, bound_ms_padded=old, **row)


def _mla_decode_row(timer, q, k_nope, kr_cache, v, n_valid, tag, padded):
    """B4's MLA entry on these operands (q (B, H, 192), k_nope and V
    (B, T, H, 128), the latent cache's rope keys (B, C, 64), C >= T):
    one launch of ``decode_attention_mla_bf16``, the output within two
    bf16 ulps of the plain version's largest, then timed beside the plain
    version and SDPA (K with the rope key broadcast beforehand, V
    unpadded, a mask only where slots past ``n_valid`` exist: the padded
    form's yardstick calls).  Bounds and ``padded`` as
    ``_mla_flash_row``'s."""
    from repro_torch.kernels.decode_attention import ops as dops
    B, H, hd = q.shape
    T, rope, vd = k_nope.shape[1], kr_cache.shape[-1], v.shape[-1]
    entry = "decode_attention_mla_bf16"
    check(dops.mla_entry((q.dtype, k_nope.dtype, kr_cache.dtype, v.dtype),
                         (hd - rope, rope, vd)) == entry,
          f"{tag}: the MLA operands do not go to {entry}")
    e0 = dops.DENSE_KERNEL.entry_launches[entry]
    out = dops.mla_decode_attention(q, k_nope, kr_cache, v, n_valid)
    torch.cuda.synchronize()
    check(dops.DENSE_KERNEL.entry_launches[entry] == e0 + 1,
          f"{tag}: decode_attention did not launch {entry}")
    want = dops.mla_decode_attention_plain(q, k_nope, kr_cache, v, n_valid)
    check(out.shape == want.shape == (B, H, vd)
          and torch.isfinite(out.float()).all().item(),
          f"{tag}: non-finite output or shape {tuple(out.shape)}")
    err = (out.float() - want.float()).abs().max().item()
    tol = max(DENSE_BF16_TOL["decode_attention"], 2 * _bf16_ulp(want))
    tag = f"{tag} [{entry}]"
    check(err <= tol, f"{tag}: max_abs_err {err} > {tol}")
    k_full = torch.cat([k_nope, kr_cache[:, :T, None].expand(B, T, H, rope)],
                       dim=-1)
    mask = None if n_valid == T else \
        (torch.arange(T, device="cuda") < n_valid)[None, None, None, :]
    row = _time_row(timer, dops.mla_decode_attention,
                    dops.mla_decode_attention_plain,
                    (q, k_nope, kr_cache, v, n_valid),
                    _sdpa(q[:, None], k_full, v, 1, mask=mask),
                    _mla_bound(H, B * n_valid, hd, vd, B, B * n_valid, rope))
    old = _mla_bound(H, B * n_valid, hd, vd, B, B * n_valid)[0]
    log(f"{tag}: max_abs_err={err:.3e} (tol {tol})" + _fmt(row)
        + f"; bound with the rope key per head {old:.5f}; padded operands: {padded}")
    return dict(max_abs_err=err, bound_ms_padded=old, **row)


def phase_mla_kernels(timer: Timer):
    """B2 contiguous and B4 at DeepSeek-V3's MLA heads (phase 13's path)
    on MLA's own operands, bf16: H = 128 heads, q (192 = 128 + 64), k_nope
    and V (128) per head, one rope key (64) per token shared by every
    head.  B2 at B = 8, S = T = 512, causal, through
    ``flash_attention_mla_bf16_mma`` (the tensor-core body at q/k 192, V
    128); B4 at B = 8 over a 640-slot latent cache, 576 valid, through
    ``decode_attention_mla_bf16`` (the split decode body, the rope key read
    in place).  SDPA, the yardstick, takes K with the rope key broadcast
    and the unpadded V, as for the padded operands."""
    H, hd, vd = MLA_HEADS["H"], MLA_HEADS["hd"], MLA_HEADS["v_hd"]
    rope = hd - vd
    g = torch.Generator(device="cpu").manual_seed(192)
    B, S = 8, 512

    def rand(*shape):
        return torch.randn(shape, generator=g).to("cuda", torch.bfloat16)

    rows = {"flash_attention": _mla_flash_row(
        timer, rand(B, S, H, hd), rand(B, S, H, vd), rand(B, S, rope),
        rand(B, S, H, vd),
        f"[kernels] flash_attention (contiguous) MLA heads {H}/{H} q/k {hd} "
        f"(rope {rope} shared) V {vd} B={B} S=T={S} causal bfloat16",
        PADDED_MLA["phase 3 B2"])}
    C, n_valid = 640, 576
    rows["decode_attention"] = _mla_decode_row(
        timer, rand(B, H, hd), rand(B, C, H, vd), rand(B, C, rope),
        rand(B, C, H, vd), n_valid,
        f"[kernels] decode_attention (dense) MLA heads {H}/{H} q/k {hd} "
        f"(rope {rope} in place) V {vd} B={B} C={C} n_valid={n_valid} "
        f"bfloat16", PADDED_MLA["phase 3 B4"])
    return rows


WHISPER_HEADS = dict(H=6, KV=6, hd=64)       # whisper-tiny: 6 heads of 64
QWEN2VL_HEADS = dict(H=64, KV=8, hd=128)     # qwen2-vl-72b: 64 query, 8 KV


def phase_slice_kernels(timer: Timer):
    """B2 and B4 at the shapes phases 15 and 16 serve, against their plain
    versions, each on the entry the dispatch picks: B2 without the causal
    mask at whisper-tiny's encoder (B = 8, S = T = 1500, no multiple of a
    64-key tile: the tensor-core bodies mask kpos >= T alone), its
    decoder's cross-attention with more queries than keys (S = 100 over
    T = 64, the smoke encoder) and at jamba's hd 128 (S = T = 300), bf16
    on ``_mma`` and f32 on ``_tf32``; B2 causal at qwen2-vl-72b's heads
    (64/8, hd 128, S = 1152: 1024 patch rows and 128 text tokens); B4
    over whisper's whole cross cache (1500 of 1500 slots, one query, no
    mask) and at qwen2-vl's heads (1183 of 1184 slots, the last decode
    step).  The bf16 rows at the served shapes are timed beside the plain
    version, SDPA and the bound.  Returns {kernel: {shape: row}}."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    f32, bf16 = torch.float32, torch.bfloat16
    rows = {"flash_attention": {}, "decode_attention": {}}
    B = 8
    flash_cases = [  # (tag, heads, S, T, causal, dtype, timed)
        ("whisper encoder", WHISPER_HEADS, 1500, 1500, False, bf16, True),
        ("whisper encoder", WHISPER_HEADS, 1500, 1500, False, f32, False),
        ("cross S > T", WHISPER_HEADS, 100, 64, False, bf16, False),
        ("cross S > T", WHISPER_HEADS, 100, 64, False, f32, False),
        ("jamba heads bidirectional", JAMBA_HEADS, 300, 300, False, bf16,
         False),
        ("jamba heads bidirectional", JAMBA_HEADS, 300, 300, False, f32,
         False),
        ("qwen2-vl causal", QWEN2VL_HEADS, 1152, 1152, True, bf16, True)]
    for tag, heads, S, T, causal, dtype, timed in flash_cases:
        H, KV, hd = heads["H"], heads["KV"], heads["hd"]
        q, k, v = _dense_qkv(S + T + hd, B, S, T, heads, dtype)
        entry = fops.flash_entry(dtype, hd)
        e0 = dict(fops.FLASH_KERNEL.entry_launches)
        out = fops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        e1 = fops.FLASH_KERNEL.entry_launches
        check({e: e1[e] - e0[e] for e in e1} == {e: int(e == entry)
                                                 for e in e1},
              f"flash_attention {tag}: launched {e1}, not one {entry}")
        want = fops.flash_attention_plain(q, k, v, causal=causal)
        check(torch.isfinite(out.float()).all().item(),
              f"flash_attention {tag}: non-finite output")
        err = (out.float() - want.float()).abs().max().item()
        tol = TOL[f32] if dtype == f32 else DENSE_BF16_TOL["flash_attention"]
        line = (f"flash_attention (contiguous) {tag}: heads {H}/{KV} hd {hd} "
                f"B={B} S={S} T={T} {'causal' if causal else 'no mask'} "
                f"{str(dtype)[6:]} [{entry}]")
        check(err <= tol, f"{line}: max_abs_err {err} > {tol}")
        line = f"[kernels] {line}: max_abs_err={err:.3e} (tol {tol})"
        if timed:
            n_scores = B * H * (S * (S + 1) // 2 if causal else S * T)
            n_bytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size()
            row = _time_row(
                timer, lambda *a: fops.flash_attention(*a, causal=causal),
                lambda *a: fops.flash_attention_plain(*a, causal=causal),
                (q, k, v), _sdpa(q, k, v, H // KV, causal=causal),
                _bound(n_bytes, 4 * hd * n_scores, dtype))
            line += _fmt(row)
            rows["flash_attention"][f"{tag} B={B} S={S} T={T}"] = dict(
                max_abs_err=err, **row)
        log(line)
    for tag, heads, C, n_valid in (("whisper cross", WHISPER_HEADS, 1500,
                                    1500),
                                   ("qwen2-vl", QWEN2VL_HEADS, 1184, 1183)):
        H, KV, hd = heads["H"], heads["KV"], heads["hd"]
        for dtype in (f32, bf16):
            q, k, v = _dense_qkv(C + n_valid, B, 1, C, heads, dtype)
            q = q[:, 0].contiguous()
            n0 = dops.DENSE_KERNEL.launches
            out = dops.decode_attention(q, k, v, n_valid)
            torch.cuda.synchronize()
            check(dops.DENSE_KERNEL.launches == n0 + 1,
                  "decode_attention did not launch")
            want = dops.decode_attention_plain(q, k, v, n_valid)
            check(torch.isfinite(out.float()).all().item(),
                  f"decode_attention {tag}: non-finite output")
            err = (out.float() - want.float()).abs().max().item()
            tol = TOL[f32] if dtype == f32 \
                else DENSE_BF16_TOL["decode_attention"]
            line = (f"decode_attention (dense) {tag}: heads {H}/{KV} hd {hd} "
                    f"B={B} C={C} n_valid={n_valid} {str(dtype)[6:]}")
            check(err <= tol, f"{line}: max_abs_err {err} > {tol}")
            line = f"[kernels] {line}: max_abs_err={err:.3e} (tol {tol})"
            if dtype == bf16:
                es = k.element_size()
                n_bytes = (q.numel() * (q.element_size() + es)
                           + 2 * B * n_valid * KV * hd * es)
                mask = (torch.arange(C, device="cuda") < n_valid)
                row = _time_row(timer, dops.decode_attention,
                                dops.decode_attention_plain,
                                (q, k, v, n_valid),
                                _sdpa(q[:, None], k, v, H // KV,
                                      mask=mask[None, None, None, :]),
                                _bound(n_bytes, 4 * B * H * hd * n_valid,
                                       dtype))
                line += _fmt(row)
                rows["decode_attention"][f"{tag} B={B} C={C} "
                                         f"n_valid={n_valid}"] = dict(
                    max_abs_err=err, **row)
            log(line)
    return rows


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
    one more and the whole cache (its MLA entry at B = 2, 128 heads, too);
    two launches of each decode entry must give the same bits.  f32 K2 and K2q with a slot that has nothing
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
    # B4's MLA entry where its 128 heads leave splits (B = 2: 256 pairs):
    # partials V-wide (128) beside a 192-wide q, the rope key in place
    B, H, C = 2, MLA_HEADS["H"], 640
    n_split, split_keys = dops.split_plan(C, B * H)
    g = torch.Generator(device="cpu").manual_seed(21)
    errs, tols = [], []
    for n_valid in (1, split_keys, split_keys + 1, C):
        q, kn, kr, v = (torch.randn(shape, generator=g).to("cuda", bf16)
                        for shape in ((B, H, 192), (B, C, H, 128), (B, C, 64),
                                      (B, C, H, 128)))
        out = dops.mla_decode_attention(q, kn, kr, v, n_valid)
        again = dops.mla_decode_attention(q, kn, kr, v, n_valid)
        want = dops.mla_decode_attention_plain(q, kn, kr, v, n_valid)
        torch.cuda.synchronize()
        check(torch.equal(out, again),
              f"mla_decode_attention n_valid {n_valid}: launches differ")
        errs.append((out.float() - want.float()).abs().max().item())
        tols.append(max(DENSE_BF16_TOL["decode_attention"],
                        2 * _bf16_ulp(want)))
        check(errs[-1] <= tols[-1], f"decode_attention (B4, MLA) n_valid "
              f"{n_valid}: max_abs_err {errs[-1]} > {tols[-1]}")
    log(f"[splits] decode_attention (B4, MLA entry) B={B} heads {H} "
        f"n_valid 1/{split_keys}/{split_keys + 1}/{C} ({n_split} splits of "
        f"{split_keys} at C): max_abs_err {max(errs):.3e} (tol "
        f"{min(tols):.3e} and up); bitwise repeatable")
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
    return launches, eng, out["total_tokens"] / out["wall_s"]


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
    steps = eng.n_device_steps - steps0
    waves = "" if eng.paged else \
        f" + {eng.n_prefills - waves0} prefill waves"
    return _report_trace(prof, wall, steps, tag,
                         f"{n} x {prompt_len}-token prompts, "
                         f"{eng.max_new_tokens} new tokens, direct", waves)


def _report_trace(prof, wall: float, steps: int, tag: str, what: str,
                  waves: str = ""):
    """Log a CUDA trace of ``steps`` device steps over ``wall`` seconds:
    busy share, the kernels that take the device time, the operand
    copies, the hand-written kernels, device-to-host copies and device
    operations per step.  Returns (device-to-host copies per step,
    {device operation: calls per step})."""
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    check(busy_us > 0, "the profiler recorded no device time")
    log(f"[{tag}] trace: {what}: wall "
        f"{wall * 1e3:.1f} ms over {steps} device steps{waves} "
        f"({wall * 1e3 / steps:.2f} ms/step), device busy "
        f"{busy_us / 1e3:.1f} ms = {busy_us / 1e4 / wall:.1f}% "
        f"(idle {100 - busy_us / 1e4 / wall:.1f}%)")
    for key, us, cnt in rows[:10]:
        log(f"[{tag}]   {us / 1e3:9.2f} ms {cnt:7d} calls  {key[:90]}")
    # the copies that build operands around the kernels, each
    # concatenation kernel (template) on its own
    for what, pat in (("concatenations", "CatArrayBatchedCopy"),
                      ("elementwise copies", "direct_copy_kernel"),
                      ("fills", "FillFunctor")):
        sel = [(key, us, cnt) for key, us, cnt in rows if pat in key]
        log(f"[{tag}] {what} ({pat}): "
            f"{sum(us for _, us, _ in sel) / 1e3:.2f} ms over "
            f"{sum(cnt for *_, cnt in sel)} calls")
        if what == "concatenations":
            for key, us, cnt in sel:
                log(f"[{tag}]   {us / 1e3:9.2f} ms {cnt:7d} calls  "
                    f"{key[key.index(pat):][:140]}")
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
    ``decode_rid`` once it holds two tokens (either may be None); the
    schedule depends on the step count alone, so the card and the CPU run
    the same one.  Returns the results in request order."""
    rids = [eng.submit(p, lane="batch") for p in prompts]
    todo = {decode_rid, prefill_rid} - {None}
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


# -- phase 11 -------------------------------------------------------------------

SAMPLED = dict(temperature=0.8, top_k=16, seed=11)   # phase 11(a)


def _tally(kernels, acc) -> dict:
    """This run's launches (added to ``acc``, phase 11's total); the
    counts are reset for the next run."""
    launches = {k.name: k.launches for k in kernels}
    for n, c in launches.items():
        acc[n] = acc.get(n, 0) + c
    reset(kernels)
    return launches


def _first_layers(params, n: int):
    """The params of the stack's first ``n`` layers (periodic leaves carry
    a leading layer axis): the draft of phase 11(a) is the target cut to
    one layer, sharing its embedding, norms and head."""
    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[:n].contiguous()
    return dict(params, blocks=cut(params["blocks"]))


def phase_sampling_spec_small(kernels, acc) -> None:
    """Phase 11(a): seeded sampling and speculative decoding at phase 4's
    size, the card against the CPU port."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    cfg = get_config("smollm-360m").replace(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    dcfg = cfg.replace(arch_id="smollm-360m-1layer", n_layers=1)
    models = {}
    for dev in ("cpu", "cuda"):
        m, d = build_model(cfg, device=dev), build_model(dcfg, device=dev)
        models[dev] = (m, d)
    params = {"cpu": models["cpu"][0].init(seed=0)}
    params["cuda"] = bridge.to_torch(params["cpu"], "cuda")
    dparams = {dev: _first_layers(p, 1) for dev, p in params.items()}
    rng = np.random.default_rng(11)
    # equal lengths and one per slot: the dense engine prefills one
    # un-padded wave, so both modes decode at the same positions
    wave = [rng.integers(0, cfg.vocab_size, 40).astype(np.int32)
            for _ in range(4)]
    rng = np.random.default_rng(4)
    mixed = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
             for n in (37, 5, 70, 18, 33, 50)]

    def serve(dev, prompts, spec=False, **kw):
        model, draft = models[dev]
        kw = dict(dict(batch_size=4, capacity=128, max_new_tokens=8,
                       burst=4, prefill_chunk=32, block_size=16), **kw)
        if spec:
            kw.update(draft_model=draft, draft_params=dparams[dev],
                      spec_k=SPEC_K)
        eng = ServeEngine(model, params[dev], device=dev, **kw)
        res = eng.serve(prompts)
        check(all(r.status == "ok" for r in res) and eng.n_step_failures == 0,
              f"[sample] {dev} {kw.get('paged')} spec={spec}: "
              f"{[r.status for r in res]}")
        if dev == "cuda":
            torch.cuda.synchronize()
        return eng, [r.tokens.tolist() for r in res]

    toks = {}
    for paged, path in ((True, PAGED_KERNELS), (False, DENSE_KERNELS)):
        _, want = serve("cpu", wave, paged=paged, **SAMPLED)
        reset(kernels)
        _, got = serve("cuda", wave, paged=paged, **SAMPLED)
        launches = _tally(kernels, acc)
        check(got == want, f"[sample] paged={paged}: cuda {got} != cpu {want}")
        check(all(launches[n] > 0 for n in path)
              and all(launches[n] == 0 for n in ATTN_KERNELS
                      if n not in path),
              f"[sample] paged={paged}: launches {launches}")
        toks[paged] = got
        log(f"[sample] 2-layer f32 smollm heads, paged={paged}, temperature "
            f"0.8, top_k 16, seed 11: 4 x 40-token prompts, sampled tokens "
            f"on cuda == cpu; launches "
            f"{ {n: c for n, c in launches.items() if c} }")
    check(toks[True] == toks[False],
          f"[sample] paged {toks[True]} != dense {toks[False]} on cuda")
    _, greedy = serve("cuda", wave)
    reset(kernels)
    check(greedy != toks[True], "[sample] the sampled run drew the greedy "
          "tokens")
    log("[sample] paged == dense on cuda; sampled != greedy")
    for tag, kw in (("greedy", {}), ("sampled", SAMPLED)):
        _, want = serve("cpu", mixed, spec=True, **kw)
        _, plain = serve("cuda", mixed, **kw)
        reset(kernels)
        eng, got = serve("cuda", mixed, spec=True, **kw)
        launches = _tally(kernels, acc)
        check(got == want, f"[spec] {tag}: cuda {got} != cpu {want}")
        check(tag != "greedy" or got == plain,
              f"[spec] greedy spec {got} != non-spec {plain} on cuda")
        check(all(launches[n] > 0 for n in PAGED_KERNELS),
              f"[spec] {tag}: launches {launches}")
        ls = eng.loop_stats()
        log(f"[spec] 2-layer f32 smollm heads, 1-layer draft (the target's "
            f"first layer), spec_k {SPEC_K}, {tag}: {len(mixed)} requests, "
            f"tokens on cuda == cpu"
            + (" == cuda non-spec" if tag == "greedy" else "")
            + f"; {ls['n_spec_rounds']} rounds -> {ls['n_spec_tokens']} "
            f"tokens, accept rate {ls['spec_accept_rate']:.3f}, hist "
            f"{ls['spec_accept_hist']}; launches "
            f"{ {n: c for n, c in launches.items() if c} }")


def _sampler_cost(sample, B: int, V: int, tag: str) -> None:
    """The device operations and the time of one sampler call at the
    served shape (the sampled engine calls it once per device step):
    operations from a profiler trace, ms per call from CUDA events around
    20 calls back to back (host-bound: it holds the launch gaps)."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device="cpu").manual_seed(0)
    logits = (torch.randn((B, V), generator=g) * 3).to("cuda")
    rids = torch.arange(B, dtype=torch.int32, device="cuda")
    steps = torch.full((B,), 17, dtype=torch.int32, device="cuda")
    for _ in range(3):
        sample(logits, rids, steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sample(logits, rids, steps)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if not RUNTIME_CALL.match(e.key)]
    n_ops = sum(r[2] for r in rows)
    busy = sum(r[1] for r in rows) / 1e3
    s, e = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(20):
        sample(logits, rids, steps)
    e.record()
    torch.cuda.synchronize()
    log(f"[{tag}] sampler at ({B}, {V}): {n_ops} device operations per "
        f"call (= per device step), {busy:.4f} ms of device time, "
        f"{s.elapsed_time(e) / 20:.4f} ms per call back to back")


def phase_sampling_spec(kernels, acc, card: str, greedy_tok_s: float):
    """Phase 11(b): smollm-360m at full width: seeded sampling through the
    launcher's pipeline, then greedy speculation with a self-draft on the
    engine directly, then sampled speculation through the launcher with
    a second smollm-360m (seed 1) as the draft."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import serve
    from repro_torch.serving import ServeEngine
    argv = ["--arch", "smollm-360m", "--kv-dtype", "bf16", "--requests",
            "16", "--batch", "8", "--prompt-len", str(FRONT_PLEN),
            "--max-new", str(FRONT_NEW), "--device", "cuda"]
    reset(kernels)
    out = serve.main(argv + ["--temperature", "0.8", "--top-k", "50",
                             "--seed", "0"])
    torch.cuda.synchronize()
    launches = _tally(kernels, acc)
    check(out["n_results"] == 16 and out["total_tokens"] == 16 * FRONT_NEW,
          f"[sample] served {out['n_results']} / {out['total_tokens']}")
    check(all(launches[n] > 0 for n in PAGED_KERNELS),
          f"[sample] launches {launches}")
    tok_s = out["total_tokens"] / out["wall_s"]
    log(f"[sample] smollm-360m full width through the pipeline, "
        f"temperature 0.8, top_k 50, seed 0: {tok_s:.1f} tok/s against "
        f"phase 5's greedy {greedy_tok_s:.1f} (this call); {card}")
    eng = out["engine"]
    # the launcher's model (seed 0) serves the self-draft run below too
    model, params = eng.model, eng.params
    _sampler_cost(eng._sample, 8, eng.model.cfg.vocab_size, "sample")
    greedy_sample = importlib.import_module(
        "repro_torch.serving.steps").greedy_sample
    _sampler_cost(lambda l, r, t: greedy_sample(l), 8,
                  eng.model.cfg.vocab_size, "greedy")
    reset(kernels)
    phase_trace(eng, "sample")
    reset(kernels)
    del eng, out
    gc.collect()
    torch.cuda.empty_cache()

    prompts = serve.make_requests(model.cfg.vocab_size, 16, FRONT_PLEN)
    kw = dict(batch_size=8, capacity=FRONT_PLEN + FRONT_NEW + 8,
              max_new_tokens=FRONT_NEW, prefill_chunk=32, block_size=16,
              burst=8, kv_dtype="bf16", device="cuda")
    t0 = time.perf_counter()
    plain = ServeEngine(model, params, **kw).serve(prompts, timeout_s=600)
    plain_s = time.perf_counter() - t0
    reset(kernels)
    real, shapes = fops.paged_prefill_attention, {}

    def spy(q, *args, **kwargs):
        shapes[q.shape[1]] = shapes.get(q.shape[1], 0) + 1
        return real(q, *args, **kwargs)
    fops.paged_prefill_attention = spy
    try:
        eng = ServeEngine(model, params, draft_model=model,
                          draft_params=params, spec_k=SPEC_K, **kw)
        t0 = time.perf_counter()
        res = eng.serve(prompts, timeout_s=600)
        torch.cuda.synchronize()
        spec_s = time.perf_counter() - t0
    finally:
        fops.paged_prefill_attention = real
    check_served_by(kernels, "paged_prefill_attention",
                    "paged_prefill_attention_bf16_bf16_mma", "spec")
    launches = _tally(kernels, acc)
    check(all(r.status == "ok" and len(r.tokens) == FRONT_NEW
              for r in res + plain), "[spec] self-draft run failed")
    check(shapes.get(SPEC_K + 1, 0) > 0
          and launches["paged_decode_attention"] > 0,
          f"[spec] K2 calls by T {shapes}, launches {launches}")
    ls = eng.loop_stats()
    total = sum(len(r.tokens) for r in res)
    same = sum(int((a.tokens == b.tokens).sum()) for a, b in zip(res, plain))
    log(f"[spec] smollm-360m full width, self-draft, spec_k {SPEC_K}, "
        f"greedy, engine direct: {ls['n_spec_rounds']} rounds -> "
        f"{ls['n_spec_tokens']} tokens "
        f"({ls['n_spec_tokens'] / max(1, ls['n_spec_rounds']):.2f} per "
        f"round), accept rate {ls['spec_accept_rate']:.3f}, hist "
        f"{ls['spec_accept_hist']}; {total / spec_s:.1f} tok/s against "
        f"{16 * FRONT_NEW / plain_s:.1f} without speculation (direct, same "
        f"call); tokens equal to the non-spec run {same}/{16 * FRONT_NEW} "
        f"(logged, not gated: bf16 need not be batch-invariant); K2 calls "
        f"by T {dict(sorted(shapes.items()))}; launches "
        f"{ {n: c for n, c in launches.items() if c} }; {card}")
    del eng, res, plain, model, params
    gc.collect()
    torch.cuda.empty_cache()

    out = serve.main(argv + ["--spec-k", str(SPEC_K), "--draft-config",
                             "smollm-360m", "--temperature", "0.8"])
    torch.cuda.synchronize()
    launches = _tally(kernels, acc)
    check(out["n_results"] == 16 and out["total_tokens"] == 16 * FRONT_NEW,
          f"[spec] launcher served {out['n_results']} / "
          f"{out['total_tokens']}")
    check(all(launches[n] > 0 for n in PAGED_KERNELS),
          f"[spec] launcher launches {launches}")
    ls = out["engine"].loop_stats()
    log(f"[spec] launcher, --spec-k {SPEC_K} --draft-config smollm-360m "
        f"(random, seed 1) --temperature 0.8: 16 requests ok, "
        f"{out['total_tokens'] / out['wall_s']:.1f} tok/s, accept rate "
        f"{ls['spec_accept_rate']:.3f}, "
        f"{ls['n_spec_tokens'] / max(1, ls['n_spec_rounds']):.2f} tokens "
        f"per round; launches { {n: c for n, c in launches.items() if c} }")


# -- phase 12 -------------------------------------------------------------------

XLSTM_PLEN, XLSTM_NEW = 128, 16


def _small_prompts(vocab_size: int):
    """Phase 4's six prompt lengths, from its seed."""
    rng = np.random.default_rng(4)
    return [rng.integers(0, vocab_size, n).astype(np.int32)
            for n in (37, 5, 70, 18, 33, 50)]


def phase_xlstm_small(kernels) -> None:
    """Phase 12(a): the 2-layer f32 xLSTM smoke stack (one mLSTM, one
    sLSTM; TF32 off) paged and dense: the card's greedy tokens equal the
    CPU port's.  The blocks are plain torch (the reference has no xLSTM
    kernel), so no attention kernel may launch."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    cfg = get_config("xlstm-350m", smoke=True)
    prompts = _small_prompts(cfg.vocab_size)
    cpu_model = build_model(cfg, device="cpu")
    cpu_params = cpu_model.init(seed=0)
    gpu_model = build_model(cfg, device="cuda")
    gpu_params = bridge.to_torch(cpu_params, "cuda")
    for paged in (True, False):
        kw = dict(batch_size=4, capacity=128, max_new_tokens=8, burst=4,
                  paged=paged)
        if paged:
            kw.update(prefill_chunk=32, block_size=16)
        want = ServeEngine(cpu_model, cpu_params, device="cpu",
                           **kw).serve(prompts)
        reset(kernels)
        eng = ServeEngine(gpu_model, gpu_params, device="cuda", **kw)
        got = eng.serve(prompts)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in kernels}
        tag = f"xlstm-350m smoke (2 layers, d 256, f32), paged={paged}"
        check(eng.paged == paged, f"[xlstm] {tag}: ran paged={eng.paged}")
        for a, b in zip(want, got):
            check(a.status == b.status == "ok",
                  f"[xlstm] {tag} request {b.request_id}: {b.status}")
            check(np.array_equal(a.tokens, b.tokens),
                  f"[xlstm] {tag} request {a.request_id}: cpu {a.tokens} "
                  f"!= cuda {b.tokens}")
        check(not any(launches.values()),
              f"[xlstm] {tag}: a kernel launched on an xLSTM stack: "
              f"{launches}")
        log(f"[xlstm] {tag}: {len(prompts)} requests, greedy tokens on "
            f"cuda == cpu ({sum(len(r.tokens) for r in got)} tokens)")


def xlstm_engine(params=None):
    """Phase 12(b)'s model and engine: xlstm-350m at full width and depth
    (24 layers, 21 mLSTM + 3 sLSTM, bf16; random weights made on the card
    from the generator of seed 0 when ``params`` is None) on the paged
    engine over the default f32 ``cache_dtype`` (the xLSTM carries are
    f32 whatever it is): batch 8, chunk 32, burst 8, one slab per slot.
    Returns (engine, params)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    model = build_model(get_config("xlstm-350m"), device="cuda")
    if params is None:
        params = model.init(seed=0)
    eng = ServeEngine(model, params, batch_size=8,
                      capacity=XLSTM_PLEN + XLSTM_NEW,
                      max_new_tokens=XLSTM_NEW, prefill_chunk=32,
                      block_size=16, burst=8, num_state_slots=8,
                      device="cuda")
    return eng, params


def phase_xlstm(kernels, card: str) -> None:
    """Phase 12(b): xlstm-350m at full width served paged through the
    launcher's pipeline (8 requests of 128 prompt tokens, 16 new), then a
    profiler trace, then the same prompts with request 0 preempted after
    two tokens (its slabs spilled to host) and restored through the batch
    lane: its tokens must equal the unpreempted run's."""
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    eng, params = xlstm_engine()
    torch.cuda.synchronize()
    cfg, model = eng.model.cfg, eng.model
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"[xlstm] {cfg.arch_id} full width: {cfg.n_layers} layers "
        f"{model.period_descs} x {model.n_periods}, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {2 * cfg.d_model // cfg.n_heads}, vocab "
        f"{cfg.vocab_size}, bf16 over an f32 cache_dtype: "
        f"{n_params / 1e9:.3f}B parameters made on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, XLSTM_PLEN).astype(np.int32)
               for _ in range(8)]
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    t0 = time.perf_counter()
    bufs = serve.serve_pipeline(eng, prompts, batch=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    piped = {int(b.meta["request"]): np.asarray(b.data) for b in bufs}
    check(sorted(piped) == list(range(8))
          and all(len(t) == XLSTM_NEW for t in piped.values()),
          f"[xlstm] pipeline: {[(i, len(t)) for i, t in piped.items()]}")
    check(all(int(t.min()) >= 0 and int(t.max()) < cfg.vocab_size
              for t in piped.values()), "[xlstm] token outside the vocab")
    check(not any(launches.values()),
          f"[xlstm] a kernel launched on an xLSTM stack: {launches}")
    total = 8 * XLSTM_NEW
    slabs = [a for st in eng._paged_cache["blocks"].values()
             for a in st.values()]         # (layers, slots + 1, ...) each
    slab_bytes = sum(a[:, 0].numel() * a.element_size() for a in slabs)
    check(all(a.dtype == torch.float32 for a in slabs),
          "[xlstm] a slab is not f32")
    log(f"[xlstm] served 8 requests / {total} tokens through the pipeline "
        f"in {wall:.2f}s = {total / wall:.1f} tok/s; {eng.n_device_steps} "
        f"device steps ({eng.n_prefill_chunks} mixed); slabs "
        f"{slab_bytes / 1e6:.1f} MB per slot x "
        f"{eng.pool_stats()['num_state_slots']} + the dump row; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")
    phase_trace(eng, "xlstm", n=8, prompt_len=XLSTM_PLEN)
    plain = eng.serve(prompts, lane="batch")
    pre, _ = xlstm_engine(params)
    got = serve_scheduled(pre, prompts, decode_rid=0, prefill_rid=None)
    torch.cuda.synchronize()
    check(pre.n_preemptions == pre.n_restores == 1,
          f"[xlstm] preemptions {pre.n_preemptions}, restores "
          f"{pre.n_restores}")
    check(all(r.status == "ok" for r in got), "[xlstm] preempted run failed")
    check(np.array_equal(got[0].tokens, plain[0].tokens),
          f"[xlstm] restored request 0: {got[0].tokens} != unpreempted "
          f"{plain[0].tokens}")
    same = sum(np.array_equal(a.tokens, b.tokens) for a, b in zip(got, plain))
    ps = pre.pool_stats()
    check(ps["n_state_live"] == 0 and ps["n_live"] == 0, f"[xlstm] {ps}")
    log(f"[xlstm] request 0 preempted after 2 tokens (its slabs spilled to "
        f"host), restored through the batch lane: its tokens equal the "
        f"unpreempted run's; {same}/8 requests "
        f"equal; the direct run's tokens equal the pipeline's for "
        f"{sum(np.array_equal(piped[i], plain[i].tokens) for i in range(8))}"
        f"/8")
    del eng, pre
    gc.collect()
    torch.cuda.empty_cache()
    # the launcher's own path: --arch xlstm-350m, default (f32) kv dtype
    out = serve.main(["--arch", "xlstm-350m", "--requests", "8", "--batch",
                      "8", "--prompt-len", str(XLSTM_PLEN), "--max-new",
                      str(XLSTM_NEW), "--device", "cuda"])
    check(out["engine"].paged and out["n_results"] == 8
          and out["total_tokens"] == 8 * XLSTM_NEW,
          f"[xlstm] launcher: paged={out['engine'].paged}, "
          f"{out['n_results']} results / {out['total_tokens']} tokens")
    log(f"[xlstm] launcher --arch xlstm-350m: 8 requests served paged "
        f"through the pipeline, "
        f"{out['total_tokens'] / out['wall_s']:.1f} tok/s")


# -- phase 13 -------------------------------------------------------------------

MLA_PLEN, MLA_NEW = 128, 16
MLA_KERNELS = ("flash_attention", "decode_attention", "gating_topk")


def phase_mla_small(kernels, acc) -> None:
    """Phase 13(a): the deepseek-v3 smoke model (2 layers, f32, q/k head
    48, v head 32, 4 experts; TF32 off) on the dense engine in both MLA
    decode forms: the card's greedy tokens equal the CPU port's (B2, B6,
    and B4 in the expanded form, launched); then the model's decode logits
    in the two forms after one prefill on the card, within the reference's
    own bound (2e-3)."""
    import dataclasses
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    cfg = get_config("deepseek-v3-671b", smoke=True)
    prompts = _small_prompts(cfg.vocab_size)
    cpu_params = build_model(cfg, device="cpu").init(seed=0)
    gpu_params = bridge.to_torch(cpu_params, "cuda")
    kw = dict(batch_size=4, capacity=128, max_new_tokens=8, burst=4)
    for absorb in (False, True):
        want = ServeEngine(build_model(cfg, device="cpu", mla_absorb=absorb),
                           cpu_params, device="cpu", **kw).serve(prompts)
        reset(kernels)
        eng = ServeEngine(build_model(cfg, device="cuda", mla_absorb=absorb),
                          gpu_params, device="cuda", **kw)
        got = eng.serve(prompts)
        torch.cuda.synchronize()
        tag = f"deepseek-v3 smoke (2 layers, f32), mla_absorb={absorb}"
        _check_mla_entries(kernels, cfg, torch.float32, absorb, f"mla {tag}")
        launches = _tally(kernels, acc)
        check(not eng.paged, f"[mla] {tag}: ran paged")
        for a, b in zip(want, got):
            check(a.status == b.status == "ok",
                  f"[mla] {tag} request {b.request_id}: {b.status}")
            check(np.array_equal(a.tokens, b.tokens),
                  f"[mla] {tag} request {a.request_id}: cpu {a.tokens} != "
                  f"cuda {b.tokens}")
        path = ("flash_attention", "gating_topk") + \
            (() if absorb else ("decode_attention",))
        check(all(launches[n] > 0 for n in path)
              and all(launches[n] == 0 for n in ATTN_KERNELS
                      if n not in path),
              f"[mla] {tag}: launches {launches}")
        log(f"[mla] {tag}: {len(prompts)} requests on the dense engine, "
            f"greedy tokens on cuda == cpu; launches "
            f"{ {n: c for n, c in launches.items() if c} }")
    mcfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    tokens = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (4, 40)).astype(np.int32)).to("cuda")
    logits = []
    for absorb in (False, True):
        model = build_model(mcfg, device="cuda", mla_absorb=absorb)
        _, cache = model.prefill(gpu_params, tokens[:, :39], capacity=48,
                                 cache_dtype=torch.float32)
        logits.append(model.decode_step(gpu_params, cache, tokens[:, 39:],
                                        39)[0])
    err = (logits[0] - logits[1]).abs().max().item()
    _tally(kernels, acc)
    check(err < 2e-3, f"[mla] absorbed vs expanded decode logits {err}")
    log(f"[mla] absorbed vs expanded decode logits on the card: max abs "
        f"diff {err:.3e} (the reference's bound 2e-3)")


def _check_mla_entries(kernels, cfg, dtype, absorb: bool, tag: str) -> None:
    """Every B2 (and, expanded, B4) launch since the last reset was of the
    entry the MLA dispatch picks for ``dtype`` operands at ``cfg``'s dims:
    the MLA entries for bf16 at DeepSeek-V3's, the GQA entries over the
    concatenated operands otherwise (the f32 smoke model)."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    m = cfg.mla
    dims = (m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim)
    check_served_by(kernels, "flash_attention",
                    fops.mla_flash_entry((dtype,) * 4, dims), tag)
    if not absorb:
        check_served_by(kernels, "decode_attention",
                        dops.mla_entry((dtype,) * 4, dims), tag)


def mla_engine(absorb: bool, params=None, pkg: str = "repro_torch"):
    """Phase 13(b)'s model and engine: deepseek-v3-671b at full width, cut
    to its 3 dense-prefix layers and 1 MoE layer (plus the MTP leaves;
    bf16, random weights made on the card from seed 0 when ``params`` is
    None), on the dense engine (MLA serves dense only), bf16 latent cache,
    batch 8, burst 8, from the port package importable as ``pkg``
    (kernel_ab.py builds another checkout's the same way).  Returns
    (engine, params)."""
    configs, models, serving = (importlib.import_module(f"{pkg}.{m}")
                                for m in ("configs", "models", "serving"))
    cfg = configs.get_config("deepseek-v3-671b").replace(n_layers=4)
    model = models.build_model(cfg, device="cuda", mla_absorb=absorb)
    if params is None:
        params = model.init(seed=0)
    eng = serving.ServeEngine(model, params, batch_size=8,
                      capacity=MLA_PLEN + MLA_NEW, max_new_tokens=MLA_NEW,
                      burst=8, kv_dtype="bf16", device="cuda")
    return eng, params


def mla_prompts(vocab_size: int):
    """Phase 13(b)'s 8 requests of ``MLA_PLEN`` prompt tokens."""
    rng = np.random.default_rng(13)
    return [rng.integers(0, vocab_size, MLA_PLEN).astype(np.int32)
            for _ in range(8)]


def phase_mla(kernels, card: str):
    """Phase 13(b): deepseek-v3-671b at full width, 4 of its 61 layers, on
    the dense engine: 8 requests of 128 prompt tokens, 16 new, in the
    expanded decode form (B2, B4, B6) and the absorbed one (B2, B6), then
    a profiler trace of the expanded engine, and B2/B4 on layer 0's
    served operands (``phase_mla_served_kernels``).  Returns the launches
    of both runs and the served-operand rows."""
    t0 = time.perf_counter()
    eng, params = mla_engine(False)
    torch.cuda.synchronize()
    cfg, model = eng.model.cfg, eng.model
    n_params = sum(p.numel() for p in _leaves(params))
    m = cfg.mla
    log(f"[mla] {cfg.arch_id} full width, 4 of 61 layers: "
        f"{model.prefix_descs + model.period_descs}, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads (q/k {m.qk_nope_head_dim}+"
        f"{m.qk_rope_head_dim}, v {m.v_head_dim}), q rank {m.q_lora_rank}, "
        f"kv rank {m.kv_lora_rank}, {cfg.moe.n_experts} experts top-"
        f"{cfg.moe.top_k} + {cfg.moe.n_shared} shared, vocab "
        f"{cfg.vocab_size}, MTP leaves {'mtp' in params}, bf16: "
        f"{n_params / 1e9:.2f}B parameters made on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    prompts = mla_prompts(cfg.vocab_size)
    total, runs = {}, {}
    for absorb in (False, True):
        if absorb:
            eng, _ = mla_engine(True, params)
        torch.cuda.reset_peak_memory_stats()
        reset(kernels)
        t0 = time.perf_counter()
        res = eng.serve(prompts, timeout_s=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        for n, c in launches.items():
            total[n] = total.get(n, 0) + c
        tag = f"mla_absorb={absorb}"
        check(not eng.paged, f"[mla] {tag}: ran paged")
        check(all(r.status == "ok" and len(r.tokens) == MLA_NEW
                  and 0 <= int(r.tokens.min())
                  and int(r.tokens.max()) < cfg.vocab_size for r in res),
              f"[mla] {tag}: {[(r.status, len(r.tokens)) for r in res]}")
        path = ("flash_attention", "gating_topk") + \
            (() if absorb else ("decode_attention",))
        check(all(launches[n] > 0 for n in path)
              and all(launches[n] == 0 for n in ATTN_KERNELS
                      if n not in path),
              f"[mla] {tag}: launches {launches}")
        _check_mla_entries(kernels, cfg, torch.bfloat16, absorb, "mla")
        runs[absorb] = res
        n_tok = sum(len(r.tokens) for r in res)
        log(f"[mla] {tag}: served 8 requests / {n_tok} tokens on the dense "
            f"engine in {wall:.2f}s = {n_tok / wall:.1f} tok/s (direct; "
            f"{eng.n_device_steps} decode steps, {eng.n_batches} prefill "
            f"waves); launches { {n: c for n, c in launches.items() if c} }; "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB; {card}")
        if not absorb:
            phase_trace(eng, "mla", n=8, prompt_len=MLA_PLEN)
    same = sum(np.array_equal(a.tokens, b.tokens)
               for a, b in zip(runs[False], runs[True]))
    log(f"[mla] absorbed vs expanded: {same}/8 requests with equal tokens "
        f"(bf16: the two forms round differently)")
    return total, phase_mla_served_kernels(eng.model, params, prompts)


def phase_mla_served_kernels(model, params, prompts) -> dict:
    """B2 and B4 on the operands phase 13(b) gives them, against their
    plain versions with phase 3's MLA tolerances, then timed: layer 0's
    q, k_nope, rope key and V of the 8 served prompts (S = MLA_PLEN,
    causal), and its expanded decode at the first and the last decode
    step's valid slots (MLA_PLEN + 1 and MLA_PLEN + MLA_NEW) over the
    latent cache's rope keys in place, the latents of 16 more random
    tokens after each prompt standing in for the generated ones.  These
    launches are not the main path's (its counts were read).  Returns
    {kernel: row} (the last decode shape's row)."""
    from repro_torch.models import attention as A
    from repro_torch.models.common import make_norm
    cfg, m = model.cfg, model.cfg.mla
    vd, hd = m.v_head_dim, m.qk_nope_head_dim + m.qk_rope_head_dim
    H, S, C = cfg.n_heads, MLA_PLEN, MLA_PLEN + MLA_NEW
    rng = np.random.default_rng(14)
    tokens = torch.from_numpy(np.concatenate(
        [np.stack(prompts), rng.integers(0, cfg.vocab_size, (8, MLA_NEW))],
        1).astype(np.int32)).to("cuda")
    p = params["prefix"][0]
    h = make_norm(cfg.norm)[1](p["norm1"], model._embed(params, tokens))
    pos = torch.arange(C, dtype=torch.int32, device="cuda").expand(8, C)
    q, _, c_kv, k_rope = A._mla_qkv(p["attn"], cfg, h, pos)
    kr_cache = k_rope.reshape(8, C, m.qk_rope_head_dim).contiguous()
    timer = Timer()
    k_nope, v = A._mla_expand_kv(p["attn"], cfg, c_kv[:, :S])
    rows = {"flash_attention": _mla_flash_row(
        timer, q[:, :S].contiguous(), k_nope, kr_cache[:, :S].contiguous(),
        v, f"[mla] served B2 operands: layer 0, B=8 S={S} causal, heads "
        f"{H}/{H} q/k {hd} V {vd} {str(q.dtype)[6:]}",
        PADDED_MLA["served B2"])}
    for n in (S + 1, C):
        k_nope, v = A._mla_expand_kv(p["attn"], cfg, c_kv[:, :n])
        rows["decode_attention"] = dict(n_valid=n, **_mla_decode_row(
            timer, q[:, n - 1].contiguous(), k_nope, kr_cache, v, n,
            f"[mla] served B4 operands: layer 0, B=8, {n} valid of "
            f"capacity {C}, heads {H}/{H} q/k {hd} V {vd} "
            f"{str(q.dtype)[6:]}", PADDED_MLA["served B4"]))
    return rows


# -- phase 14 -------------------------------------------------------------------

FWD_TOL = 1e-3          # x max(1, max|logits|): f32 card vs CPU, TF32 off


def phase_forward_small(kernels, acc) -> None:
    """Phase 14(a): ``apply`` (the full-sequence forward) of phase 4's
    f32 models (the 2-layer smollm-headed stack, and the jamba, deepseek
    and xLSTM smoke stacks) on the card against the CPU port, logits and
    MoE aux loss within ``FWD_TOL`` relative to the largest logit; each
    path's kernels launched and no other attention kernel.  Then
    ``SingleShot(model="smollm-360m:smoke", framework="torch")`` on the
    card against the same on the CPU (its loader draws the weights on the
    CPU, so both hold the same numbers)."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.single import SingleShot
    smollm2 = get_config("smollm-360m").replace(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    cases = [
        ("2-layer f32 smollm heads", smollm2, ("flash_attention",)),
        ("jamba-v0.1 smoke (8 layers, 4 experts)",
         get_config("jamba-v0.1-52b", smoke=True),
         ("flash_attention", "selective_scan", "gating_topk")),
        ("deepseek-v3 smoke (MLA, 4 experts)",
         get_config("deepseek-v3-671b", smoke=True),
         ("flash_attention", "gating_topk")),
        ("xlstm-350m smoke", get_config("xlstm-350m", smoke=True), ())]
    for tag, cfg, path in cases:
        tokens = torch.from_numpy(np.random.default_rng(14).integers(
            0, cfg.vocab_size, (4, 70)).astype(np.int32))
        cpu_model = build_model(cfg, device="cpu")
        cpu_params = cpu_model.init(seed=0)
        want, want_aux = cpu_model.apply(cpu_params, tokens)
        gpu_model = build_model(cfg, device="cuda")
        gpu_params = bridge.to_torch(cpu_params, "cuda")
        reset(kernels)
        with torch.inference_mode():
            got, aux = gpu_model.apply(gpu_params, tokens.to("cuda"))
        torch.cuda.synchronize()
        launches = _tally(kernels, acc)
        err = (got.cpu() - want).abs().max().item()
        tol = FWD_TOL * max(1.0, want.abs().max().item())
        aux_err = abs(aux.item() - want_aux.item())
        check(err <= tol and aux_err <= tol,
              f"[forward] {tag}: logits max_abs_err {err}, aux {aux_err} "
              f"> {tol}")
        check(all(launches[n] > 0 for n in path)
              and all(launches[n] == 0 for n in ATTN_KERNELS
                      if n not in path)
              and (path or not any(launches.values())),
              f"[forward] {tag}: launches {launches}")
        log(f"[forward] {tag}: apply (4, 70) on cuda vs cpu: logits "
            f"max_abs_err {err:.3e}, aux {aux_err:.3e} (tol {tol:.3e}); "
            f"launches { {n: c for n, c in launches.items() if c} }")
    tokens = np.random.default_rng(15).integers(0, 512, (4, 40)).astype(
        np.int32)
    want, _ = SingleShot(model="smollm-360m:smoke", framework="torch",
                         device="cpu").invoke(tokens)
    reset(kernels)
    single = SingleShot(model="smollm-360m:smoke", framework="torch")
    got, _ = single.invoke(tokens)
    launches = _tally(kernels, acc)
    err = float(np.abs(got - want).max())
    tol = FWD_TOL * max(1.0, float(np.abs(want).max()))
    check(err <= tol and launches["flash_attention"] == 2,
          f"[forward] SingleShot smollm-360m:smoke: max_abs_err {err} > "
          f"{tol} or launches {launches}")
    log(f"[forward] SingleShot(model='smollm-360m:smoke', framework='torch') "
        f"cuda vs cpu: logits {got.shape} max_abs_err {err:.3e} (tol "
        f"{tol:.3e}), {single.mean_latency_s * 1e3:.1f} ms a call")


def phase_forward(kernels, acc, card: str) -> None:
    """Phase 14(b): smollm-360m at full width and depth (bf16, random
    weights from seed 0 made on the card): ``apply`` on (8, 512) tokens
    through ``SingleShot(fn=..., framework="torch")`` (numpy in and out);
    B2 through its tensor-core entry, once a layer.  Its last row against
    ``prefill``'s logits on the same tokens: argmax equal on every row
    whose top two logits lie further apart than the two differ (bf16: one
    GEMM over 4096 rows, the other over 8, may round apart)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.single import SingleShot
    cfg = get_config("smollm-360m")
    model = build_model(cfg, device="cuda")
    params = model.init(seed=0)
    tokens = np.random.default_rng(14).integers(
        0, cfg.vocab_size, (8, 512)).astype(np.int32)
    single = SingleShot(fn=lambda t: model.apply(params, t),
                        framework="torch")
    reset(kernels)
    t0 = time.perf_counter()
    logits, aux = single.invoke(tokens)
    wall = time.perf_counter() - t0
    check_served_by(kernels, "flash_attention", "flash_attention_bf16_mma",
                    "forward")
    launches = _tally(kernels, acc)
    check(logits.shape == (8, 512, cfg.vocab_size)
          and np.isfinite(logits).all() and float(aux) == 0.0,
          f"[forward] smollm-360m apply: {logits.shape}, aux {aux}")
    check(launches["flash_attention"] == cfg.n_layers
          and all(launches[n] == 0 for n in ATTN_KERNELS
                  if n != "flash_attention"),
          f"[forward] smollm-360m apply launches {launches}")
    with torch.inference_mode():
        last, _ = model.prefill(params, torch.from_numpy(tokens).to("cuda"),
                                capacity=512, cache_dtype=torch.bfloat16)
    _tally(kernels, acc)
    last = last.float().cpu().numpy()
    row = logits[:, -1]
    err = float(np.abs(last - row).max())
    top2 = np.sort(row, axis=1)[:, -2:]
    same = row.argmax(1) == last.argmax(1)
    check(all(same[r] or top2[r, 1] - top2[r, 0] <= err for r in range(8)),
          f"[forward] apply's last row vs prefill: argmax {row.argmax(1)} "
          f"vs {last.argmax(1)}, max_abs_err {err}")
    log(f"[forward] smollm-360m full width (32 layers, bf16): apply (8, 512) "
        f"through SingleShot(fn=, framework='torch') in {wall * 1e3:.1f} ms "
        f"(numpy in, {logits.nbytes / 2**20:.0f} MiB f32 logits out); B2 "
        f"{launches['flash_attention']} launches, `_mma`; last row vs "
        f"prefill: argmax equal on {int(same.sum())}/8 rows, max_abs_err "
        f"{err:.3e} (bf16 logits up to {float(np.abs(row).max()):.2f}); "
        f"{card}")


# -- phase 15 -------------------------------------------------------------------

WHISPER_PLEN, WHISPER_NEW = 4, 64


def _whisper_frames(cfg, batch: int):
    """Encoder frames (batch, enc_seq, d_model) from numpy seed 0."""
    return (np.random.default_rng(0).standard_normal(
        (batch, cfg.enc_seq, cfg.d_model)) * 0.02).astype(np.float32)


def _trace_generate(eng, prompts, extra, tag: str) -> None:
    """A CUDA trace of one more ``generate_batch`` (a prefill and
    max_new_tokens - 1 decode steps: one device step per new token)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate_batch(prompts, extra_embeds=extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report_trace(prof, wall, eng.max_new_tokens, tag,
                  f"generate_batch of {prompts.shape[0]} x "
                  f"{prompts.shape[1]}-token prompts, "
                  f"{eng.max_new_tokens} new tokens (prefill + "
                  f"{eng.max_new_tokens - 1} decode steps)")


def phase_whisper(kernels, acc, card: str) -> None:
    """Phase 15: whisper-tiny at full width and depth (4 + 4 layers, d
    384, 6 heads, 1500 encoder frames, vocab 51865, bf16, random weights
    from seed 0 made on the card; no cut) on the dense engine:
    ``generate_batch`` of 8 prompts of 4 tokens with (8, 1500, 384) frames
    from numpy seed 0, 64 new tokens.  B2 (``_mma``) launches 3 times a
    layer: the encoder's bidirectional self-attention, the decoder's
    causal one and its cross-attention (no mask); B4 twice a layer and
    decode step (self, and cross over all 1500 slots).  Then the smoke
    config in f32: the card's tokens equal the CPU port's.  Then a trace
    of the full-width run."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    cfg = get_config("whisper-tiny")
    model = build_model(cfg, device="cuda")
    params = model.init(seed=0)
    eng = ServeEngine(model, params, batch_size=8,
                      capacity=WHISPER_PLEN + WHISPER_NEW,
                      max_new_tokens=WHISPER_NEW, kv_dtype="bf16",
                      device="cuda")
    frames = _whisper_frames(cfg, 8)
    prompts = np.random.default_rng(15).integers(
        0, cfg.vocab_size, (8, WHISPER_PLEN)).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    t0 = time.perf_counter()
    gen = eng.generate_batch(prompts, extra_embeds=frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_served_by(kernels, "flash_attention", "flash_attention_bf16_mma",
                    "whisper")
    check_served_by(kernels, "decode_attention", "decode_attention_bf16_bf16",
                    "whisper")
    launches = _tally(kernels, acc)
    L = cfg.n_layers
    check(gen.shape == (8, WHISPER_NEW) and 0 <= int(gen.min())
          and int(gen.max()) < cfg.vocab_size,
          f"[whisper] generated {gen.shape}, range {gen.min()}..{gen.max()}")
    check(launches["flash_attention"] == cfg.n_enc_layers + 2 * L
          and launches["decode_attention"] == 2 * L * (WHISPER_NEW - 1)
          and all(launches[n] == 0 for n in ATTN_KERNELS
                  if n not in DENSE_KERNELS),
          f"[whisper] launches {launches}")
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"[whisper] whisper-tiny full width and depth ({cfg.n_enc_layers} + "
        f"{L} layers, d {cfg.d_model}, {cfg.n_heads} heads, enc_seq "
        f"{cfg.enc_seq}, vocab {cfg.vocab_size}, bf16, "
        f"{n_params / 1e6:.1f}M parameters): generate_batch 8 x "
        f"{WHISPER_PLEN} tokens + (8, {cfg.enc_seq}, {cfg.d_model}) frames, "
        f"{WHISPER_NEW} new: {gen.size / wall:.1f} tok/s ({wall:.2f}s, "
        f"{wall * 1e3 / WHISPER_NEW:.2f} ms per new token); B2 "
        f"{launches['flash_attention']} launches (encoder "
        f"{cfg.n_enc_layers} bidirectional, {L} causal, {L} cross), B4 "
        f"{launches['decode_attention']} ({L} self + {L} cross a step); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{card}")
    scfg = get_config("whisper-tiny", smoke=True)
    cpu_model = build_model(scfg, device="cpu")
    cpu_params = cpu_model.init(seed=0)
    kw = dict(batch_size=4, capacity=WHISPER_PLEN + 16, max_new_tokens=16,
              kv_dtype="f32")
    sframes = _whisper_frames(scfg, 4)
    sprompts = prompts[:4] % scfg.vocab_size
    want = ServeEngine(cpu_model, cpu_params, device="cpu",
                       **kw).generate_batch(sprompts, extra_embeds=sframes)
    reset(kernels)
    got = ServeEngine(build_model(scfg, device="cuda"),
                      bridge.to_torch(cpu_params, "cuda"), device="cuda",
                      **kw).generate_batch(sprompts, extra_embeds=sframes)
    launches = _tally(kernels, acc)
    check(np.array_equal(want, got),
          f"[whisper] smoke f32: cpu {want} != cuda {got}")
    check(launches["flash_attention"] == scfg.n_enc_layers
          + 2 * scfg.n_layers and launches["decode_attention"] > 0,
          f"[whisper] smoke launches {launches}")
    log(f"[whisper] whisper-tiny smoke (2 + 2 layers, d 256, 64 frames, "
        f"f32): generate_batch tokens on cuda == cpu ({got.size} tokens); "
        f"launches { {n: c for n, c in launches.items() if c} }")
    _trace_generate(eng, prompts, frames, "whisper")
    reset(kernels)


# -- phase 16 -------------------------------------------------------------------

VLM_TEXT, VLM_NEW, VLM_LAYERS = 128, 32, 8


def phase_vlm(kernels, acc, card: str) -> None:
    """Phase 16: qwen2-vl-72b at full width (d 8192, 64/8 heads of 128,
    M-RoPE sections (16, 24, 24), d_ff 29568, vocab 152064, bf16) cut to 8
    of its 80 layers (random weights from seed 0 made on the card) on the
    dense engine: ``generate_batch`` of 8 requests of 1024 patch rows
    (``fake_vision_patches`` from a card generator seeded 16) plus 128 text
    tokens, 32 new tokens.  B2 (``_mma``, causal, hd 128) launches once a
    layer, B4 once a layer and decode step.  Then a trace."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, frontends
    from repro_torch.serving import ServeEngine
    t0 = time.perf_counter()
    cfg = get_config("qwen2-vl-72b").replace(n_layers=VLM_LAYERS)
    model = build_model(cfg, device="cuda")
    params = model.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    S = cfg.vision_seq + VLM_TEXT
    eng = ServeEngine(model, params, batch_size=8, capacity=S + VLM_NEW,
                      max_new_tokens=VLM_NEW, kv_dtype="bf16", device="cuda")
    patches = frontends.fake_vision_patches(
        cfg, 8, torch.Generator(device="cuda").manual_seed(16),
        dtype=torch.bfloat16)
    prompts = np.random.default_rng(16).integers(
        0, cfg.vocab_size, (8, S)).astype(np.int32)
    log(f"[vlm] qwen2-vl-72b full width, {VLM_LAYERS} of 80 layers: d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, mrope {cfg.mrope_sections}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, bf16: {n_params / 1e9:.2f}B "
        f"parameters made on the card in {time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    t0 = time.perf_counter()
    gen = eng.generate_batch(prompts, extra_embeds=patches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_served_by(kernels, "flash_attention", "flash_attention_bf16_mma",
                    "vlm")
    check_served_by(kernels, "decode_attention", "decode_attention_bf16_bf16",
                    "vlm")
    launches = _tally(kernels, acc)
    check(gen.shape == (8, VLM_NEW) and 0 <= int(gen.min())
          and int(gen.max()) < cfg.vocab_size,
          f"[vlm] generated {gen.shape}, range {gen.min()}..{gen.max()}")
    check(launches["flash_attention"] == VLM_LAYERS
          and launches["decode_attention"] == VLM_LAYERS * (VLM_NEW - 1)
          and all(launches[n] == 0 for n in ATTN_KERNELS
                  if n not in DENSE_KERNELS),
          f"[vlm] launches {launches}")
    log(f"[vlm] generate_batch 8 x ({cfg.vision_seq} patch rows + "
        f"{VLM_TEXT} text tokens), {VLM_NEW} new: {gen.size / wall:.1f} "
        f"tok/s ({wall:.2f}s, {wall * 1e3 / VLM_NEW:.2f} ms per new token); "
        f"B2 {launches['flash_attention']} launches, B4 "
        f"{launches['decode_attention']}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")
    _trace_generate(eng, prompts, patches, "vlm")
    reset(kernels)


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
    mla_rows = phase_mla_kernels(timer)
    slice_rows = phase_slice_kernels(timer)
    served.update(phase_quant_kernels(timer))
    phase_splits()
    served["fused_transform"] = phase_transform(timer)
    del timer
    phase_engine(kernels)
    launches5, eng, tok_s5 = phase_main_path(kernels)
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
    launches11: dict = {}
    phase_sampling_spec_small(kernels, launches11)
    phase_sampling_spec(kernels, launches11, card, tok_s5)
    gc.collect()
    torch.cuda.empty_cache()
    phase_xlstm_small(kernels)
    phase_xlstm(kernels, card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_mla_small(kernels, {})
    launches13, mla_served = phase_mla(kernels, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches14: dict = {}
    launches15: dict = {}
    launches16: dict = {}
    for tag, run in (("14", lambda: (phase_forward_small(kernels, launches14),
                                     phase_forward(kernels, launches14,
                                                   card))),
                     ("15", lambda: phase_whisper(kernels, launches15, card)),
                     ("16", lambda: phase_vlm(kernels, launches16, card))):
        t0 = time.perf_counter()
        run()
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[phase {tag}] {time.perf_counter() - t0:.1f}s")
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
                 launches_phase11=launches11.get(k.name, 0),
                 launches_phase13=launches13.get(k.name, 0),
                 launches_phase14=launches14.get(k.name, 0),
                 launches_phase15=launches15.get(k.name, 0),
                 launches_phase16=launches16.get(k.name, 0),
                 **served[k.name]) for k in kernels]
    for row in rows:
        if row["name"] in mla_rows:
            row["mla_heads"] = mla_rows[row["name"]]
            row["mla_served"] = mla_served[row["name"]]
        if row["name"] in slice_rows:
            row["slice_shapes"] = slice_rows[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
