"""Serving launcher: continuous batching through the stream pipeline.

Requests are pushed into an appsrc, micro-batched by ``tensor_batcher``
(full batch or ``max_wait_ms``, whichever first), run through the
continuous-batching ServeEngine mounted as a ``tensor_filter``, and
split back into per-request results by ``tensor_unbatcher``.  Weights
are random, drawn from seed 0.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --kv-dtype bf16                              # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --direct                                     # no pipeline
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

from ..configs import ARCH_IDS, get_config
from ..models import build_model
from ..models.config import ModelConfig
from ..serving import ServeEngine

# demo-scale config per serving family (mirrors the reference's
# launcher); the recurrent families are not ported yet
_FAM_BASE = ModelConfig(
    arch_id="fam-demo", family="dense", n_layers=4, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
    norm="rmsnorm", mlp_act="swiglu", rope="rope",
    param_dtype="float32", compute_dtype="float32")
FAMILY_CONFIGS = {"transformer": _FAM_BASE}
_RECURRENT_FAMILIES = ("mamba", "xlstm", "hybrid")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm-360m")
    ap.add_argument("--family",
                    choices=["arch"] + sorted(FAMILY_CONFIGS)
                    + list(_RECURRENT_FAMILIES),
                    default="arch",
                    help="serve a demo model of this family instead of "
                         "--arch (recurrent families: not ported yet)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-wait-ms", type=float, default=50.0)
    ap.add_argument("--direct", action="store_true",
                    help="call engine.serve() directly instead of the pipeline")
    ap.add_argument("--paged", choices=["auto", "on", "off"], default="auto",
                    help="block-paged KV cache (off: not ported yet)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="pool size (default: batch*capacity worth of "
                         "blocks)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt tokens cached per join step")
    ap.add_argument("--share-prefix", choices=["auto", "on", "off"],
                    default="auto",
                    help="map requests' common prompt prefixes onto "
                         "already-resident KV blocks (copy-on-write)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy decode (> 0: not ported yet)")
    ap.add_argument("--shared-prompt", type=int, default=0,
                    help="give every request this many identical leading "
                         "prompt tokens (exercises prefix sharing)")
    ap.add_argument("--listen", type=int, default=None, metavar="PORT",
                    help="serve over TCP (not ported yet)")
    ap.add_argument("--lanes", default="interactive",
                    help="priority lanes (only 'interactive' is ported)")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="tensor-parallel over N devices (not ported yet)")
    ap.add_argument("--retain-cap", type=int, default=None,
                    help="cap on retained (prefix-reusable) free blocks")
    ap.add_argument("--retain-ttl-s", type=float, default=None,
                    help="retire retained blocks older than this many "
                         "seconds")
    ap.add_argument("--kv-dtype", choices=["f32", "bf16", "int8"],
                    default=None,
                    help="KV cache storage precision (default f32; a bf16 "
                         "model needs bf16; int8: not ported yet)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding (not ported yet)")
    ap.add_argument("--burst", type=int, default=8,
                    help="decode burst length K: device steps per host "
                         "drain when no admissions/prefills are pending")
    return ap


def validate_args(args) -> None:
    """Fail fast, before any model work, on values the port rejects."""
    if args.requests < 1:
        raise SystemExit("--requests must be >= 1")
    if args.shared_prompt >= args.prompt_len - 1:
        raise SystemExit("--shared-prompt must be < --prompt-len - 1")
    if args.listen is not None:
        raise NotImplementedError(
            "--listen: the tensor_query front door is not ported yet "
            "(ROADMAP A7a)")
    if args.lanes.replace(" ", "") != "interactive":
        raise NotImplementedError(
            "--lanes: the batch lane and preemption are not ported yet "
            "(ROADMAP A7c)")
    if args.family in _RECURRENT_FAMILIES:
        raise NotImplementedError(
            f"--family {args.family}: recurrent families are not ported yet "
            "(ROADMAP A10)")


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the launcher; returns the engine and the served totals."""
    args = build_parser().parse_args(argv)
    validate_args(args)

    if args.family != "arch":
        cfg = FAMILY_CONFIGS[args.family]
    else:
        cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = cfg.replace(param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg, device=args.device)
    params = model.init(seed=0)
    tri = {"auto": None, "on": True, "off": False}
    engine = ServeEngine(model, params, batch_size=args.batch,
                         capacity=args.prompt_len + args.max_new + 8,
                         max_new_tokens=args.max_new,
                         paged=tri[args.paged],
                         block_size=args.block_size,
                         num_blocks=args.num_blocks,
                         prefill_chunk=args.prefill_chunk,
                         share_prefix=tri[args.share_prefix],
                         burst=args.burst, temperature=args.temperature,
                         mesh=args.mesh, retain_cap=args.retain_cap,
                         retain_ttl_s=args.retain_ttl_s,
                         spec_k=args.spec_k, kv_dtype=args.kv_dtype,
                         device=model.device)

    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, args.shared_prompt).astype(np.int32)
    lengths = [int(rng.integers(max(4, args.shared_prompt + 1),
                                args.prompt_len))
               for _ in range(args.requests)]
    requests = [np.concatenate(
                    [shared, rng.integers(0, cfg.vocab_size,
                                          n - len(shared)).astype(np.int32)])
                for n in lengths]

    t0 = time.perf_counter()
    if args.direct:
        results = engine.serve(requests)
        total_tokens = sum(len(r.tokens) for r in results)
        n_results = len(results)
    else:
        from ..core import parse_pipeline
        pipe = parse_pipeline(
            "appsrc name=req ! tensor_batcher max_batch=%d max_wait_ms=%s ! "
            "queue max_size=8 ! tensor_filter framework=python model=llm "
            "max_batch=%d ! tensor_unbatcher ! tensor_sink name=out keep=true"
            % (args.batch, args.max_wait_ms, args.batch),
            models={"llm": engine.as_pipeline_filter()})
        pipe.start()
        # batcher stacks frames, so pad prompts to a common length up front
        # (left-pad: the engine treats leading zeros as prompt tokens)
        maxlen = max(lengths)
        for i, r in enumerate(requests):
            pipe["req"].push(np.pad(r, (maxlen - len(r), 0)),
                             meta={"request": i, "prompt_len": len(r)})
        pipe["req"].end_of_stream()
        # an element that fails posts to the bus instead of passing EOS on
        deadline = time.monotonic() + 300
        try:
            while not pipe["out"].eos_seen.wait(timeout=0.1):
                pipe.check_bus()
                if time.monotonic() > deadline:
                    raise RuntimeError("pipeline did not drain within 300 s")
            pipe.check_bus()
        finally:
            pipe.stop()
        results = pipe["out"].buffers
        total_tokens = sum(np.asarray(b.data).size for b in results)
        n_results = len(results)
    wall = time.perf_counter() - t0

    print(f"served {n_results} requests / {total_tokens} tokens "
          f"in {wall:.2f}s ({total_tokens / wall:.1f} tok/s) "
          f"on {engine.device}")
    print(f"scheduler: prefills={engine.n_prefills} joins={engine.n_joins} "
          f"evictions={engine.n_evictions} "
          f"prefill_chunks={engine.n_prefill_chunks}")
    ls = engine.loop_stats()
    decoded = max(1, ls["n_device_steps"])
    print(f"decode loop: burst K={ls['burst']}, {ls['n_bursts']} bursts / "
          f"{ls['n_device_steps']} device steps, "
          f"{ls['n_host_syncs']} host syncs "
          f"({ls['n_host_syncs'] / decoded:.2f}/step), "
          f"{ls['n_state_uploads']} state uploads, "
          f"{ls['n_burst_early_exits']} early exits")
    a = engine.allocator
    s = engine.pool_stats()
    print(f"paged cache: {a.num_blocks} blocks x {a.block_size} tokens, "
          f"{s['n_free']} free / {s['n_shared']} shared / "
          f"{s['n_private']} private after drain")
    print(f"kv storage: {s['kv_dtype']}, {s['bytes_per_block']} "
          f"bytes/block, {s['pool_bytes'] / 1e6:.2f} MB pool")
    if engine.share_prefix:
        print(f"prefix sharing: {engine.n_prefix_hits} hits, "
              f"{engine.n_shared_tokens} prompt tokens served from "
              f"resident blocks, {engine.n_cow_forks} COW forks")
    if args.direct:
        for r in results[:3]:
            print(f"  req {r.request_id}: prompt[{len(r.prompt)}] -> "
                  f"{r.tokens[:8]}... latency={r.latency_s:.3f}s")
    else:
        for b in results[:3]:
            print(f"  req {b.meta.get('request')}: "
                  f"prompt_len={b.meta.get('prompt_len')} -> "
                  f"{np.asarray(b.data)[:8]}...")
    return {"engine": engine, "n_results": n_results,
            "total_tokens": total_tokens, "wall_s": wall}


if __name__ == "__main__":
    main()
