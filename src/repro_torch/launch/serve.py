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
    PYTHONPATH=src python -m repro_torch.launch.serve --family hybrid \
        --device cpu                  # attention + mamba, state slabs
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-v0.1-52b --smoke --device cpu   # one jamba period
    PYTHONPATH=src python -m repro_torch.launch.serve --family xlstm \
        --device cpu                  # mLSTM/sLSTM blocks, state slabs
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v3-671b --smoke --device cpu  # MLA: dense engine
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen2-vl-72b --smoke --device cpu  # M-RoPE: dense engine
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --paged off                  # the dense engine (contiguous cache)
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --kv-dtype int8              # int8 paged KV (an f32 model)
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --listen 0 --lanes interactive,batch   # over loopback TCP
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --temperature 0.8 --top-k 50 --seed 0  # seeded sampling
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --spec-k 4                   # speculative decoding, tiny draft

With ``--listen PORT`` the engine serves over TCP behind the
tensor-query elements (``serving/net.py``); with ``--smoke`` a loopback
client drives the requests, cycling through ``--lanes``, and the
launcher exits; otherwise it serves until SIGTERM/SIGINT, then drains.
"""
from __future__ import annotations

import argparse
import signal
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..configs import ARCH_IDS, get_config
from ..models import build_model
from ..models.config import ModelConfig, SSMConfig
from ..serving.engine import check_continuous
from ..serving import (LANES, ServeEngine, TensorQueryClient,
                       TensorQueryServer)

# demo-scale config per serving family (mirrors the reference's
# launcher): attention layers page, recurrent layers use state slabs
_FAM_BASE = ModelConfig(
    arch_id="fam-demo", family="dense", n_layers=4, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
    norm="rmsnorm", mlp_act="swiglu", rope="rope",
    param_dtype="float32", compute_dtype="float32")
_FAM_SSM = SSMConfig(d_state=16, d_conv=4, expand=2)
FAMILY_CONFIGS = {
    "transformer": _FAM_BASE,
    "mamba": _FAM_BASE.replace(arch_id="fam-mamba", family="hybrid",
                               ssm=_FAM_SSM, attn_layer_period=1,
                               attn_layer_offset=1),
    "xlstm": _FAM_BASE.replace(arch_id="fam-xlstm", family="ssm", d_ff=0,
                               n_kv_heads=4, rope="none",
                               ssm=SSMConfig(d_state=16, d_conv=4, expand=2,
                                             slstm_every=2)),
    "hybrid": _FAM_BASE.replace(arch_id="fam-hybrid", family="hybrid",
                                ssm=_FAM_SSM, attn_layer_period=2,
                                attn_layer_offset=0),
}
_RECURRENT_FAMILIES = ("mamba", "hybrid", "xlstm")


def _print_spec_stats(engine) -> None:
    ls = engine.loop_stats()
    if "n_spec_rounds" not in ls:
        return
    rounds = max(1, ls["n_spec_rounds"])
    print(f"speculative: K={ls['spec_k']}, {ls['n_spec_rounds']} rounds -> "
          f"{ls['n_spec_tokens']} tokens "
          f"({ls['n_spec_tokens'] / rounds:.2f}/round), accept rate "
          f"{ls['spec_accept_rate']:.2f}, hist {ls['spec_accept_hist']}")


def draft_config(cfg: ModelConfig, name: str, smoke: bool) -> ModelConfig:
    """``--draft-config``: an ``--arch`` id sharing the target's
    vocabulary, or ``tiny``, a shrunken copy of the target (half the
    layers, width and heads; the same head_dim and vocabulary).  Raises
    ``ValueError`` where the tiny copy's query heads do not group over
    its KV heads (smollm-360m's 15/5 heads give 7/5), a draft on which
    the reference fails its first step."""
    if name != "tiny":
        return get_config(name, smoke=smoke)
    dcfg = cfg.replace(
        arch_id=f"{cfg.arch_id}-draft",
        n_layers=max(1, cfg.n_layers // 2),
        d_model=max(2 * cfg.n_heads, cfg.d_model // 2),
        n_heads=max(1, cfg.n_heads // 2),
        n_kv_heads=max(1, min(cfg.n_kv_heads, cfg.n_heads // 2)),
        d_ff=max(4, cfg.d_ff // 2) if cfg.d_ff else cfg.d_ff)
    if dcfg.n_heads % dcfg.n_kv_heads:
        raise ValueError(
            f"--draft-config tiny: the shrunken copy of {cfg.arch_id} has "
            f"{dcfg.n_heads} query heads over {dcfg.n_kv_heads} KV heads, "
            "which do not group; pass --draft-config ARCH (an --arch id "
            "sharing the target's vocabulary, e.g. the target's own)")
    return dcfg


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm-360m")
    ap.add_argument("--family",
                    choices=["arch"] + sorted(FAMILY_CONFIGS),
                    default="arch",
                    help="serve a demo model of this family (transformer/"
                         "mamba/xlstm/hybrid) instead of --arch; recurrent "
                         "families run paged via per-slot state slabs")
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
                    help="block-paged KV cache (auto: on when the model "
                         "supports it; off: the dense engine, one "
                         "contiguous cache per slot)")
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
                    help="0 = greedy decode; > 0 samples from "
                         "softmax(logits / temperature)")
    ap.add_argument("--top-k", type=int, default=None,
                    help="restrict sampling to the k highest logits")
    ap.add_argument("--seed", type=int, default=0,
                    help="sampling PRNG seed (per-request, per-step keys "
                         "are derived from it, the same in either mode)")
    ap.add_argument("--shared-prompt", type=int, default=0,
                    help="give every request this many identical leading "
                         "prompt tokens (exercises prefix sharing)")
    ap.add_argument("--num-state-slots", type=int, default=None,
                    help="recurrent families: state slabs in the pool "
                         "(default: one per batch slot; fewer gates "
                         "admission like a small block pool)")
    ap.add_argument("--listen", type=int, default=None, metavar="PORT",
                    help="serve over TCP via the tensor_query elements "
                         "(0 = ephemeral port).  With --smoke, drives the "
                         "requests through a loopback client and exits; "
                         "otherwise serves until interrupted")
    ap.add_argument("--lanes", default="interactive",
                    help="comma list of priority lanes the smoke client "
                         "cycles through (e.g. 'interactive,batch'; batch "
                         "lane requests are preemptible)")
    ap.add_argument("--max-wait-ms-net", type=float, default=5.0,
                    help="--listen: micro-batch window of the server-side "
                         "tensor_batcher")
    ap.add_argument("--drain-timeout-s", type=float, default=30.0,
                    help="--listen (standing server): on SIGTERM/SIGINT, "
                         "stop admitting and give in-flight requests this "
                         "long to finish before cancelling them; every "
                         "client gets a terminal frame and the process "
                         "exits 0")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="tensor-parallel over N devices (not ported yet, "
                         "ROADMAP A17)")
    ap.add_argument("--retain-cap", type=int, default=None,
                    help="cap on retained (prefix-reusable) free blocks")
    ap.add_argument("--retain-ttl-s", type=float, default=None,
                    help="retire retained blocks older than this many "
                         "seconds")
    ap.add_argument("--kv-dtype", choices=["f32", "bf16", "int8"],
                    default=None,
                    help="KV cache storage precision (default f32; a bf16 "
                         "model with attention or mamba layers needs bf16, "
                         "a bf16 xLSTM serves over f32; int8: paged only, "
                         "an f32 model such as --smoke's)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft tokens proposed and "
                         "verified per burst round (0 = off; paged "
                         "transformer-family targets only: recurrent "
                         "state cannot roll back rejected tokens)")
    ap.add_argument("--draft-config", default=None, metavar="ARCH",
                    help="--spec-k: the draft model, an --arch id sharing "
                         "the target's vocabulary, or 'tiny' for a "
                         "shrunken copy of the target config (the default "
                         "when --spec-k > 0); random weights from seed 1")
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
    bad = [l for l in parse_lanes(args.lanes) if l not in LANES]
    if bad or not parse_lanes(args.lanes):
        raise SystemExit(f"--lanes: unknown or empty lanes {bad}; have "
                         f"{', '.join(LANES)}")
    if args.spec_k > 0:
        if args.mesh is not None:
            raise SystemExit(
                "--spec-k and --mesh are incompatible: speculative "
                "decoding under a device mesh is not implemented")
        if args.share_prefix == "on":
            raise SystemExit(
                "--spec-k and --share-prefix on are incompatible: the "
                "draft pool rides the target's page tables but COW forks "
                "only cover the target pool (leave --share-prefix auto)")
        if args.family in _RECURRENT_FAMILIES:
            raise SystemExit(
                f"--spec-k and --family {args.family} are incompatible: "
                "recurrent state cannot roll back rejected draft tokens")
        if args.paged == "off":
            raise SystemExit(
                "--spec-k and --paged off are incompatible: speculative "
                "rollback is arithmetic on the paged per-slot lengths")
    if args.kv_dtype == "int8":
        if args.paged == "off":
            raise SystemExit(
                "--kv-dtype int8 and --paged off are incompatible: "
                "quantized KV lives in the paged block pool")
        if args.spec_k > 0:
            raise SystemExit(
                "--kv-dtype int8 and --spec-k are incompatible: the "
                "draft/verify path is not quantization-aware")
        if args.mesh is not None:
            raise SystemExit(
                "--kv-dtype int8 and --mesh are incompatible: the scale "
                "pools have no sharding specs yet")


def parse_lanes(text: str) -> List[str]:
    return [l.strip() for l in text.split(",") if l.strip()]


def make_requests(vocab_size: int, n: int, prompt_len: int,
                  shared_prompt: int = 0) -> List[np.ndarray]:
    """``n`` random prompts of 4 .. ``prompt_len`` - 1 tokens (the first
    ``shared_prompt`` tokens common to all), drawn from seed 0."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab_size, shared_prompt).astype(np.int32)
    lengths = [int(rng.integers(max(4, shared_prompt + 1), prompt_len))
               for _ in range(n)]
    return [np.concatenate(
                [shared, rng.integers(0, vocab_size,
                                      m - len(shared)).astype(np.int32)])
            for m in lengths]


def serve_pipeline(engine: ServeEngine, requests: List[np.ndarray], *,
                   batch: int, max_wait_ms: float = 50.0):
    """Serve ``requests`` through ``appsrc ! tensor_batcher ! queue !
    tensor_filter ! tensor_unbatcher ! tensor_sink`` with the engine as
    the filter; returns the sink's buffers (one per request, its tokens
    as data and ``meta["request"]`` its index).  Raises if the pipeline
    has not drained within 300 s."""
    from ..core import parse_pipeline
    pipe = parse_pipeline(
        "appsrc name=req ! tensor_batcher max_batch=%d max_wait_ms=%s ! "
        "queue max_size=8 ! tensor_filter framework=python model=llm "
        "max_batch=%d ! tensor_unbatcher ! tensor_sink name=out keep=true"
        % (batch, max_wait_ms, batch),
        models={"llm": engine.as_pipeline_filter()})
    pipe.start()
    # batcher stacks frames, so pad prompts to a common length up front
    # (left-pad: the engine treats leading zeros as prompt tokens)
    maxlen = max(len(r) for r in requests)
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
    return pipe["out"].buffers


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
    dcfg = None
    if args.spec_k > 0:
        # before any weights are made: the tiny draft may be refused
        dcfg = draft_config(cfg, args.draft_config or "tiny", args.smoke)
        if args.smoke:
            dcfg = dcfg.replace(param_dtype="float32",
                                compute_dtype="float32")
    model = build_model(cfg, device=args.device)
    check_continuous(model)
    params = model.init(seed=0)
    draft_model = draft_params = None
    if dcfg is not None:
        draft_model = build_model(dcfg, device=args.device)
        draft_params = draft_model.init(seed=1)
        print(f"speculative decoding: K={args.spec_k}, draft "
              f"{dcfg.arch_id} ({dcfg.n_layers}L d{dcfg.d_model})")
    tri = {"auto": None, "on": True, "off": False}
    engine = ServeEngine(model, params, batch_size=args.batch,
                         capacity=args.prompt_len + args.max_new + 8,
                         max_new_tokens=args.max_new,
                         paged=tri[args.paged],
                         block_size=args.block_size,
                         num_blocks=args.num_blocks,
                         prefill_chunk=args.prefill_chunk,
                         share_prefix=tri[args.share_prefix],
                         num_state_slots=args.num_state_slots,
                         burst=args.burst, temperature=args.temperature,
                         top_k=args.top_k, seed=args.seed,
                         mesh=args.mesh, retain_cap=args.retain_cap,
                         retain_ttl_s=args.retain_ttl_s,
                         draft_model=draft_model, draft_params=draft_params,
                         spec_k=args.spec_k, kv_dtype=args.kv_dtype,
                         device=model.device)

    requests = make_requests(cfg.vocab_size, args.requests, args.prompt_len,
                             args.shared_prompt)
    if args.listen is not None:
        return serve_listen(engine, requests, args)

    t0 = time.perf_counter()
    if args.direct:
        results = engine.serve(requests)
        total_tokens = sum(len(r.tokens) for r in results)
    else:
        results = serve_pipeline(engine, requests, batch=args.batch,
                                 max_wait_ms=args.max_wait_ms)
        total_tokens = sum(np.asarray(b.data).size for b in results)
    n_results = len(results)
    wall = time.perf_counter() - t0

    print(f"served {n_results} requests / {total_tokens} tokens "
          f"in {wall:.2f}s ({total_tokens / wall:.1f} tok/s) "
          f"on {engine.device}")
    print(f"scheduler: prefills={engine.n_prefills} joins={engine.n_joins} "
          f"evictions={engine.n_evictions}"
          + (f" prefill_chunks={engine.n_prefill_chunks}" if engine.paged
             else ""))
    ls = engine.loop_stats()
    decoded = max(1, ls["n_device_steps"])
    print(f"decode loop: burst K={ls['burst']}, {ls['n_bursts']} bursts / "
          f"{ls['n_device_steps']} device steps, "
          f"{ls['n_host_syncs']} host syncs "
          f"({ls['n_host_syncs'] / decoded:.2f}/step) + "
          f"{ls['n_flag_reads']} reads of the active flags, "
          f"{ls['n_state_uploads']} state uploads, "
          f"{ls['n_burst_early_exits']} early exits")
    _print_spec_stats(engine)
    if engine.paged:
        a = engine.allocator
        s = engine.pool_stats()
        print(f"paged cache: {a.num_blocks} blocks x {a.block_size} tokens, "
              f"{s['n_free']} free / {s['n_shared']} shared / "
              f"{s['n_private']} private after drain")
        print(f"kv storage: {s['kv_dtype']}, {s['bytes_per_block']} "
              f"bytes/block, {s['pool_bytes'] / 1e6:.2f} MB pool")
        if engine.state_store is not None:
            print(f"state slabs: {s['num_state_slots']} slots, "
                  f"{s['n_state_free']} free / {s['n_state_live']} live "
                  f"after drain")
        if engine.share_prefix:
            print(f"prefix sharing: {engine.n_prefix_hits} hits, "
                  f"{engine.n_shared_tokens} prompt tokens served from "
                  f"resident blocks, {engine.n_cow_forks} COW forks")
    else:
        print(f"dense cache: {engine.batch_size} slots x {engine.capacity} "
              f"positions, final position {engine._pos}, "
              f"{engine.n_batches} prefill waves")
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


def serve_listen(engine: ServeEngine, requests: List[np.ndarray],
                 args) -> Dict[str, Any]:
    """``--listen``: serve the engine over TCP.  A standing server (no
    ``--smoke``) runs until SIGTERM/SIGINT, then drains: it stops
    admitting, gives in-flight requests ``--drain-timeout-s`` to finish
    and cancels the rest, so every client holds a terminal frame.  With
    ``--smoke`` a loopback client submits ``requests``, cycling through
    ``--lanes``, waits for each result (300 s at most) and prints them."""
    lanes = parse_lanes(args.lanes)
    server = TensorQueryServer(engine, port=args.listen,
                               max_wait_ms=args.max_wait_ms_net,
                               pad_to=args.prompt_len).start()
    print(f"tensor_query server listening on 127.0.0.1:{server.port} "
          f"(lanes: {', '.join(lanes)})", flush=True)
    out: Dict[str, Any] = {"engine": engine, "port": server.port}
    try:
        if not args.smoke:
            stop = threading.Event()

            def on_signal(signum, frame):
                del frame
                print(f"signal {signum}: draining (timeout "
                      f"{args.drain_timeout_s:.0f}s)", flush=True)
                stop.set()
            signal.signal(signal.SIGTERM, on_signal)
            signal.signal(signal.SIGINT, on_signal)
            while not stop.wait(timeout=0.2):
                pass
            clean = server.drain(timeout=args.drain_timeout_s)
            print("drain complete" if clean
                  else "drain timed out: remaining requests cancelled",
                  flush=True)
            out["drained"] = clean
            return out
        t0 = time.perf_counter()
        client = TensorQueryClient("127.0.0.1", server.port)
        try:
            qids = [client.submit(r, lane=lanes[i % len(lanes)])
                    for i, r in enumerate(requests)]
            results = [client.result(q, timeout=300) for q in qids]
        finally:
            client.close()
        wall = time.perf_counter() - t0
        total = sum(len(r.tokens) for r in results if r.tokens is not None)
        print(f"served {len(results)} requests / {total} tokens over TCP "
              f"in {wall:.2f}s ({total / wall:.1f} tok/s) on "
              f"{engine.device}")
        for r in results[:3]:
            print(f"  qid {r.qid} ({r.lane}): status={r.status} "
                  f"ttft={r.ttft_s:.3f}s tokens={r.tokens[:8].tolist()}...")
        print(f"scheduler: prefills={engine.n_prefills} "
              f"joins={engine.n_joins} evictions={engine.n_evictions} "
              f"preemptions={engine.n_preemptions} "
              f"restores={engine.n_restores} expired={engine.n_expired}")
        _print_spec_stats(engine)
        out.update(n_results=len(results), total_tokens=total, wall_s=wall,
                   results=results)
        return out
    finally:
        server.stop()


if __name__ == "__main__":
    main()
