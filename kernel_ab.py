"""This checkout's selective scan (B5) and top-k gating (B6), its B2/B4
rows at DeepSeek-V3's MLA heads, its B2 backward rows, or its B5
backward rows and jamba training step, against another checkout's, on
one GPU.

    python3 kernel_ab.py OTHER [--jamba | --mla | --backward |
                                --scan-backward]
    python3 kernel_ab.py --decode-splits

OTHER is the root of another checkout of the repository, for example
the parent commit unpacked with ``git archive`` into a directory that
.gitignore lists.  Each tree's kernels are built from its own sources
into its own ``build/kernels/``.  Each row is timed with chip_smoke.py's
Timer (cold L2, device time) four times in turns, other, this, this,
other, and prints the mean of each tree's two readings.  The inputs are
chip_smoke.py phase 3's, with contiguous B/C (an older scan wrapper
takes no split views).  The launch floor (a one-thread kernel) is timed
beside them.

With --jamba, each tree's engine runs chip_smoke.py phase 6 in turn
(its model, engine settings and requests, through chip_smoke.py's own
``jamba_engine`` and ``jamba_prompts``, one set of random bf16 weights
for both), then phase 6's traced serve (``phase_trace``: device busy
share, the scan's and gating's device time and calls, device operations
per device step); last, the operations whose count per device step
differs most between the two trees.

With --mla, the rows are B2 and B4 at the MLA heads instead (128 heads,
q/k 128 + 64, V 128, bf16; random operands from seed 192): B2 causal at
B = 8, S = T = 512 (phase 3's) and 128 (phase 13(b)'s served prompts),
B4 at B = 8 over 576 of 640 slots (phase 3's), 129 and 144 of 144
(the served decode's first and last step) and at B = 2 over 576 of 640
(two splits a (row, head) pair, combined in the launch).  A tree whose
ops have the MLA wrappers (``mla_flash_attention``,
``mla_decode_attention``) gets MLA's own operands: the rope key (B, T,
64) shared by every head, V unpadded.  An older tree gets what its model built for its kernels,
made before the timing: K with the rope key broadcast to every head and
V zero-padded to 192.  Only the kernel calls are timed; the two trees'
outputs (cut to V's head dim) are compared and the largest difference
logged.  Then each tree's engine, built as chip_smoke.py phase 13(b)
builds its expanded form (``mla_engine``, one set of random bf16 weights
for both), serves phase 13(b)'s traced requests (``phase_trace``: device
time by kernel, the operand-building copies, device operations per
step), in turns other, this, this, other, and the operations whose
count per device step differs most are listed.  --jamba's traces run in
the same turns.

With --backward, the rows are B2's backward (B2′) at chip_smoke.py
phase 3's backward shapes (``BACKWARD_CASES``: smollm, jamba, the
128-token window, whisper's encoder, the cross case, the smoke configs'
head dim 48 and nemotron-4-340b's heads (96/8 of 192; a tree without the
tensor-core body at 192 runs its CUDA-core entry there), bf16, and the
f32 rows: smollm's and jamba's heads, the window, whisper's encoder and
the cross case; a tree without the split-TF32 backward runs its
CUDA-core f32 entry there), each tree's ``flash_attention_backward`` on
the same
operands and this tree's forward's out; a tree whose wrapper takes the forward's
logsumexp (``lse=``, the tensor-core body) gets the one its ``*_lse``
entry stores, made before the timing, as its autograd Function saves
it; an older tree recomputes it inside its backward.  Then MLA's heads
on MLA's own operands through each tree's autograd
(``mla_flash_attention`` then ``torch.autograd.grad``), with each
backward's peak memory above what its forward left.  The two trees'
gradients are compared first and the largest difference logged.

With --scan-backward, the rows are B5's backward (B5') at chip_smoke.py
phase 3's ``SCAN_BACKWARD_CASES`` (di 8192, N 16, Bc/Cc split views),
each tree's ``selective_scan_backward`` from the states its own
checkpointing twin stored (made before the timing: the trees may space
them differently); the two trees' gradients are compared first and the
largest difference logged.  Then each tree trains chip_smoke.py phase
17(c)'s jamba period (``jamba_trainer``, the same seed-0 weights and
batches) one step and traces a second, in turns other, this, this,
other: the step's device time, B5''s scan and sum and the twin's, and
the wall time of forward and backward.

With --decode-splits (no OTHER: this tree alone), the rows are the
tensor-core decode body's (K1's ``paged_decode_attention_*_mma`` /
``_tf32`` and B4's ``decode_attention_*``) at chip_smoke.py phase 3's
group sizes (``DECODE_SPLIT_ROWS``: whisper-tiny's, smollm-360m's,
jamba's, qwen2-vl's, nemotron-4-340b's and glm4-9b's heads at their
phase-3 key counts, and nemotron's and glm4's long rows), B = 8, bf16,
and f32 at 544 keys (qwen2-vl's 1183), each launched with n_split from 1
up to four blocks an SM (the split keys whole 16-key tiles); ``*`` marks
the plan ``ops.entry_split_plan`` picks.  Every launch's output is held
against the plain version within chip_smoke.py phase 3's tolerance.
Each plan is timed twice, in the order given and then reversed.

Needs one CUDA device and nvcc, as chip_smoke.py does; the jamba, the
MLA and the scan-backward parts ~30-60 GB of device memory.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def load_tree(root: Path, name: str):
    """The ``repro_torch`` package under ``root/src``, imported as
    ``name`` (its imports are relative, so two trees load side by
    side)."""
    pkg = root / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def kernel_rows(cs, trees):
    """(tag, {tree: callable}) at phase 3's shapes."""
    rows = []
    for B, T, carried in ((8, 1, True), (8, 32, True), (8, 512, False),
                          (1, 512, False)):
        args = cs._scan_case(T + carried + B, B, T, 8192, 16, torch.bfloat16,
                             carried)
        args = args[:2] + (args[2].contiguous(), args[3].contiguous()) \
            + args[4:]
        tag = (f"selective_scan B={B} T={T} bf16 "
               + ("carried" if carried else "cold"))
        rows.append((tag, {n: (lambda s=s, a=args: s.selective_scan(*a))
                           for n, (s, _) in trees.items()}))
    for T, E, k in ((256, 16, 2), (256, 4, 4), (256, 64, 8), (256, 256, 8)):
        gen = torch.Generator(device="cpu").manual_seed(T + E)
        scores = torch.softmax(torch.randn((T, E), generator=gen),
                               dim=-1).to("cuda")
        rows.append((f"gating_topk T={T} E={E} k={k}",
                     {n: (lambda m=m, sc=scores, k=k: m.gating_topk(sc, k))
                      for n, (_, m) in trees.items()}))
    return rows


def _mla_call(flash, decode, q, k_nope, k_rope, v, n_valid=None):
    """One tree's B2 (``n_valid`` None) or B4 call on MLA's operands,
    through its MLA wrapper or, in an older tree, its GQA wrapper over the
    operands its model built (made here, before any timing)."""
    if n_valid is None and hasattr(flash, "mla_flash_attention"):
        return lambda: flash.mla_flash_attention(q, k_nope, k_rope, v)
    if n_valid is not None and hasattr(decode, "mla_decode_attention"):
        return lambda: decode.mla_decode_attention(q, k_nope, k_rope, v,
                                                   n_valid)
    B, T, H, nope = k_nope.shape
    rope, vd = k_rope.shape[-1], v.shape[-1]
    k = torch.cat([k_nope, k_rope[:, :T, None].expand(B, T, H, rope)],
                  dim=-1).contiguous()
    vp = torch.nn.functional.pad(v, (0, nope + rope - vd)).contiguous()
    if n_valid is None:
        return lambda: flash.flash_attention(q, k, vp, causal=True)
    return lambda: decode.decode_attention(q, k, vp, n_valid)


def mla_rows(trees):
    """(tag, {tree: callable}) of B2 and B4 at the MLA heads."""
    gen = torch.Generator(device="cpu").manual_seed(192)

    def rand(*shape):
        return torch.randn(shape, generator=gen).to("cuda", torch.bfloat16)

    H, nope, rope, vd = 128, 128, 64, 128
    rows = []
    for B, S in ((8, 512), (8, 128)):
        args = (rand(B, S, H, nope + rope), rand(B, S, H, nope),
                rand(B, S, rope), rand(B, S, H, vd))
        rows.append((f"B2 MLA B={B} S=T={S} causal",
                     {n: _mla_call(f, d, *args) for n, (f, d) in
                      trees.items()}))
    for B, T, C, n_valid in ((8, 640, 640, 576), (8, 129, 144, 129),
                             (8, 144, 144, 144), (2, 640, 640, 576)):
        args = (rand(B, H, nope + rope), rand(B, T, H, nope),
                rand(B, C, rope), rand(B, T, H, vd))
        rows.append((f"B4 MLA B={B} {n_valid} of {T} slots (latent cache "
                     f"{C})", {n: _mla_call(f, d, *args, n_valid)
                               for n, (f, d) in trees.items()}))
    return rows


def backward_rows(cs, trees):
    """(tag, {tree: callable}) of B2's backward at phase 3's shapes (the
    module's docstring says what each tree is given)."""
    rows = []
    for case in cs.BACKWARD_CASES:
        tag, (q, k, v), _ = cs.backward_case(*case)
        causal, window = case[5], case[6]
        g = torch.Generator(device="cpu").manual_seed(7)
        dout = torch.randn(q.shape, generator=g).to("cuda", q.dtype)
        # this tree's forward out for both (an older tree's forward may
        # refuse the shape: its CUDA-core body at nemotron's G = 12 and 192)
        out = trees["this"].flash_attention(q, k, v, causal=causal,
                                            sliding_window=window)
        fns = {}
        for n, f in trees.items():
            kw = dict(causal=causal, sliding_window=window)
            if hasattr(f, "backward_takes_lse") and f.backward_takes_lse(q, v):
                kw["lse"] = f._flash_forward(q, k, v, causal, window,
                                             lse=True)[1]
            fns[n] = (lambda f=f, out=out, kw=kw, qkv=(q, k, v), do=dout:
                      f.flash_attention_backward(*qkv, out, do, **kw))
        rows.append((tag.split("] ", 1)[1], fns))
    return rows


def mla_backward_row(trees):
    """(tag, {tree: callable}) of the MLA backward through each tree's
    autograd, B = 8, S = T = 512, 128 heads, bf16 (random operands from
    seed 640); each backward's peak memory above its forward's is
    logged."""
    B, S, H, nope, rope, vd = 8, 512, 128, 128, 64, 128
    gen = torch.Generator(device="cpu").manual_seed(640)
    ins = [torch.randn(shape, generator=gen).to("cuda", torch.bfloat16)
           for shape in ((B, S, H, nope + rope), (B, S, H, nope),
                         (B, S, rope), (B, S, H, vd))]
    dout = torch.randn((B, S, H, vd), generator=gen).to("cuda",
                                                        torch.bfloat16)
    fns = {}
    for n, f in trees.items():
        leaves = [t.clone().requires_grad_() for t in ins]
        out = f.mla_flash_attention(*leaves)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.autograd.grad(out, leaves, dout, retain_graph=True)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        print(f"[ab] MLA backward {n}: peak {peak / 2**20:.1f} MiB above "
              f"the forward's", flush=True)
        fns[n] = (lambda o=out, ls=leaves:
                  torch.autograd.grad(o, ls, dout, retain_graph=True))
    return [(f"B2' MLA heads {H} q/k {nope}+{rope} V {vd} B={B} S=T={S} "
             f"causal bf16 (autograd)", fns)]


def scan_backward_rows(cs, trees):
    """(tag, {tree: callable}) of B5' at phase 3's rows, each tree from
    its own twin's states."""
    rows = []
    for B, T, dtype, carried in cs.SCAN_BACKWARD_CASES:
        *ops_in, _ = cs._scan_case(B * T + carried, B, T, 8192, 16, dtype,
                                   carried)
        g = torch.Generator(device="cpu").manual_seed(T + B)
        dy = torch.randn((B, T, 8192), generator=g).to("cuda")
        dh = torch.randn((B, 8192, 16), generator=g).to("cuda") \
            if carried else None
        fns = {}
        for n, s in trees.items():
            states = s.selective_scan_ckpt(*ops_in)[2]
            fns[n] = (lambda s=s, st=states, a=ops_in[:6], dy=dy, dh=dh:
                      s.selective_scan_backward(*a, st, dy, dh))
        rows.append((f"B5' B={B} T={T} {str(dtype)[6:]} "
                     + ("h0 + dh_last" if carried else "h0 = 0"), fns))
    return rows


def trace_train_jamba(cs, pkgs) -> None:
    """Phase 17(c)'s step on each tree in turns other, this, this, other
    (see the module docstring)."""
    from torch.profiler import ProfilerActivity, profile
    lr = cs.JAMBA_TRAIN["lr"]
    for name in ("other", "this", "this", "other"):
        cfg, model, params, leaves, batch = cs.jamba_trainer(pkgs[name])
        _, grads, _ = cs.jamba_train_step(model, params, leaves, batch(),
                                          lr)  # the warm-up step
        del grads
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            loss, grads, fb = cs.jamba_train_step(model, params, leaves,
                                                  batch(), lr)
            del grads
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy, share = cs.train_step_shares(prof)
        print(f"[ab] jamba training step {name}: loss {loss.item():.4f}, "
              f"wall {wall * 1e3:.1f} ms (forward + backward "
              f"{fb * 1e3:.1f}), device {busy:.2f} ms: "
              + ", ".join(f"{n} {ms:.3f} ms" for n, ms in share.items()),
              flush=True)
        del cfg, model, params, leaves, batch, prof
        gc.collect()
        torch.cuda.empty_cache()


# (heads, keys, dtype) of --decode-splits; "int8": B3 over int8 pools
# (paged only), f32 q
DECODE_SPLIT_ROWS = (
    ("whisper", 1500, "bf16"), ("smollm", 544, "bf16"),
    ("jamba", 544, "bf16"), ("qwen2-vl", 1183, "bf16"),
    ("nemotron", 544, "bf16"), ("nemotron", 8192, "bf16"),
    ("glm4", 544, "bf16"), ("glm4", 4160, "bf16"), ("glm4", 8192, "bf16"),
    ("whisper", 544, "f32"), ("smollm", 544, "f32"), ("jamba", 544, "f32"),
    ("qwen2-vl", 1183, "f32"), ("nemotron", 544, "f32"),
    ("glm4", 544, "f32"),
    ("smollm", 544, "int8"), ("jamba", 544, "int8"),
    ("qwen2-vl", 1183, "int8"), ("nemotron", 544, "int8"),
    ("glm4", 544, "int8"), ("glm4", 4160, "int8"), ("glm4", 8192, "int8"))


def decode_split_rows(cs, only: str = "") -> None:
    """The tensor-core decode body's time at each split count of
    ``DECODE_SPLIT_ROWS`` (those of type ``only``, if given), both K1 and
    B4 (B3 alone for int8 rows), each plan's output checked."""
    from repro_torch.kernels.decode_attention import ops as dops
    timer = cs.Timer()
    sms = dops.sm_count(torch.device("cuda"))
    heads_of = dict(cs.GQA_GEOMETRIES)
    B = 8
    for geo, n_keys, dt in DECODE_SPLIT_ROWS:
        if only and dt != only:
            continue
        heads = heads_of[geo]
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32,
                 "int8": torch.float32}[dt]
        kv_dtype = torch.int8 if dt == "int8" else dtype
        KV, hd, G = heads["KV"], heads["hd"], heads["H"] // heads["KV"]
        for paged in (True,) if dt == "int8" else (True, False):
            name = "paged_decode_attention" if paged else "decode_attention"
            args, _, plain, _, _ = cs._gqa_decode_case(
                dops, paged, heads, B, n_keys, dtype, seed=n_keys + G + hd)
            entry = dops.decode_entry(name, dtype, dtype, G, hd)
            if dt == "int8":
                q, kp, vp, pt, lengths = args
                kq, vq, ks, vs = cs._quant_pools(kp, vp)
                args = (q, kq, vq, ks, vs, pt, lengths)
                name, plain = ("paged_decode_attention_quant",
                               dops.paged_decode_attention_quant_plain)
                entry = dops.quant_decode_entry(G, hd)
            max_keys = args[1].shape[1] * args[-2].shape[1] if paged \
                else n_keys
            chosen = dops.entry_split_plan(entry, max_keys, B * KV, kv_dtype,
                                           hd, sms)
            cap = min(4 * sms // (B * KV),
                      -(-max_keys // dops.MMA_KEY_TILE))
            plans = {}
            for n in sorted({1, 2, 3, 4, 6, 8, 12, 16, 24, 32, chosen[0],
                             cap}):
                if n <= cap:
                    plans[dops._whole_tiles(max_keys, n,
                                            dops.MMA_KEY_TILE)] = None
            want = plain(*args)
            tol = cs.TOL[dtype] if paged or dt == "f32" else \
                cs.DENSE_BF16_TOL["decode_attention"]
            runs = {}
            for n_split, split_keys in plans:
                run = (cs._quant_entry_run if dt == "int8"
                       else cs._decode_entry_run)(
                    dops, entry, args, split=(split_keys, n_split))
                got = run()
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                cs.check(err <= tol, f"{name} {geo} {n_keys} keys, "
                         f"{n_split} splits: max_abs_err {err} > {tol}")
                runs[n_split, split_keys] = run
            times = {p: [] for p in runs}
            for p in list(runs) + list(runs)[::-1]:
                times[p].append(timer.ms(runs[p]))
            bound = cs._decode_bound(args[0], kv_dtype, KV, n_keys,
                                     paged)[0]
            for (n_split, split_keys), t in times.items():
                mark = "*" if (n_split, split_keys) == chosen else " "
                print(f"[splits] {name} {geo} heads {heads['H']}/{KV} hd "
                      f"{hd} B={B} {dt} {n_keys} keys{mark} n_split "
                      f"{n_split:3d} x {split_keys:5d} keys "
                      f"({B * KV * n_split} blocks): {sum(t) / len(t):.4f} "
                      f"ms (bound {bound:.5f})", flush=True)


def time_kernels(cs, trees, rows, compare: bool = False) -> None:
    """Each row timed other, this, this, other; with ``compare`` the two
    trees' outputs (each tensor of a tuple), cut to the narrower last
    dim, compared first."""
    timer = cs.Timer()
    floor = [timer.ms(lambda: torch.cuda._sleep(1)) for _ in range(2)]
    print(f"[ab] launch floor (one-thread kernel): "
          f"{sum(floor) / 2:.4f} ms", flush=True)
    for tag, fns in rows:
        if compare:
            outs = [fns[n]() for n in ("this", "other")]
            pairs = (zip(*outs) if isinstance(outs[0], (tuple, list))
                     else [outs])
            diff, rel = 0.0, 0.0
            for a, b in pairs:
                vd = min(a.shape[-1], b.shape[-1])
                d = (a[..., :vd].float() - b[..., :vd].float()).abs().max()
                diff = max(diff, d.item())
                rel = max(rel, d.item() / max(
                    b[..., :vd].float().abs().max().item(), 1e-30))
            print(f"[ab] {tag}: largest |this - other| {diff:.3e} (of one "
                  f"output's largest |other|: at most {rel:.3e})", flush=True)
            del outs
        got = {n: [] for n in fns}
        for n in ("other", "this", "this", "other"):
            got[n].append(timer.ms(fns[n]))
        other, this = (sum(got[n]) / 2 for n in ("other", "this"))
        print(f"[ab] {tag}: other {other:.4f} ms ({got['other'][0]:.4f}, "
              f"{got['other'][1]:.4f}), this {this:.4f} ms "
              f"({got['this'][0]:.4f}, {got['this'][1]:.4f}), "
              f"this/other {this / other:.3f}", flush=True)


def trace_engines(cs, pkgs, make, prompts, tag: str, **trace) -> None:
    """Each tree's engine (``make(pkg, params)`` -> (engine, params), the
    same weights for both) serves ``prompts(vocab)``, then a traced serve
    (``cs.phase_trace``), in turns other, this, this, other (wall time per
    step is the host's and drifts within a call); last, the operations
    whose count per device step differs most between the two trees (their
    first traces)."""
    params, counts = None, {}
    for name in ("other", "this", "this", "other"):
        eng, params = make(pkgs[name], params)
        res = eng.serve(prompts(eng.model.cfg.vocab_size), timeout_s=900)
        cs.check(all(r.status == "ok" for r in res),
                 f"[ab] {name}: {tag} serve failed")
        _, ops, _ = cs.phase_trace(eng, f"ab {tag} {name}", **trace)
        counts.setdefault(name, ops)
        del eng, res
        gc.collect()
        torch.cuda.empty_cache()
    diff = {k: counts["this"].get(k, 0) - counts["other"].get(k, 0)
            for k in set(counts["this"]) | set(counts["other"])}
    for key, d in sorted(diff.items(), key=lambda kv: kv[1])[:12]:
        if d:
            print(f"[ab] {tag} per device step this - other {d:+.1f}  "
                  f"{key[:100]}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, nargs="?",
                    help="root of the other checkout")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--jamba", action="store_true",
                      help="also trace phase 6's jamba period on each tree")
    mode.add_argument("--mla", action="store_true",
                      help="time B2/B4 at the MLA heads instead of B5/B6, "
                      "then trace phase 13(b)'s engine on each tree")
    mode.add_argument("--backward", action="store_true",
                      help="time B2's backward at phase 3's backward rows "
                      "instead of B5/B6")
    mode.add_argument("--scan-backward", action="store_true",
                      help="time B5's backward at phase 3's rows instead "
                      "of B5/B6, then trace phase 17(c)'s step on each "
                      "tree")
    mode.add_argument("--decode-splits", nargs="?", const="all",
                      choices=("all", "bf16", "f32", "int8"),
                      help="time this tree's tensor-core decode body at "
                      "every split count (no OTHER), of one type if given")
    a = ap.parse_args()
    if (a.other is None) != (a.decode_splits is not None):
        ap.error("OTHER is needed, except with --decode-splits")
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    torch.backends.cuda.matmul.allow_tf32 = False
    if a.decode_splits:
        print(f"[ab] {smi.stdout.strip()}", flush=True)
        from repro_torch.kernels.build import load_all
        from repro_torch.kernels.decode_attention import ops as dops
        load_all([dops.KERNEL, dops.DENSE_KERNEL, dops.QUANT_KERNEL])
        decode_split_rows(cs, "" if a.decode_splits == "all"
                          else a.decode_splits)
        return
    print(f"[ab] {smi.stdout.strip()}; other tree {a.other.resolve()}",
          flush=True)
    pkgs = {"this": "repro_torch", "other": "other_repro_torch"}
    import repro_torch  # noqa: F401  (this tree, from ROOT/src)
    load_tree(a.other.resolve(), pkgs["other"])
    from repro_torch.kernels.build import load_all
    if a.backward:
        trees = {n: importlib.import_module(
            f"{p}.kernels.flash_attention.ops") for n, p in pkgs.items()}
        load_all([k for f in trees.values()
                  for k in (f.FLASH_KERNEL, f.BACKWARD_KERNEL)])
        time_kernels(cs, trees, backward_rows(cs, trees)
                     + mla_backward_row(trees), compare=True)
        return
    if a.scan_backward:
        trees = {n: importlib.import_module(f"{p}.kernels.ssm_scan.ops")
                 for n, p in pkgs.items()}
        load_all([k for s in trees.values()
                  for k in (s.KERNEL, s.BACKWARD_KERNEL)])
        time_kernels(cs, trees, scan_backward_rows(cs, trees),
                     compare=True)
        gc.collect()
        torch.cuda.empty_cache()
        trace_train_jamba(cs, pkgs)
        return
    if a.mla:
        trees = {n: tuple(importlib.import_module(f"{p}.kernels.{k}.ops")
                          for k in ("flash_attention", "decode_attention"))
                 for n, p in pkgs.items()}
        load_all([k for f, d in trees.values()
                  for k in (f.FLASH_KERNEL, d.DENSE_KERNEL)])
        time_kernels(cs, trees, mla_rows(trees), compare=True)
        trace_engines(cs, pkgs, lambda pkg, params: cs.mla_engine(
                          False, params, pkg), cs.mla_prompts, "mla",
                      n=8, prompt_len=cs.MLA_PLEN)
        return
    trees = {n: tuple(importlib.import_module(f"{p}.kernels.{k}.ops")
                      for k in ("ssm_scan", "moe_gating"))
             for n, p in pkgs.items()}
    load_all([m.KERNEL for mods in trees.values() for m in mods])
    time_kernels(cs, trees, kernel_rows(cs, trees))
    if a.jamba:
        trace_engines(cs, pkgs, cs.jamba_engine, cs.jamba_prompts, "jamba")


if __name__ == "__main__":
    main()
