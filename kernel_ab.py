"""This checkout's selective scan (B5) and top-k gating (B6) against
another checkout's, on one GPU.

    python3 kernel_ab.py OTHER [--jamba]

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
differs most between the two trees.  Needs one CUDA device
and nvcc, as chip_smoke.py does; the jamba part ~30 GB of device memory.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import subprocess
import sys
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


def time_kernels(cs, trees) -> None:
    timer = cs.Timer()
    floor = [timer.ms(lambda: torch.cuda._sleep(1)) for _ in range(2)]
    print(f"[ab] launch floor (one-thread kernel): "
          f"{sum(floor) / 2:.4f} ms", flush=True)
    for tag, fns in kernel_rows(cs, trees):
        got = {n: [] for n in fns}
        for n in ("other", "this", "this", "other"):
            got[n].append(timer.ms(fns[n]))
        other, this = (sum(got[n]) / 2 for n in ("other", "this"))
        print(f"[ab] {tag}: other {other:.4f} ms ({got['other'][0]:.4f}, "
              f"{got['other'][1]:.4f}), this {this:.4f} ms "
              f"({got['this'][0]:.4f}, {got['this'][1]:.4f}), "
              f"this/other {this / other:.3f}", flush=True)


def trace_jamba(cs, pkgs) -> None:
    """Each tree's engine, built as chip_smoke.py phase 6 builds it
    (``cs.jamba_engine``, the same weights for both), serves phase 6's
    16 requests, then phase 6's traced serve (``cs.phase_trace``)."""
    params, counts = None, {}
    for name in ("other", "this"):
        eng, params = cs.jamba_engine(pkgs[name], params)
        res = eng.serve(cs.jamba_prompts(eng.model.cfg.vocab_size),
                        timeout_s=900)
        cs.check(all(r.status == "ok" for r in res),
                 f"[ab] {name}: jamba serve failed")
        _, counts[name] = cs.phase_trace(eng, f"ab jamba {name}")
        del eng, res
        gc.collect()
        torch.cuda.empty_cache()
    diff = {k: counts["this"].get(k, 0) - counts["other"].get(k, 0)
            for k in set(counts["this"]) | set(counts["other"])}
    for key, d in sorted(diff.items(), key=lambda kv: kv[1])[:12]:
        if d:
            print(f"[ab] jamba per device step this - other {d:+.1f}  "
                  f"{key[:100]}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--jamba", action="store_true",
                    help="also trace phase 6's jamba period on each tree")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"[ab] {smi.stdout.strip()}; other tree {a.other.resolve()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    pkgs = {"this": "repro_torch", "other": "other_repro_torch"}
    import repro_torch  # noqa: F401  (this tree, from ROOT/src)
    load_tree(a.other.resolve(), pkgs["other"])
    trees = {n: tuple(importlib.import_module(f"{p}.kernels.{k}.ops")
                      for k in ("ssm_scan", "moe_gating"))
             for n, p in pkgs.items()}
    from repro_torch.kernels.build import load_all
    load_all([m.KERNEL for mods in trees.values() for m in mods])
    time_kernels(cs, trees)
    if a.jamba:
        trace_jamba(cs, pkgs)


if __name__ == "__main__":
    main()
