"""Training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 30 --batch 8 --seq 512               # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --smoke --device cpu --steps 3 --batch 2 --seq 32

Runs the port's ``Trainer`` on one device: weights drawn from seed 0,
batches from the seeded ``TokenStream``, an encoder-decoder's frames and
a VLM's patches from the modality stubs (seeded generators on the
device) fed as ``extra_embeds``.  ``--smoke`` takes the reduced config in
f32, as the reference.  Without ``--device`` it runs on the GPU and
raises on a host without one.  ``--ckpt-dir`` writes the final
parameters in the reference's checkpoint layout; with ``--resume`` the
run starts from the newest checkpoint there (its parameters: AdamW's
moments and the schedule start afresh, as the layout holds parameters
only) and saves at that step plus ``--steps``.  ``--remat`` checkpoints
each period of the forward, so the backward recomputes it.
"""
from __future__ import annotations

import argparse

import torch

from ..checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..configs import ARCH_IDS, get_config
from ..data import synthetic_batches
from ..models import build_model, frontends
from ..models.common import resolve_device
from ..training import Trainer


def main(argv=None):
    """Train as the flags say; returns the ``Trainer`` (its history and
    state) for callers that drive the launcher in process."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config in f32 (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true",
                    help="start from the newest checkpoint in --ckpt-dir")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each period's forward in the backward")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.resume and not args.ckpt_dir:
        ap.error("--resume needs --ckpt-dir")
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = cfg.replace(param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg, device=device, remat=args.remat)
    start, params = 0, None
    if args.resume and (found := latest_step(args.ckpt_dir)) is not None:
        start = found
        params = restore_checkpoint(args.ckpt_dir, start,
                                    model.init(seed=0))
        print(f"resumed from {args.ckpt_dir} step {start}")
    trainer = Trainer(model, params=params, peak_lr=args.lr,
                      warmup=max(args.steps // 10, 1),
                      total_steps=args.steps)

    extra = None
    gen = torch.Generator(device=device)
    if cfg.family == "audio":
        extra = frontends.fake_audio_frames(cfg, args.batch,
                                            gen.manual_seed(0))
    elif cfg.vision_seq:
        extra = frontends.fake_vision_patches(cfg, args.batch,
                                              gen.manual_seed(1))

    batches = synthetic_batches(cfg.vocab_size, args.seq, args.batch,
                                args.steps, seed=0)
    if extra is not None:
        batches = (dict(b, extra_embeds=extra) for b in batches)

    hist = trainer.fit(batches, steps=args.steps, log_every=args.log_every)
    print(f"final loss: {hist[-1]['loss']:.4f} "
          f"(start {hist[0]['loss']:.4f})")
    if args.ckpt_dir:
        path = save_checkpoint(args.ckpt_dir, start + args.steps,
                               trainer.state.params)
        print(f"checkpoint: {path}")
    return trainer


if __name__ == "__main__":
    main()
