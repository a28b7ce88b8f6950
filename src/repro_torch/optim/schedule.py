"""LR schedules (port of ``repro/optim/schedule.py``): pure functions of
the step, computed in f32 in the reference's order of operations."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total: int = 10_000, floor: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor * peak_lr`` at ``total``.  ``step``: an int or a
    tensor; returns a 0-dim (or step-shaped) f32 tensor on step's
    device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    # the f32 angle's cosine rounded from f64: within an ulp of XLA's
    # (the C library's cosf), where torch's f32 cosine strays further
    c = torch.cos((math.pi * t).double()).float()
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + c))
    return torch.where(step < warmup, warm, cos)
