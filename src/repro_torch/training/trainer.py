"""Training loop (port of ``repro/training/trainer.py``): loss ->
gradients -> AdamW, on one device.

Parameters are the port's plain trees of tensors; the float leaves get
``requires_grad_`` and ``torch.autograd.grad`` gives their gradients.
On the card the model's forward runs the hand-written kernels, and
attention is differentiated by B2's backward kernel.  ``make_train_step``
builds the step function; ``Trainer`` runs it over a batch iterator,
reading each step's metrics with one host sync.  The NNTrainer
analogue: on-device training as a first-class citizen of the same
framework (paper, Broader Impact).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..bridge import to_torch
from ..models.common import resolve_device
from ..optim import (AdamWState, adamw_init, adamw_update, cosine_schedule,
                     global_norm)
from ..tree import tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def trainable(params):
    """``params`` with ``requires_grad`` set on every float leaf (the
    leaves themselves, not copies)."""
    for p in tree_leaves(params):
        if p.is_floating_point():
            p.requires_grad_(True)
    return params


def make_train_step(model, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, weight_decay: float = 0.1):
    """(state, batch) -> (state, metrics): the loss and the gradients of
    every float leaf, lr = ``cosine_schedule(step + 1)`` (the first step
    takes a non-zero warmup LR), ``adamw_update``; metrics ``loss``,
    ``lr`` and ``grad_norm`` (f32 0-dim tensors, the norm before the
    clip).  A leaf the loss never reaches gets a ``None`` gradient,
    which AdamW takes as zeros.  The new parameters are new tensors,
    made trainable."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = trainable(state.params)
        leaves = [p for p in tree_leaves(params) if p.is_floating_point()]
        loss = model.loss(params, batch)
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
        grads = tree_map(lambda p: next(grads) if p.is_floating_point()
                         else None, params)
        lr = cosine_schedule(state.opt.step + 1, peak_lr=peak_lr,
                             warmup=warmup, total=total_steps)
        new_params, opt = adamw_update(params, grads, state.opt, lr,
                                       weight_decay=weight_decay)
        metrics = {"loss": loss.detach(), "lr": lr,
                   "grad_norm": global_norm(grads)}
        return TrainState(trainable(new_params), opt), metrics

    return train_step


def _batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


class Trainer:
    """Single-device trainer for the runnable examples.  ``params``:
    initial weights (any tree of arrays or tensors, e.g. the JAX
    package's through the bridge; default ``model.init(seed)``), moved
    to ``device`` (default the model's).  ``opt_state_dtype``: the type
    of AdamW's moments (default each leaf's).  The rest goes to
    ``make_train_step``."""

    def __init__(self, model, *, seed: int = 0, opt_state_dtype=None,
                 device=None, params=None, **opt_kw):
        self.model = model
        self.device = resolve_device(device or model.device)
        params = model.init(seed) if params is None else params
        # detached: training never reaches back into the caller's tensors
        self.params = tree_map(torch.Tensor.detach,
                               to_torch(params, self.device))
        self.opt = adamw_init(self.params, state_dtype=opt_state_dtype)
        self.state = TrainState(self.params, self.opt)
        self._step_fn = make_train_step(model, **opt_kw)
        self.history = []

    def fit(self, batches, steps: int, log_every: int = 10,
            log_fn: Optional[Callable[[str], None]] = print):
        """Run ``steps`` steps over ``batches`` (dicts of numpy arrays or
        tensors); returns the history of per-step metrics (floats, plus
        ``step_time_s``, host time to the step's metrics)."""
        it = iter(batches)
        for i in range(steps):
            batch = _batch_to(next(it), self.device)
            t0 = time.perf_counter()
            self.state, metrics = self._step_fn(self.state, batch)
            # one device-to-host read for all three metrics
            vals = torch.stack([metrics[k].to(torch.float32) for k in
                                ("loss", "lr", "grad_norm")]).tolist()
            metrics = dict(zip(("loss", "lr", "grad_norm"), vals))
            metrics["step_time_s"] = time.perf_counter() - t0
            self.history.append(metrics)
            if log_fn and (i % log_every == 0 or i == steps - 1):
                log_fn(f"step {i:5d} loss={metrics['loss']:.4f} "
                       f"lr={metrics['lr']:.2e} "
                       f"gnorm={metrics['grad_norm']:.3f} "
                       f"dt={metrics['step_time_s']*1e3:.1f}ms")
        self.params = self.state.params
        return self.history
