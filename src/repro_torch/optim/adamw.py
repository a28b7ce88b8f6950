"""AdamW (port of ``repro/optim/adamw.py``).  The optimizer state's type
is configurable, so a large model can keep m/v in bf16.

Parameters, gradients and the state are the port's plain trees of
tensors.  The math is the reference's: a global-norm clip in f32 with
the scale cast to each gradient's type, bias correction, decoupled
weight decay on every leaf, each leaf updated in f32 and cast back to
its own and the state's type.  A leaf whose gradient is ``None`` (never
reached by the loss, or behind an integer-valued path such as a
top-k's indices) is updated with a zero gradient, as the reference,
whose gradient there is zero, updates it: its weight still decays."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..tree import tree_leaves, tree_leaves_like, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor        # 0-dim int32, on the parameters' device
    m: Any
    v: Any


def adamw_init(params, state_dtype=None) -> AdamWState:
    """Zero moments of each leaf's shape, in ``state_dtype`` or the
    leaf's own type."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=state_dtype or p.dtype,
                           device=p.device)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 squares (``None`` leaves add
    nothing), leaf sums added in flatten order as the reference's."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads) if g is not None))


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0):
    """Returns (new_params, new_state): new tensors, the inputs are left
    as they are.  ``grads`` has the structure of ``params``, ``None``
    where a leaf has no gradient; ``lr`` a float or a 0-dim tensor."""
    p_leaves = tree_leaves(params)
    g_leaves = [torch.zeros_like(p) if g is None else g
                for p, g in zip(p_leaves, tree_leaves_like(params, grads))]
    step = state.step + 1
    if grad_clip:
        gnorm = global_norm(g_leaves)
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        g_leaves = [g * scale.to(g.dtype) for g in g_leaves]
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(p_leaves, g_leaves, tree_leaves(state.m),
                          tree_leaves(state.v)):
        g32 = g.to(torch.float32)
        m32 = m.to(torch.float32) * b1 + (1 - b1) * g32
        v32 = v.to(torch.float32) * b2 + (1 - b2) * torch.square(g32)
        update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
        update = update + weight_decay * p.to(torch.float32)
        p32 = p.to(torch.float32) - lr * update
        new_p.append(p32.to(p.dtype))
        new_m.append(m32.to(m.dtype))
        new_v.append(v32.to(v.dtype))
    return tree_unflatten(params, new_p), AdamWState(
        step=step, m=tree_unflatten(state.m, new_m),
        v=tree_unflatten(state.v, new_v))
