"""Shared layers: norms, rotary embeddings, activations, init helpers.

Params are plain nested dicts of tensors, as in the JAX package, so the
weight bridge maps leaf to leaf.  Functions take and return tensors on
whatever device their inputs lie on.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another.  Without a GPU and without an explicit device this
    raises rather than falling back to the CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: pass device='cpu' (--device cpu) "
                "to run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's type promotion (bf16 @ f32 computes in f32);
    torch refuses mixed-dtype matmuls."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


# -- initializers -----------------------------------------------------------

def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32):
    """Truncated normal in [-2, 2] scaled by 1/sqrt(fan_in), drawn on the
    generator's device."""
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * (1.0 / np.sqrt(shape[in_axis]))).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32):
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return (w.normal_(generator=gen) * 0.02).to(dtype)


# -- norms --------------------------------------------------------------------

def rmsnorm_params(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(x.dtype)


def layernorm_params(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params, x, eps: float = 1e-5):
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    out = out * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


def make_norm(kind: str):
    if kind == "rmsnorm":
        return rmsnorm_params, rmsnorm
    if kind == "layernorm":
        return layernorm_params, layernorm
    raise ValueError(kind)


# -- rotary ----------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def rope_freqs(head_dim: int, theta: float, rope_pct: float = 1.0,
               device: Optional[torch.device] = None):
    """Inverse frequencies for the rotated fraction of head_dim (cached
    per device: the table is read-only)."""
    rot = int(head_dim * rope_pct)
    rot -= rot % 2
    inv = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float64) / rot))
    return torch.tensor(inv, dtype=torch.float32, device=device), rot


def apply_rope(x, positions, theta: float, rope_pct: float = 1.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int32."""
    inv, rot = rope_freqs(x.shape[-1], theta, rope_pct, x.device)
    if rot == 0:
        return x
    ang = positions[..., :, None].float() * inv      # (..., seq, rot/2)
    cos = torch.cos(ang)[..., :, None, :]            # (..., seq, 1, rot/2)
    sin = torch.sin(ang)[..., :, None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape)
    return torch.cat([y.to(x.dtype), x_pass], dim=-1)


def apply_mrope(x, positions3, theta: float, sections):
    """Qwen2-VL M-RoPE [arXiv:2409.12191].  x: (..., seq, heads,
    head_dim); positions3: (3, ..., seq), the temporal, height and width
    position streams.  The head_dim/2 frequency bands are cut into three
    ``sections`` (summing to head_dim/2), each rotated by its own stream;
    the angles are summed over one-hot weights in f32 as the reference
    does."""
    hd = x.shape[-1]
    half = hd // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to "
                         f"head_dim/2 = {half}")
    inv = 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    inv = torch.tensor(inv, dtype=torch.float32, device=x.device)
    sec_id = np.concatenate([np.full((s,), i) for i, s in enumerate(sections)])
    onehot = torch.tensor(np.eye(3)[sec_id].T, dtype=torch.float32,
                          device=x.device)                  # (3, half)
    ang_all = positions3.float()[..., :, None] * inv        # (3,..., seq, half)
    bshape = (3,) + (1,) * (ang_all.dim() - 2) + (half,)
    ang = (ang_all * onehot.reshape(bshape)).sum(dim=0)     # (..., seq, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


# -- activations -------------------------------------------------------------------

def relu2(x):
    r = F.relu(x)
    return r * r


def mlp_act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"relu2": relu2,
            "gelu": functools.partial(F.gelu, approximate="tanh"),
            "silu": F.silu}[name]
