"""Feed-forward blocks: swiglu / squared-ReLU / gelu."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense_init, mlp_act_fn, mm


def mlp_params(gen: torch.Generator, d_model: int, d_ff: int, act: str,
               dtype):
    if act == "swiglu":
        return {
            "w_gate": dense_init(gen, (d_model, d_ff), dtype=dtype),
            "w_up": dense_init(gen, (d_model, d_ff), dtype=dtype),
            "w_down": dense_init(gen, (d_ff, d_model), dtype=dtype),
        }
    return {
        "w_up": dense_init(gen, (d_model, d_ff), dtype=dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype=dtype),
    }


def mlp_forward(p, act: str, x):
    if act == "swiglu":
        return mm(F.silu(mm(x, p["w_gate"])) * mm(x, p["w_up"]), p["w_down"])
    return mm(mlp_act_fn(act)(mm(x, p["w_up"])), p["w_down"])
