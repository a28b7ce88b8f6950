"""Mixture-of-Experts: routed top-k + shared experts (port of
``repro/models/moe.py``).

Routing variants:
  * "softmax"      — softmax over logits, top-k, renormalized (DBRX, Jamba)
  * "sigmoid_bias" — DeepSeek-V3: sigmoid scores, top-k over (score + bias),
                     weights = score/top-sum × routed_scale.

The top-k is the gating kernel (``kernels/moe_gating``) on a CUDA device;
it chooses the experts, and the routing weights are gathered from the
scores at its indices, so training differentiates them on the card.
Dispatch is capacity-based, per sequence (batch row), exactly as the
reference: each expert takes at most C tokens of a row, in token order;
an assignment past its expert's capacity is dropped (it lands in a dump
row).  The reference's per-row ``vmap`` is a batch dimension here.  The
combine adds each token's k weighted expert outputs in the reference's
order j = 0..k-1 through a (B, T, k, d) gather — no atomics, so the
float sum is deterministic — and nothing here syncs with the host.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.moe_gating import ops as gating_ops
from . import sharding
from .common import dense_init
from .config import ModelConfig, MoEConfig
from .mlp import mlp_forward, mlp_params


def moe_params(gen: torch.Generator, cfg: ModelConfig, dtype):
    """The router (and its bias) stay float32 in a model of any type."""
    m = cfg.moe
    d, de = cfg.d_model, m.d_expert
    p = {
        "router": dense_init(gen, (d, m.n_experts), dtype=torch.float32),
        "w_gate": dense_init(gen, (m.n_experts, d, de), in_axis=1, dtype=dtype),
        "w_up": dense_init(gen, (m.n_experts, d, de), in_axis=1, dtype=dtype),
        "w_down": dense_init(gen, (m.n_experts, de, d), in_axis=1, dtype=dtype),
    }
    if m.router == "sigmoid_bias":
        p["router_bias"] = torch.zeros((m.n_experts,), dtype=torch.float32,
                                       device=gen.device)
    if m.n_shared:
        p["shared"] = mlp_params(gen, d, de * m.n_shared, "swiglu", dtype)
    return p


def _topk(scores, k: int):
    """(B, S, E) -> (vals, idx (B, S, k)) through the gating kernel."""
    B, S, E = scores.shape
    vals, idx = gating_ops.gating_topk(scores.reshape(B * S, E).contiguous(), k)
    return vals.reshape(B, S, k), idx.reshape(B, S, k)


def route(p, m: MoEConfig, x):
    """x: (B,S,d) -> weights (B,S,k) in x's type, idx (B,S,k) int32,
    aux_loss scalar."""
    logits = x.float() @ p["router"]                         # (B,S,E)
    if m.router == "sigmoid_bias":
        scores = torch.sigmoid(logits)
        _, idx = _topk(scores + p["router_bias"], m.top_k)
        w = torch.gather(scores, -1, idx.long())
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20) * m.routed_scale
        probs = scores / (scores.sum(-1, keepdim=True) + 1e-20)
    else:
        probs = torch.softmax(logits, dim=-1)
        # the kernel gives the indices; the weights are gathered from probs
        # (the same bits as its values) so that they carry the router's
        # gradient, as jax.lax.top_k's values do
        _, idx = _topk(probs, m.top_k)
        w = torch.gather(probs, -1, idx.long())
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    # switch-style load-balance aux loss (mean over batch rows)
    B, S, k = idx.shape
    me = probs.mean(dim=(0, 1))                              # (E,)
    counts = torch.zeros((m.n_experts,), dtype=torch.float32,
                         device=x.device)
    counts.index_add_(0, idx.reshape(-1).long(),
                      torch.ones((B * S * k,), dtype=torch.float32,
                                 device=x.device))
    ce = counts / (B * S * k)
    aux = m.n_experts * torch.sum(me * ce) * m.aux_loss_coef
    return w.to(x.dtype), idx, aux


def _position_in_expert(flat_idx, E: int):
    """Rank of each assignment within its expert's queue, per row.
    flat_idx: (B, Tk) -> (B, Tk) int32 (a stable sort keeps token order
    inside each expert's queue)."""
    B, Tk = flat_idx.shape
    order = torch.sort(flat_idx, dim=1, stable=True).indices  # (B,Tk)
    sorted_eid = torch.gather(flat_idx, 1, order)
    experts = torch.arange(E, dtype=flat_idx.dtype,
                           device=flat_idx.device).expand(B, E).contiguous()
    group_start = torch.searchsorted(sorted_eid.contiguous(), experts,
                                     side="left")            # (B,E)
    ar = torch.arange(Tk, device=flat_idx.device).expand(B, Tk)
    pos_sorted = ar - torch.gather(group_start, 1, sorted_eid.long())
    return torch.zeros_like(flat_idx).scatter_(
        1, order, pos_sorted.to(flat_idx.dtype))


def _dispatch(x, idx, E: int, C: int):
    """Per-row dispatch.  x: (B,T,d); idx: (B,T,k).  Returns (xe
    (B,E,C,d), slot (B,T*k), keep (B,T*k)).  Assignment j of token t is
    ``t*k + j``; overflow goes to the dump row E*C."""
    B, T, d = x.shape
    k = idx.shape[-1]
    flat_idx = idx.reshape(B, T * k)
    pos = _position_in_expert(flat_idx, E)
    keep = pos < C
    slot = torch.where(keep, flat_idx * C + pos, E * C).long()
    disp = torch.zeros((B, E * C + 1, d), dtype=x.dtype, device=x.device)
    src = x.repeat_interleave(k, dim=1)                      # x[token_of]
    disp.scatter_(1, slot[..., None].expand(B, T * k, d), src)
    return disp[:, : E * C].reshape(B, E, C, d), slot, keep


def _combine(ye, slot, keep, w, T: int):
    """ye: (B,E,C,d) -> y (B,T,d): each token's k weighted expert
    outputs added in order j = 0..k-1 (the reference's scatter-add
    order), dropped assignments contributing zero."""
    B, E, C, d = ye.shape
    k = w.shape[-1]
    ye_flat = torch.cat([ye.reshape(B, E * C, d),
                         torch.zeros((B, 1, d), dtype=ye.dtype,
                                     device=ye.device)], dim=1)
    gather = torch.where(keep, slot, E * C)
    per_slot = torch.gather(ye_flat, 1, gather[..., None].expand(B, T * k, d))
    wf = (w.reshape(B, T * k) * keep).to(per_slot.dtype)
    terms = (per_slot * wf[..., None]).reshape(B, T, k, d)
    y = torch.zeros((B, T, d), dtype=per_slot.dtype, device=ye.device)
    for j in range(k):
        y = y + terms[:, :, j]
    return y


def _expert_ffn(xe, p):
    """swiglu expert FFN batched over (B, E): xe (B,E,C,d) -> (B,E,C,d)."""
    dt = torch.promote_types(xe.dtype, p["w_gate"].dtype)
    xe = xe.to(dt)
    h = F.silu(torch.einsum("becd,edf->becf", xe, p["w_gate"].to(dt)))
    h = h * torch.einsum("becd,edf->becf", xe, p["w_up"].to(dt))
    return torch.einsum("becf,efd->becd", h, p["w_down"].to(dt))


def moe_forward(p, cfg: ModelConfig, x, *,
                capacity_factor: Optional[float] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (y, aux_loss)."""
    m = cfg.moe
    B, S, d = x.shape
    w, idx, aux = route(p, m, x)                             # (B,S,k)
    E, k = m.n_experts, m.top_k
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
    C = int(np.ceil(S * k / E * cf))
    C = max(min(C, S), 1)
    xe, slot, keep = _dispatch(x, idx, E, C)
    if p["w_gate"].shape[0] < E:
        # expert-parallel: this rank runs its experts' rows of the global
        # dispatch (routing and capacity are the whole batch's, so the
        # same assignments drop) and combines a partial the caller sums
        g = sharding.current()
        e0, e1 = sharding.ranges(E, g.size)[g.rank]
        mine = _expert_ffn(xe[:, e0:e1], p)
        ye = mine.new_zeros(xe.shape)
        ye[:, e0:e1] = mine
    else:
        ye = _expert_ffn(xe, p)                              # (B,E,C,d)
    y = _combine(ye, slot, keep, w, S)
    if m.n_shared:
        y = y + mlp_forward(p["shared"], "swiglu", x)
    return y.to(x.dtype), aux
