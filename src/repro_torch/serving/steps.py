"""Serving step functions: the greedy sampler, the dense prefill step
and the megasteps of both engine modes (port of the greedy subset of
``repro/serving/steps.py``).

A **megastep** is one whole engine tick: model step + sampler +
token/length/step/done-flag update, operating on a dict of device
tensors the engine does not rebuild from the host between steps (see
``DeviceSlotState`` in ``kv_cache.py``).  The *burst* runs up to
``k_max`` decode megasteps per host round-trip with an all-done
early-out, writing sampled tokens into a ``(k_static, B)`` ring buffer
the host drains once per burst.  K = 1 and K = 8 run the same step
body, so burst output equals single-stepping.  The reference traces the
loop into one ``lax.while_loop``; here it is an eager Python loop
(capturing it in a CUDA graph is later work).

Slot-state dict contract (all tensors on the engine's device):

  ``tokens (B,) int32``      last sampled token per slot (next decode input)
  ``rids (B,) int32``        request id per slot
  ``steps (B,) int32``       tokens generated so far per slot
  ``active (B,) bool``       slot is decoding (not idle / prefilling / done)
  paged only:
  ``page_table (B,P) int32`` logical page -> physical block per slot
  ``lengths (B,) int32``     tokens cached per slot (true position)
  ``state_slots (B,) int32`` recurrent state slab per slot
"""
from __future__ import annotations

import torch


def greedy_sample(logits):
    """(B, V) -> (B,) int32 argmax, ties to the lowest index (as
    ``jnp.argmax``)."""
    mx = logits.max(dim=-1, keepdim=True).values
    idx = torch.arange(logits.shape[-1], device=logits.device)
    first = torch.where(logits == mx, idx, logits.shape[-1]).min(dim=-1).values
    return first.to(torch.int32)


def make_prefill_step(model, capacity: int, cache_dtype=torch.bfloat16):
    def prefill_step(params, tokens, extra_embeds=None):
        return model.prefill(params, tokens, capacity=capacity,
                             extra_embeds=extra_embeds,
                             cache_dtype=cache_dtype)
    return prefill_step


def _advance(st, nxt, emit, t_valid, *, eos, max_new, capacity=None):
    """Shared slot-state transition: fold one step's sampled tokens into
    the state dict.  ``emit`` marks rows that produce a token this step
    (decoding rows, or rows whose prefill completes); ``t_valid`` is how
    many cache positions each row consumed.  The done rule — eos hit,
    ``max_new`` generated, or (paged) the cache strip exhausted — is
    evaluated on the device so the host never has to sync to learn a
    slot finished; the host replays the identical rule on the drained
    tokens to keep its mirror coherent."""
    steps = st["steps"] + emit.to(torch.int32)
    done = (nxt == eos) | (steps >= max_new)
    new = dict(st, tokens=torch.where(emit, nxt, st["tokens"]), steps=steps)
    if "lengths" in st:
        new["lengths"] = st["lengths"] + t_valid
        if capacity is not None:
            done = done | (new["lengths"] >= capacity)
    new["active"] = (st["active"] | emit) & ~(emit & done)
    return new


def make_paged_mixed_step(model, *, eos_id, max_new, capacity):
    """Tick for mixed prefill+decode phases: ``tokens (B,T)`` /
    ``t_valid`` / ``emit`` are host-built (prompt chunks are host data),
    everything else lives in the state dict."""
    eos = -1 if eos_id is None else int(eos_id)

    def mixed_step(params, cache, st, tokens, t_valid, emit):
        logits, cache = model.paged_step(
            params, cache, tokens, st["page_table"], st["lengths"], t_valid,
            st["state_slots"])
        nxt = greedy_sample(logits)
        st = _advance(st, nxt, emit, t_valid, eos=eos, max_new=max_new,
                      capacity=capacity)
        return cache, st, nxt, logits
    return mixed_step


def make_paged_burst(model, *, eos_id, max_new, capacity, k_static: int,
                     trace: bool = False):
    """Decode burst through the paged cache: up to ``k_max`` (paged_step
    + sample + state update) iterations per host round-trip, stopping
    early once no slot is active.  The host must have pre-extended every
    active slot's page table to cover ``lengths + k_max`` writes and
    COW-forked any shared block in that range before calling.

    Output contract: see ``_run_burst``."""
    eos = -1 if eos_id is None else int(eos_id)

    def burst(params, cache, st, k_max: int):
        def body_step(st, cache, i, emit):
            t_valid = emit.to(torch.int32)
            logits, cache = model.paged_step(
                params, cache, st["tokens"][:, None], st["page_table"],
                st["lengths"], t_valid, st["state_slots"])
            nxt = greedy_sample(logits)
            st = _advance(st, nxt, emit, t_valid, eos=eos, max_new=max_new,
                          capacity=capacity)
            return st, cache, nxt, logits

        return _run_burst(cache, st, k_max, k_static, body_step, trace)
    return burst


def make_dense_burst(model, *, eos_id, max_new, k_static: int,
                     trace: bool = False):
    """Dense-cache decode burst: all slots share one position ``pos``, a
    host int; step ``i`` decodes at ``pos + i``, so each layer's cache
    update is a slice write at a host index — no index tensor, no
    boolean filter, no host sync inside the step (between steps the
    loop's early-out reads the active flags).  The host advances its
    ``pos`` by the steps the loop ran and caps ``k_max`` at ``capacity -
    pos`` so the loop never writes past the cache strip.  Output
    contract: see ``_run_burst``."""
    eos = -1 if eos_id is None else int(eos_id)

    def burst(params, cache, st, pos: int, k_max: int):
        def body_step(st, cache, i, emit):
            logits, cache = model.decode_step(params, cache,
                                              st["tokens"][:, None], pos + i)
            nxt = greedy_sample(logits)
            st = _advance(st, nxt, emit, emit.to(torch.int32), eos=eos,
                          max_new=max_new)
            return st, cache, nxt, logits

        return _run_burst(cache, st, k_max, k_static, body_step, trace)
    return burst


def _run_burst(cache, st, k_max: int, k_static: int, body_step,
               trace: bool = False):
    """Shared burst loop: run ``body_step(st, cache, i, emit) -> (st,
    cache, nxt, logits)`` up to ``k_max`` times, stopping early once no
    slot is active, ring-buffering (token, valid) per step.  The early-out
    reads the ``active`` flags back to the host before every step, and
    each read blocks until the previous step has run (the reference's
    ``lax.while_loop`` tests them on the device).

    Returns ``(cache, st, tok_buf, val_buf, n_flag_reads, logit_buf)``:
    ``tok_buf[k, b]`` is slot ``b``'s token from burst step ``k`` (-1 and
    ``val_buf`` False where the slot emitted nothing); ``n_flag_reads``
    counts those blocking reads; ``logit_buf`` (``trace`` only, else
    None) is the ``(k_static, B, V)`` f32 ring of each step's logits."""
    B = st["tokens"].shape[0]
    dev = st["tokens"].device
    tok_buf = torch.full((k_static, B), -1, dtype=torch.int32, device=dev)
    val_buf = torch.zeros((k_static, B), dtype=torch.bool, device=dev)
    logit_buf = None
    i = n_flag_reads = 0
    while i < k_max:
        n_flag_reads += 1
        if not bool(st["active"].any()):
            break
        emit = st["active"]
        st, cache, nxt, logits = body_step(st, cache, i, emit)
        tok_buf[i] = torch.where(emit, nxt, -1)
        val_buf[i] = emit
        if trace:
            if logit_buf is None:
                logit_buf = torch.zeros((k_static,) + tuple(logits.shape),
                                        dtype=torch.float32, device=dev)
            logit_buf[i] = logits
        i += 1
    return cache, st, tok_buf, val_buf, n_flag_reads, logit_buf
