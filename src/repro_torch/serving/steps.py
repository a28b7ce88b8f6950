"""Serving step functions: the sampler, the dense prefill step, the
megasteps of both engine modes and the speculative draft-verify burst
(port of ``repro/serving/steps.py``).

Sampling is one shared primitive, ``sample_logits``: greedy argmax when
``greedy`` (or ``temperature == 0``), otherwise temperature / top-k
categorical sampling with a **per-row PRNG key** ``(B, 2)`` (threefry
words, ``prng.py``).  The engine derives slot ``b``'s key from its
request id and decode step only, so a request draws the same tokens in
either serving mode and in whatever batch composition.

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

from typing import Optional

import torch

from .prng import argmax_first, categorical, fold_in, prng_key, uniform


def greedy_sample(logits):
    """(B, V) -> (B,) int32 argmax, ties to the lowest index (as
    ``jnp.argmax``)."""
    return argmax_first(logits)


def _top_k_mask(l, top_k: Optional[int]):
    """Mask every logit below the row's ``top_k``-th largest to -inf
    (ties at the k-th value are kept)."""
    if top_k is not None and 0 < top_k < l.shape[-1]:
        kth = torch.topk(l, top_k, dim=-1).values[..., -1:]
        l = torch.where(l < kth, float("-inf"), l)
    return l


def _scaled(logits, temperature: float):
    """f32 logits over the temperature: a true division (a Python-float
    divisor would be a multiply by its reciprocal on CUDA)."""
    l = logits.float()
    return l / torch.full((1,), temperature, dtype=torch.float32,
                          device=l.device)


def sample_logits(logits, rng=None, *, greedy: bool = True,
                  temperature: float = 1.0, top_k: Optional[int] = None):
    """logits (B, V), rng (B, 2) per-row keys -> tokens (B,) int32.

    ``greedy`` or ``temperature == 0`` is exact argmax (no rng needed);
    otherwise each row is drawn from ``softmax(logits / temperature)``
    restricted to its ``top_k`` highest logits (ties at the k-th value
    are kept).  Rows are sampled with independent keys, so one row's
    draw never depends on the batch around it."""
    if greedy or temperature == 0:
        return greedy_sample(logits)
    if rng is None:
        raise ValueError("sampling (greedy=False, temperature>0) needs rng")
    return categorical(rng, _top_k_mask(_scaled(logits, temperature), top_k))


class _Keys:
    """A fixed base key, one copy per device, folded with per-row data."""

    def __init__(self, key):
        self._by_dev = {key.device: key}

    def fold(self, *rows):
        """``fold_in(fold_in(base, rows[0]), rows[1]) ...`` per row."""
        dev = rows[0].device
        if dev not in self._by_dev:
            self._by_dev[dev] = next(iter(self._by_dev.values())).to(dev)
        keys = self._by_dev[dev]
        for r in rows:
            keys = fold_in(keys, r)
        return keys


def make_sampler_core(seed: int = 0, *, greedy: bool = True,
                      temperature: float = 1.0,
                      top_k: Optional[int] = None):
    """``(logits, rids, steps) -> tokens``, the sampler the megasteps
    call.  Row ``b``'s key, ``fold_in(fold_in(PRNGKey(seed), rids[b]),
    steps[b])``, is derived on the device from the two int32 vectors, so
    the decode loop ships no keys from the host.  Greedy (= temperature
    0) is the same function without the key path."""
    if greedy:
        return lambda logits, rids, steps: greedy_sample(logits)
    base = _Keys(prng_key(seed))

    def sample(logits, rids, steps):
        return sample_logits(logits, base.fold(rids, steps), greedy=False,
                             temperature=temperature, top_k=top_k)
    return sample


def make_slot_sampler(seed: int = 0, *, greedy: bool = True,
                      temperature: float = 1.0,
                      top_k: Optional[int] = None):
    """Standalone ``(logits, rids, steps) -> tokens`` (the engine's
    dense admission path; the decode loop samples inside the megastep).
    Both serving modes draw through the same core, which is what makes
    paged and dense token streams match for the same seed."""
    return make_sampler_core(seed, greedy=greedy, temperature=temperature,
                             top_k=top_k)


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


def make_paged_mixed_step(model, sampler, *, eos_id, max_new, capacity):
    """Tick for mixed prefill+decode phases: ``tokens (B,T)`` /
    ``t_valid`` / ``emit`` are host-built (prompt chunks are host data),
    everything else lives in the state dict."""
    eos = -1 if eos_id is None else int(eos_id)

    def mixed_step(params, cache, st, tokens, t_valid, emit):
        logits, cache = model.paged_step(
            params, cache, tokens, st["page_table"], st["lengths"], t_valid,
            st["state_slots"])
        nxt = sampler(logits, st["rids"], st["steps"])
        st = _advance(st, nxt, emit, t_valid, eos=eos, max_new=max_new,
                      capacity=capacity)
        return cache, st, nxt, logits
    return mixed_step


def make_paged_burst(model, sampler, *, eos_id, max_new, capacity,
                     k_static: int, trace: bool = False):
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
            nxt = sampler(logits, st["rids"], st["steps"])
            st = _advance(st, nxt, emit, t_valid, eos=eos, max_new=max_new,
                          capacity=capacity)
            return st, cache, nxt, logits

        return _run_burst(cache, st, k_max, k_static, body_step, trace)
    return burst


def make_dense_burst(model, sampler, *, eos_id, max_new, k_static: int,
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
            nxt = sampler(logits, st["rids"], st["steps"])
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


# ---------------------------------------------------------------------------
# speculative (draft-verify) decoding
# ---------------------------------------------------------------------------

# Speculative draws fold a dedicated tag into the seed before the
# request id, so the draft / accept / resample key streams can never
# collide with the decode sampler's ``fold_in(fold_in(seed, rid), step)``
# stream above.
_SPEC_TAG = 0x5BEC
_DRAFT_TAG, _ACCEPT_TAG, _RESAMPLE_TAG = 1, 2, 3


def logits_to_probs(logits, *, temperature: float = 1.0,
                    top_k: Optional[int] = None):
    """``(..., V)`` logits -> the probability vector ``sample_logits``
    draws from: the same f32 cast, temperature divide and top-k mask,
    then softmax.  ``temperature == 0`` degenerates to a one-hot at the
    argmax, which lets the speculative accept rule run greedy and seeded
    sampling through one code path."""
    l = logits.float()
    if temperature == 0:
        one = torch.zeros_like(l)
        return one.scatter_(-1, argmax_first(l).long()[..., None], 1.0)
    l = _top_k_mask(_scaled(l, temperature), top_k)
    e = torch.exp(l - l.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _pick(x, idx):
    """``x[b, idx[b]]`` for x (B, N, ...) and idx (B,) int."""
    return x[torch.arange(x.shape[0], device=x.device), idx.long()]


def spec_accept(draft_tokens, draft_probs, target_probs, budget, keys, *,
                greedy: bool = False):
    """Vectorised rejection-sampling accept rule (the standard
    speculative-decoding rule, Leviathan et al. 2023).

    ``draft_tokens (B, G) int32`` and ``draft_probs (B, G, V)`` are the
    draft's proposals; ``target_probs (B, G+1, V)`` the target's
    distributions at every drafted position plus the bonus row;
    ``budget (B,) int32`` in ``[0, G]`` caps how many proposals each row
    may accept (rows past a row's budget hold garbage and are ignored);
    ``keys (B, 2)`` are per-row PRNG keys.

    Draft token ``d_j`` is accepted iff ``u_j * q_j(d_j) < p_j(d_j)``
    (``p`` target, ``q`` draft, ``u ~ U[0,1)``); the first rejected
    position resamples from ``norm(max(p - q, 0))``, and full acceptance
    draws the bonus token from the target's extra row.  Greedy
    distributions are one-hots and ``u < 1``, so the same arithmetic
    accepts iff the draft matched the target argmax: greedy speculative
    decode equals non-speculative greedy decode token for token.

    Returns ``(emit (B, G+1) int32, n_acc (B,) int32)``: row ``b``'s
    emitted continuation is ``emit[b, :n_acc[b] + 1]``; positions past
    that are garbage."""
    B, G = draft_tokens.shape
    dev = draft_tokens.device
    u = uniform(fold_in(keys, _ACCEPT_TAG), G)                  # (B, G)
    d = draft_tokens.long()[..., None]
    p_d = target_probs[:, :G].gather(-1, d)[..., 0]
    q_d = draft_probs.gather(-1, d)[..., 0]
    ok = (u * q_d < p_d) & (torch.arange(G, device=dev)[None, :]
                            < budget[:, None])
    n_acc = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1) \
        .to(torch.int32)
    # replacement row: target minus draft mass at the first rejection; on
    # full acceptance (n_acc == budget) the draft proposed nothing at that
    # position, so the draw is from the target row alone
    p_row = _pick(target_probs, n_acc)                          # (B, V)
    q_pad = torch.cat([draft_probs, torch.zeros_like(draft_probs[:, :1])],
                      dim=1)
    q_row = torch.where((n_acc < budget)[:, None], _pick(q_pad, n_acc), 0.0)
    resid = (p_row - q_row).clamp_min(0.0)
    # float edge: a residual that cancels to exactly zero falls back to
    # the target row, still a valid sample of p
    resid = torch.where(resid.sum(dim=-1, keepdim=True) > 0, resid, p_row)
    if greedy:
        repl = argmax_first(resid)
    else:
        repl = categorical(fold_in(keys, _RESAMPLE_TAG), torch.log(resid))
    d_pad = torch.cat([draft_tokens.to(torch.int32),
                       torch.zeros_like(draft_tokens[:, :1],
                                        dtype=torch.int32)], dim=1)
    pos = torch.arange(G + 1, device=dev)[None, :]
    emit = torch.where(pos < n_acc[:, None], d_pad, repl[:, None])
    return emit, n_acc


def make_paged_spec_mixed_step(model, draft_model, sampler, *, eos_id,
                               max_new, capacity):
    """Spec-enabled variant of ``make_paged_mixed_step``: the target
    step is unchanged (admission and prefill sampling equal the
    non-speculative engine's), and the draft model consumes the same
    ``(tokens, t_valid)`` chunks, so its KV cache tracks the target's
    through prefill and single-step phases.  Rows carrying a draft-cache
    deficit (see ``make_paged_spec_burst``) prepend ``spec_prev`` to
    catch the draft up, which is why speculative mode requires
    ``prefill_chunk >= 2``."""
    eos = -1 if eos_id is None else int(eos_id)

    def mixed_step(params, dparams, cache, dcache, st, tokens, t_valid,
                   emit):
        logits, cache = model.paged_step(
            params, cache, tokens, st["page_table"], st["lengths"], t_valid,
            st["state_slots"])
        nxt = sampler(logits, st["rids"], st["steps"])

        deficit, prev = st["spec_deficit"], st["spec_prev"]
        d_tokens = torch.where(
            (deficit > 0)[:, None],
            torch.cat([prev[:, None], tokens[:, :-1]], dim=1), tokens)
        tv_d = torch.where(t_valid > 0, t_valid + deficit, 0)
        _, dcache = draft_model.paged_step(
            dparams, dcache, d_tokens, st["page_table"],
            st["lengths"] - deficit, tv_d, None)

        st = _advance(st, nxt, emit, t_valid, eos=eos, max_new=max_new,
                      capacity=capacity)
        prev_new = tokens.gather(
            1, (t_valid - 1).clamp(min=0).long()[:, None])[:, 0]
        st = dict(st,
                  spec_deficit=torch.where(t_valid > 0, 0, deficit),
                  spec_prev=torch.where(t_valid > 0, prev_new, prev))
        return cache, dcache, st, nxt, logits
    return mixed_step


def make_paged_spec_burst(model, draft_model, *, eos_id, max_new, capacity,
                          spec_k: int, k_static: int, seed: int,
                          greedy: bool, temperature: float = 1.0,
                          top_k: Optional[int] = None, trace: bool = False):
    """Speculative decode burst: each of up to ``k_max`` rounds runs the
    draft model ``spec_k`` tokens ahead (T=1 steps, the first a T=2
    catch-up step when the slot carries a draft-cache deficit), verifies
    every drafted position with **one** target
    ``paged_step(all_logits=True)`` of T = spec_k + 1, and folds the
    accepted prefix plus one replacement/bonus token into the slot state
    through ``spec_accept``.

    Rollback is arithmetic: ``lengths`` advances by the emitted count
    ``m`` only, so rejected positions, though written to the paged KV,
    sit past the new length and are never attended again (the next
    round's write covers them before any read can see them).

    The per-row draft budget ``gb = clip(min(max_new - steps - 1,
    capacity - lengths - 1), 0, spec_k)`` keeps every write inside the
    admission-time page reservation; a ``gb == 0`` row finishes this
    round, so its draft steps are masked entirely.

    Slot-state extras (beyond the contract at the top of this module):

      ``spec_rounds (B,) int32``   rounds this request has run (PRNG)
      ``spec_deficit (B,) int32``  target len minus draft-correct len (0/1)
      ``spec_prev (B,) int32``     token at position ``lengths - 1``

    Like ``_run_burst`` the rounds are an eager loop whose early-out
    reads the ``active`` flags before every round.  Returns ``(cache,
    dcache, st, tok_ring, val_ring, n_flag_reads, trace_ring)``: round
    ``r`` slot ``b`` emitted ``tok_ring[r, b, j]`` where
    ``val_ring[r, b, j]`` (rings ``(k_static, B, spec_k+1)``); under
    ``trace``, ``trace_ring[r, b, j]`` is the f32 target logits row that
    produced emitted token ``j`` (else None)."""
    eos = -1 if eos_id is None else int(eos_id)
    G = int(spec_k)
    base = _Keys(fold_in(prng_key(seed), _SPEC_TAG))
    if greedy:
        def probs(l):
            return logits_to_probs(l, temperature=0.0)
    else:
        def probs(l):
            return logits_to_probs(l, temperature=temperature, top_k=top_k)

    def burst(params, dparams, cache, dcache, st, k_max: int):
        B = st["tokens"].shape[0]
        dev = st["tokens"].device
        tok_ring = torch.full((k_static, B, G + 1), -1, dtype=torch.int32,
                              device=dev)
        val_ring = torch.zeros((k_static, B, G + 1), dtype=torch.bool,
                               device=dev)
        trace_ring = None
        pos = torch.arange(G + 1, device=dev)[None, :]
        pt = st["page_table"]
        i = n_flag_reads = 0
        while i < k_max:
            n_flag_reads += 1
            if not bool(st["active"].any()):
                break
            active = st["active"]
            L, steps, x = st["lengths"], st["steps"], st["tokens"]
            d, prev = st["spec_deficit"], st["spec_prev"]
            gb = torch.clamp(torch.minimum(max_new - steps - 1,
                                           capacity - L - 1), 0, G)
            gb = torch.where(active, gb, 0)
            keys = base.fold(st["rids"], st["spec_rounds"])

            # -- draft G tokens ahead (step 0 is the T=2 catch-up) --
            tok0 = torch.stack([torch.where(d > 0, prev, x),
                                torch.where(d > 0, x, 0)], dim=1)
            tv0 = torch.where(active & (gb > 0), 1 + d, 0)
            dlogits, dcache = draft_model.paged_step(
                dparams, dcache, tok0, pt, torch.where(tv0 > 0, L - d, 0),
                tv0, None)
            drafts, dprobs, cur = [], [], None
            for j in range(G):
                if j > 0:
                    tv_j = (active & (j < gb)).to(torch.int32)
                    dlogits, dcache = draft_model.paged_step(
                        dparams, dcache, cur[:, None], pt,
                        torch.where(tv_j > 0, L + j, 0), tv_j, None)
                p_j = probs(dlogits)
                if greedy:
                    cur = argmax_first(p_j)
                else:
                    cur = categorical(fold_in(fold_in(keys, _DRAFT_TAG), j),
                                      torch.log(p_j))
                drafts.append(cur)
                dprobs.append(p_j)
            D = torch.stack(drafts, dim=1)                 # (B, G)
            P = torch.stack(dprobs, dim=1)                 # (B, G, V)

            # -- verify every drafted position in one target step --
            tokens_v = torch.cat([x[:, None], D], dim=1)
            tv_v = torch.where(active, gb + 1, 0)
            qlogits, cache = model.paged_step(
                params, cache, tokens_v, pt, L, tv_v, st["state_slots"],
                all_logits=True)
            emit_full, n_acc = spec_accept(D, P, probs(qlogits), gb, keys,
                                           greedy=greedy)

            # -- fold the accepted prefix + replacement into the state --
            is_eos = emit_full == eos
            before = torch.cumsum(is_eos.to(torch.int32), dim=1) \
                - is_eos.to(torch.int32)
            keep = (pos <= n_acc[:, None]) & (before == 0) & active[:, None]
            m = keep.sum(dim=1).to(torch.int32)
            L2, steps2 = L + m, steps + m

            def take(idx):
                return emit_full.gather(
                    1, idx.clamp(min=0).long()[:, None])[:, 0]
            x2 = torch.where(m > 0, take(m - 1), x)
            done = (is_eos & keep).any(dim=1) | (steps2 >= max_new) \
                | (L2 >= capacity)
            prev2 = torch.where(m >= 2, take(m - 2),
                                torch.where(m > 0, x, prev))
            st = dict(st, tokens=x2, steps=steps2, lengths=L2,
                      active=active & ~done,
                      spec_deficit=torch.where(
                          m > 0, (m == gb + 1).to(torch.int32), d),
                      spec_prev=prev2,
                      spec_rounds=st["spec_rounds"]
                      + (m > 0).to(torch.int32))
            tok_ring[i] = torch.where(keep, emit_full, -1)
            val_ring[i] = keep
            if trace:
                if trace_ring is None:
                    trace_ring = torch.zeros(
                        (k_static,) + tuple(qlogits.shape),
                        dtype=torch.float32, device=dev)
                trace_ring[i] = qlogits
            i += 1
        return cache, dcache, st, tok_ring, val_ring, n_flag_reads, trace_ring
    return burst
