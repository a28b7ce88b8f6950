"""Continuous-batching serving engine, paged greedy mode (port of the
paged subset of ``repro/serving/engine.py``).

Requests enter a thread-safe queue (``submit``) and are scheduled into a
fixed array of ``batch_size`` *slots*; the decode loop never waits for a
full group: finished sequences (``eos_id`` or ``max_new_tokens``) are
evicted at once, and queued requests join mid-decode.

**Paged KV cache** — one shared pool of fixed-size blocks
(``kv_cache.py``); each slot owns a page table and a true position
counter, and attention masks by per-slot length.  A newcomer's prompt is
consumed in bounded ``prefill_chunk``-token steps *in the same batched
calls* that keep decoding the in-flight slots.  Blocks are reserved
worst-case at admission (prompt + max_new), extended lazily block by
block as decode crosses boundaries, and released on eviction; a request
whose reservation does not fit stays queued — never a mid-decode
allocation failure.

**Prefix sharing + copy-on-write** — whenever a slot completes a page,
the engine registers the block under the chain digest of the token
prefix it caches.  At admission, a joiner's prompt is matched page by
page against resident blocks; matched pages are *mapped* into the new
slot's page table with a refcount bump instead of being re-prefilled.
Shared blocks are immutable: before a write would land in a block whose
refcount exceeds one, the engine forks it (private copy, page-table
swap).  The last matched prompt token is always re-run through the
model so the joiner's first sampled token has logits to come from.

**Decode loop** — per-step slot state (page tables, lengths, last
tokens, step counters, done flags) lives in device tensors
(``DeviceSlotState``) that the megasteps replace after every call; the
host rebuilds them only after a *structural* event (admission,
eviction, block extension, COW fork).  When no admissions or prefill
chunks are pending, the engine runs **decode bursts** of up to
``burst`` megasteps per host drain; whenever the request queue is
non-empty it degrades to K = 1 so join latency is unchanged.

Sampling is greedy argmax.  The attention of every step runs through the
hand-written CUDA kernels on a CUDA device (``models/attention.py``).
Not ported yet, each raising ``NotImplementedError`` with its ROADMAP
item: seeded sampling (``temperature > 0``), int8 KV, speculative
decoding, the dense (``paged=False``) mode, ``mesh=``, the batch lane and
preemption, fault plans, recurrent families.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.common import dtype_of, resolve_device
from .kv_cache import (ROOT_DIGEST, BlockAllocator, CacheFullError,
                       DeviceSlotState, chain_digest)
from .scheduler import SchedRequest, Scheduler
from .steps import make_paged_burst, make_paged_mixed_step


@dataclasses.dataclass
class GenerationResult:
    request_id: int
    prompt: np.ndarray
    tokens: np.ndarray
    latency_s: float
    # "ok" | "timeout" | "error" | "oom" — non-ok results carry whatever
    # tokens were generated before the request was failed
    status: str = "ok"
    ttft_s: Optional[float] = None    # submit -> first generated token


class _PagedSlot:
    """Per-slot decode state in paged mode: the true position counter
    lives in the engine's ``_lengths`` array; this tracks ownership."""
    __slots__ = ("rid", "prompt", "tokens", "t_submit", "done", "blocks",
                 "reserve_left", "prefill_off", "digests", "status",
                 "t_first")

    def __init__(self, req: SchedRequest, blocks: List[int],
                 reserve_left: int, prefill_off: int = 0,
                 digests: Optional[List[bytes]] = None):
        self.rid = req.rid
        self.prompt = req.prompt
        self.tokens: List[int] = []
        self.t_submit = req.t_submit
        self.done = False
        self.blocks = blocks          # physical block ids, page order
        self.reserve_left = reserve_left  # blocks still claimable lazily
        self.prefill_off = prefill_off    # prompt tokens already cached
        self.digests = digests if digests is not None else []  # per full page
        self.status = "ok"
        self.t_first: Optional[float] = None


_KV_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


class ServeEngine:
    def __init__(self, model, params, *, batch_size: int = 4,
                 capacity: int = 256, max_new_tokens: int = 16,
                 cache_dtype=torch.float32, temperature: float = 0.0,
                 eos_id: Optional[int] = None,
                 paged: Optional[bool] = None, block_size: int = 16,
                 num_blocks: Optional[int] = None, prefill_chunk: int = 32,
                 share_prefix: Optional[bool] = None, burst: int = 1,
                 mesh=None, retain_cap: Optional[int] = None,
                 retain_ttl_s: Optional[float] = None, spec_k: int = 0,
                 kv_dtype: Optional[str] = None, fault_plan=None,
                 device=None):
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if temperature > 0:
            raise NotImplementedError(
                "temperature > 0: seeded sampling is not ported yet "
                "(ROADMAP A8); serve greedily (temperature=0)")
        if kv_dtype not in (None, "f32", "bf16", "int8"):
            raise ValueError(
                f"kv_dtype must be 'f32', 'bf16' or 'int8', got {kv_dtype!r}")
        if kv_dtype == "int8":
            raise NotImplementedError(
                "kv_dtype='int8': int8 paged KV is not ported yet (ROADMAP A9)")
        if spec_k:
            raise NotImplementedError(
                "spec_k > 0: speculative decoding is not ported yet "
                "(ROADMAP A11)")
        if mesh is not None:
            raise NotImplementedError(
                "mesh=: multi-device serving is not ported yet (ROADMAP A17)")
        if fault_plan is not None:
            raise NotImplementedError(
                "fault_plan=: fault injection comes with the front door "
                "(ROADMAP A7a)")
        if paged is False:
            raise NotImplementedError(
                "paged=False: the dense engine mode is not ported yet "
                "(ROADMAP A7d)")
        if not model.supports_paged() or model.has_recurrent_state():
            raise NotImplementedError(
                f"{type(model).__name__} ({model.cfg.family}) cannot serve "
                "paged in the port yet (ROADMAP A10)")
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}: build both on one device")
        if kv_dtype is not None:
            cache_dtype = _KV_DTYPES[kv_dtype]
        compute = dtype_of(model.cfg.compute_dtype)
        if compute == torch.bfloat16 and cache_dtype == torch.float32:
            # the reference cannot serve this either: f32 K/V promote the
            # attention output and the residual stream out of bf16
            raise ValueError(
                "a bf16 model with an f32 KV pool is not supported: pass "
                "kv_dtype='bf16'")
        self.model = model
        self.params = params
        self.batch_size = batch_size
        self.capacity = capacity
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.cache_dtype = cache_dtype
        self.kv_dtype = kv_dtype
        self.max_burst = int(burst)
        self.burst = int(burst)
        self.scheduler = Scheduler()
        self._slots: List[Optional[_PagedSlot]] = [None] * batch_size
        self._lock = threading.Lock()
        self._next_rid = 0
        # completed results, keyed by rid until a wait() collects them;
        # the condition variable wakes concurrent waiters, and the step
        # lock elects exactly one thread at a time to drive step()
        self._results: Dict[int, GenerationResult] = {}
        self._results_cv = threading.Condition()
        self._step_lock = threading.Lock()
        self.block_size = block_size
        self.prefill_chunk = prefill_chunk
        self.share_prefix = model.supports_prefix_sharing() \
            if share_prefix is None else bool(share_prefix)
        self._pages_per_slot = -(-capacity // block_size)
        if num_blocks is None:
            num_blocks = batch_size * self._pages_per_slot
        self.allocator = BlockAllocator(num_blocks, block_size,
                                        retain_cap=retain_cap,
                                        retain_ttl_s=retain_ttl_s)
        self._page_table = np.zeros((batch_size, self._pages_per_slot),
                                    np.int32)
        self._lengths = np.zeros((batch_size,), np.int32)
        self._reserved = 0            # lazily-claimable blocks promised out
        self._paged_cache = None
        self._mixed_fn = make_paged_mixed_step(
            model, eos_id=eos_id, max_new=max_new_tokens, capacity=capacity)
        self._burst_fn = make_paged_burst(
            model, eos_id=eos_id, max_new=max_new_tokens, capacity=capacity,
            k_static=self.max_burst)
        # slot state on the device: uploaded (copied) only after
        # structural host mutations, otherwise replaced by each megastep
        self._dev = DeviceSlotState(
            put=lambda v: torch.tensor(v, device=self.device))
        # scheduler counters
        self.n_requests = 0
        self.n_prefills = 0
        self.n_joins = 0              # requests admitted mid-decode
        self.n_evictions = 0          # slots freed by eos/max_new
        self.n_prefill_chunks = 0     # bounded prefill steps run
        self.n_prefix_hits = 0        # admissions that mapped blocks
        self.n_shared_tokens = 0      # prompt tokens served from shared blocks
        self.n_cow_forks = 0          # shared blocks forked before a write
        # decode-loop counters (see loop_stats())
        self.n_bursts = 0             # burst launches (>= 1 device step each)
        self.n_device_steps = 0       # megasteps executed
        self.n_host_syncs = 0         # decode-loop device->host drains
        self.n_burst_early_exits = 0  # bursts cut short by all-done

    # -- continuous batching ------------------------------------------------
    def submit(self, prompt: np.ndarray, *, lane: str = "interactive") -> int:
        """Enqueue a request; returns its request id (thread-safe).
        Deadlines and caller tags come with the front door (A7a)."""
        if lane != "interactive":
            raise NotImplementedError(
                f"lane={lane!r}: the batch lane and preemption are not "
                "ported yet (ROADMAP A7c)")
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.shape[0] == 0:
            raise ValueError(f"prompt must be non-empty 1-D, got {prompt.shape}")
        if prompt.shape[0] > self.capacity:
            raise ValueError(
                f"prompt length {prompt.shape[0]} exceeds KV-cache capacity "
                f"{self.capacity}; raise capacity= or truncate the prompt")
        # an out-of-range token would index past the embedding table
        vocab = self.model.cfg.vocab_size
        if int(prompt.min()) < 0 or int(prompt.max()) >= vocab:
            raise ValueError(
                f"prompt tokens outside the model vocab [0, {vocab}) "
                f"(min {int(prompt.min())}, max {int(prompt.max())})")
        now = time.monotonic()
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            self.scheduler.push(SchedRequest(rid, prompt, lane=lane,
                                             t_submit=now))
            self.n_requests += 1
        return rid

    @property
    def n_active(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    @property
    def has_work(self) -> bool:
        with self._lock:
            return self.scheduler.pending or self.n_active > 0

    def _finish(self, res: GenerationResult) -> None:
        """Record a completed result and wake any wait()ers."""
        with self._results_cv:
            self._results[res.request_id] = res
            self._results_cv.notify_all()

    def _make_result(self, slot, now: float) -> GenerationResult:
        return GenerationResult(
            request_id=slot.rid, prompt=slot.prompt,
            tokens=np.asarray(slot.tokens, np.int32),
            latency_s=now - slot.t_submit, status=slot.status,
            ttft_s=None if slot.t_first is None
            else slot.t_first - slot.t_submit)

    def kv_bytes_per_block(self) -> int:
        """Device bytes one physical block costs across every attention
        layer's K and V pools."""
        cfg = self.model.cfg
        itemsize = torch.empty((), dtype=self.cache_dtype).element_size()
        return (2 * self.model.n_periods * self.block_size
                * cfg.n_kv_heads * cfg.resolved_head_dim * itemsize)

    def pool_stats(self) -> Dict[str, Any]:
        """Block-pool occupancy incl. shared vs private split, plus the
        pool footprint: ``kv_dtype``, ``bytes_per_block`` and
        ``pool_bytes``."""
        stats: Dict[str, Any] = self.allocator.stats()
        stats["n_reserved"] = self._reserved
        stats["kv_dtype"] = {torch.float32: "f32",
                             torch.bfloat16: "bf16"}[self.cache_dtype]
        stats["bytes_per_block"] = self.kv_bytes_per_block()
        stats["pool_bytes"] = \
            stats["bytes_per_block"] * self.allocator.num_blocks
        return stats

    def loop_stats(self) -> Dict[str, int]:
        """Decode-loop counters: device steps vs host drains vs state
        uploads (``n_state_uploads`` counts host->device slot-state
        rebuilds — structural events only)."""
        return {"burst": self.burst, "max_burst": self.max_burst,
                "n_bursts": self.n_bursts,
                "n_device_steps": self.n_device_steps,
                "n_host_syncs": self.n_host_syncs,
                "n_burst_early_exits": self.n_burst_early_exits,
                "n_state_uploads": self._dev.n_uploads}

    def step(self) -> List[GenerationResult]:
        """Admit what fits, run one decode burst (or a mixed
        prefill+decode megastep), evict what finished.  Returns results
        for requests that completed during this step.  A failing step
        raises (restart after a failure is ROADMAP A7b)."""
        with torch.inference_mode():
            return self._step_paged()

    def serve(self, requests: List[np.ndarray],
              timeout_s: float = 120.0) -> List[GenerationResult]:
        """Serve via continuous batching; results in request order.

        On timeout the results completed before the deadline are
        returned as-is and every unfinished request is failed with
        status ``"timeout"`` (its tokens so far attached)."""
        rids = [self.submit(r) for r in requests]
        return self.wait(rids, timeout_s=timeout_s)

    def wait(self, rids: List[int],
             timeout_s: Optional[float] = None) -> List[GenerationResult]:
        """Block until every request in ``rids`` has a result, driving
        ``step()`` whenever no other thread is.  Safe to call from
        multiple threads over one engine: exactly one waiter steps at a
        time, and each waiter collects (and removes) only its own
        results."""
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        while True:
            with self._results_cv:
                if all(r in self._results for r in rids):
                    break
                missing = [r for r in rids if r not in self._results]
            if deadline is not None and time.monotonic() >= deadline:
                self._cancel(missing, "timeout")
                break
            if self._step_lock.acquire(blocking=False):
                try:
                    if self.has_work:
                        self.step()
                    else:
                        time.sleep(0.001)
                finally:
                    self._step_lock.release()
            else:
                with self._results_cv:
                    self._results_cv.wait(timeout=0.005)
        with self._results_cv:
            return [self._results.pop(rid) for rid in rids
                    if rid in self._results]

    def _cancel(self, rids: List[int], status: str) -> None:
        """Fail every request in ``rids`` (timeouts, a failed pipeline
        batch): queued ones are popped, in-flight ones are evicted with
        whatever they generated so far, and none of their blocks stays
        addressable for prefix sharing.  Runs under the step lock so no
        megastep is mid-flight while slots are torn down."""
        rids = set(rids)
        if not rids:
            return
        with self._step_lock:
            now = time.monotonic()
            with self._lock:
                popped = [self.scheduler.pop_rid(rid) for rid in rids]
            for req in popped:
                if req is not None:
                    self._finish(GenerationResult(
                        request_id=req.rid, prompt=req.prompt,
                        tokens=np.asarray(req.tokens, np.int32),
                        latency_s=now - req.t_submit, status=status))
            dead_blocks: List[int] = []
            for slot in self._slots:
                if slot is not None and slot.rid in rids:
                    slot.status = status
                    slot.done = True
                    dead_blocks += list(slot.blocks)
            if dead_blocks:
                self._evict_paged()
                for b in dead_blocks:
                    self.allocator.retire(b)

    def as_pipeline_filter(self, *, timeout_s: Optional[float] = None):
        """Adapter: (n, S) prompt batch -> (n, max_new_tokens) generations,
        numpy in and out.

        Row order in == row order out, so TensorUnbatcher downstream can
        restore per-request pts/meta.  Rows shorter than max_new (early
        eos) are right-padded with eos_id (or 0), as are rows whose prompt
        was rejected at submit (per-row isolation: a bad prompt fails only
        its own row).  Per-row metadata (lanes, deadlines, transport
        padding) comes with the front door (ROADMAP A7a)."""
        pad = self.eos_id if self.eos_id is not None else 0

        def fn(prompts):
            prompts = np.asarray(prompts, np.int32)
            rids: List[Optional[int]] = []
            for row in prompts:
                try:
                    rids.append(self.submit(row))
                except ValueError:
                    rids.append(None)
            live = [r for r in rids if r is not None]
            try:
                results = self.wait(live, timeout_s=timeout_s)
            except Exception:
                # fail exactly this batch's requests, leave the pool
                # clean, and let the pipeline report the error
                self._cancel(live, "error")
                raise
            by_id = {r.request_id: r for r in results}
            out = np.full((len(rids), self.max_new_tokens), pad, np.int32)
            for i, rid in enumerate(rids):
                if rid in by_id:
                    out[i, : len(by_id[rid].tokens)] = by_id[rid].tokens
            return out
        return fn

    # -- device-resident slot state -----------------------------------------
    def _paged_state(self) -> Dict[str, np.ndarray]:
        """Host rebuild of the device slot state (dirty path)."""
        B = self.batch_size
        tokens = np.zeros((B,), np.int32)
        rids = np.zeros((B,), np.int32)
        steps = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            rids[i] = s.rid
            steps[i] = len(s.tokens)
            if s.tokens:
                tokens[i] = s.tokens[-1]
            # decoding = prefill complete, first token sampled, not done,
            # cache strip not exhausted (the burst body writes at
            # `lengths` before its own done check, so an active row must
            # always have room for one token)
            active[i] = (not s.done and s.prefill_off >= len(s.prompt)
                         and len(s.tokens) > 0
                         and int(self._lengths[i]) < self.capacity)
        return {"tokens": tokens, "rids": rids, "steps": steps,
                "active": active, "page_table": self._page_table,
                "lengths": self._lengths}

    def _drain_burst(self, tok_buf, val_buf, *, k: int) -> None:
        """One host sync per burst: fetch the token ring buffer, append
        tokens to their slots, and replay the device-side done rule (eos
        / max_new / cache exhausted) so the host mirror stays coherent
        with the device's ``active`` flags."""
        toks, valid = tok_buf.cpu().numpy(), val_buf.cpu().numpy()
        self.n_host_syncs += 1
        n_steps = int(valid.any(axis=1).sum())
        self.n_bursts += 1
        self.n_device_steps += n_steps
        if n_steps < k:
            self.n_burst_early_exits += 1
        fresh = set()
        for kstep in range(n_steps):
            for i, slot in enumerate(self._slots):
                if slot is None or not valid[kstep, i]:
                    continue
                slot.tokens.append(int(toks[kstep, i]))
                fresh.add(i)
                self._lengths[i] += 1
                if ((self.eos_id is not None
                     and slot.tokens[-1] == self.eos_id)
                        or len(slot.tokens) >= self.max_new_tokens
                        or int(self._lengths[i]) >= self.capacity):
                    slot.done = True
        now = time.monotonic()
        for i in fresh:
            if self._slots[i].t_first is None:
                self._slots[i].t_first = now

    # -- scheduler internals ------------------------------------------------
    def _step_paged(self) -> List[GenerationResult]:
        """One engine tick.

        While any slot is still consuming its prompt, one batched
        *mixed* megastep advances every busy slot: decoding slots feed
        their last token (t_valid=1), prefilling slots feed their next
        ``prefill_chunk`` prompt tokens, idle slots ride along masked
        out (t_valid=0).  Once the batch is pure decode, the engine
        runs *bursts* instead: up to ``burst`` device steps per host
        drain (K=1 whenever requests are queued, so the next eviction
        admits immediately).  Before any step, shared blocks in the
        coming write range are forked (COW) and page tables
        pre-extended to cover it; after it, newly completed pages are
        published to the content table for future joiners.
        """
        # periodic retention sweep: TTL expiry must not depend on
        # allocation traffic (no-op without retain_ttl_s)
        self.allocator.sweep()
        self._admit_paged()
        finished = self._evict_paged()
        busy = [(i, s) for i, s in enumerate(self._slots) if s is not None]
        if not busy:
            return finished
        self._ensure_paged_cache()
        if any(s.prefill_off < len(s.prompt) for _, s in busy):
            self._step_paged_mixed(busy)
        else:
            self._step_paged_burst(busy)
        if self.share_prefix:
            for i, slot in busy:
                self._register_full_pages(i, slot)
        return finished + self._evict_paged()

    def _step_paged_mixed(self, busy) -> None:
        """One mixed prefill+decode megastep (T = ``prefill_chunk``)."""
        T = self.prefill_chunk
        tokens = np.zeros((self.batch_size, T), np.int32)
        t_valid = np.zeros((self.batch_size,), np.int32)
        emit = np.zeros((self.batch_size,), bool)
        for i, slot in busy:
            if slot.done:
                continue
            if slot.prefill_off < len(slot.prompt):
                n = min(T, len(slot.prompt) - slot.prefill_off)
                tokens[i, :n] = slot.prompt[slot.prefill_off:
                                            slot.prefill_off + n]
                t_valid[i] = n
                emit[i] = slot.prefill_off + n >= len(slot.prompt)
            elif self._lengths[i] >= self.capacity:
                slot.done = True      # cache strip exhausted: truncate
            else:
                tokens[i, 0] = slot.tokens[-1]
                t_valid[i] = 1
                emit[i] = True
        if not t_valid.any():
            return
        for i, slot in busy:
            if t_valid[i]:
                self._cow_write_range(i, slot, int(self._lengths[i]),
                                      int(t_valid[i]))
                self._extend_blocks(i, slot,
                                    int(self._lengths[i]) + int(t_valid[i]))
        st = self._dev.device(self._paged_state)
        put = self._dev.put
        self._paged_cache, st, sampled, _ = self._mixed_fn(
            self.params, self._paged_cache, st, put(tokens), put(t_valid),
            put(emit))
        self._dev.adopt(st)
        self.n_prefill_chunks += 1
        self.n_device_steps += 1
        sampled_np = sampled.cpu().numpy()
        self.n_host_syncs += 1
        for i, slot in busy:
            if not t_valid[i]:
                continue
            was_prefilling = slot.prefill_off < len(slot.prompt)
            self._lengths[i] += t_valid[i]
            if was_prefilling:
                slot.prefill_off += int(t_valid[i])
                if slot.prefill_off < len(slot.prompt):
                    continue          # more chunks to go; no token yet
                self.n_prefills += 1
            slot.tokens.append(int(sampled_np[i]))
            if slot.t_first is None:
                slot.t_first = time.monotonic()
            # replay of the megastep's device-side done rule
            if ((self.eos_id is not None and slot.tokens[-1] == self.eos_id)
                    or len(slot.tokens) >= self.max_new_tokens
                    or int(self._lengths[i]) >= self.capacity):
                slot.done = True

    def _step_paged_burst(self, busy) -> None:
        """Up to ``burst`` pure-decode megasteps per host drain.

        Before launching, every active slot's page table is extended to
        cover the burst's worst-case write range (drawn from the
        admission-time reservation, so this can never fail) and any
        shared block in that range is COW-forked — the loop then never
        needs the host until its ring buffer is drained."""
        with self._lock:
            pending = self.scheduler.pending
        k = 1 if pending else min(self.burst, self.max_burst)
        k = max(1, k)
        any_active = False
        for i, slot in busy:
            if slot.done:
                continue
            L = int(self._lengths[i])
            if L >= self.capacity:
                slot.done = True      # cache strip exhausted: truncate
                continue
            # a burst writes at most k tokens and stops at max_new (final
            # length = prompt + max_new - 1) and at capacity
            target = min(L + k, len(slot.prompt) + self.max_new_tokens - 1,
                         self.capacity)
            if target > L:
                self._cow_write_range(i, slot, L, target - L)
                self._extend_blocks(i, slot, target)
            any_active = True
        if not any_active:
            return
        st = self._dev.device(self._paged_state)
        self._paged_cache, st, tok_buf, val_buf = self._burst_fn(
            self.params, self._paged_cache, st, k)
        self._dev.adopt(st)
        self._drain_burst(tok_buf, val_buf, k=k)

    def _match_prefix(self, prompt: np.ndarray) \
            -> Tuple[List[int], List[bytes], int]:
        """Longest resident chain matching the prompt.

        Returns ``(mapped, digests, matched)``: physical blocks to map
        at pages ``0..len(mapped)-1``, chain digests of the pages fully
        covered by ``matched``, and the number of prompt tokens those
        blocks serve.  Matching walks full pages by chain digest, then
        tries to land the final partial page on another sequence's
        completed block (``lookup_tail``).  ``matched`` is capped at
        ``len(prompt) - 1`` so at least one prompt token always runs
        through the model — the joiner's first sampled token needs
        logits — which may leave the write cursor inside a shared block;
        the COW fork at write time keeps that sound.
        """
        if not self.share_prefix:
            return [], [], 0
        bs = self.block_size
        L = len(prompt)
        parent = ROOT_DIGEST
        mapped: List[int] = []
        digests: List[bytes] = []
        off = 0
        while off + bs <= L:
            toks = tuple(int(t) for t in prompt[off:off + bs])
            block = self.allocator.lookup(parent, toks)
            if block is None:
                break
            parent = chain_digest(parent, toks)
            mapped.append(block)
            digests.append(parent)
            off += bs
        if 2 <= L - off < bs:
            # a 1-token tail is pure overhead: its only token would be
            # re-run (and fork the block) anyway, so require >= 2
            tail = self.allocator.lookup_tail(
                parent, tuple(int(t) for t in prompt[off:L]))
            if tail is not None:
                mapped.append(tail)
                off = L
        matched = min(off, L - 1)
        return mapped, digests[:matched // bs], matched

    def _match_prefix_cached(self, req: SchedRequest):
        """Memoized match for a queued request, valid while the
        allocator's content-table ``epoch`` is unchanged."""
        if req.match is None or req.match_epoch != self.allocator.epoch:
            req.match = self._match_prefix(req.prompt)
            req.match_epoch = self.allocator.epoch
        return req.match

    def _admit_paged(self) -> None:
        """Admit queued requests into free slots, FIFO.

        A request needs a slot plus a worst-case *private*-block
        reservation: the pages its matched prefix shares forever are
        discounted, everything else (fresh prompt pages, decode
        extensions, possible COW forks in the write range) is budgeted
        up front, so mid-decode allocation never fails.  The scan is
        *size-aware*: a candidate that does not fit stays queued and
        the scan moves on, so a too-large request can never
        head-of-line-block a smaller one behind it."""
        free = [i for i, s in enumerate(self._slots) if s is None]
        mid_decode = self.n_active > 0
        joins = []
        with self._lock:
            for req in self.scheduler.candidates():
                if not free:
                    break
                try:
                    fit = self._fresh_fit(req, free)
                except CacheFullError:
                    continue           # the candidate stays queued
                if fit is None:
                    if self.allocator.n_live == 0 and self._reserved == 0:
                        # does not fit an *empty* pool: it never will —
                        # fail it instead of wedging the queue forever
                        self.scheduler.remove(req)
                        self._finish(GenerationResult(
                            request_id=req.rid, prompt=req.prompt,
                            tokens=np.asarray(req.tokens, np.int32),
                            latency_s=time.monotonic() - req.t_submit,
                            status="oom"))
                    continue           # size-aware: scan past this one
                self.scheduler.remove(req)
                joins.append(fit)
        for slot_i, req, blocks, reserve, matched, digests in joins:
            if mid_decode:
                self.n_joins += 1
            if matched:
                self.n_prefix_hits += 1
                self.n_shared_tokens += matched
            self._slots[slot_i] = _PagedSlot(req, blocks, reserve,
                                             prefill_off=matched,
                                             digests=list(digests))
            self._page_table[slot_i, :] = 0
            self._page_table[slot_i, :len(blocks)] = blocks
            self._lengths[slot_i] = matched
        if joins:
            self._dev.mark_dirty()

    def _fresh_fit(self, req: SchedRequest, free: List[int]):
        """Try to take resources for an admission (all-or-nothing);
        None if the request does not fit right now."""
        plen = req.prompt.shape[0]
        mapped, digests, matched = self._match_prefix_cached(req)
        total = self.allocator.blocks_for(
            min(plen + self.max_new_tokens, self.capacity))
        # pages below matched // block_size are never written by this
        # slot, so they stay shared for its whole lifetime
        needed = total - matched // self.block_size
        # retained mapped blocks are resurrected off the free list by
        # share() below — they consume free-list entries on top of the
        # private budget, so the fit check must count them
        n_resurrect = sum(1 for b in mapped if self.allocator.ref(b) == 0)
        if needed + n_resurrect > self.allocator.n_free - self._reserved:
            return None
        # share (and resurrect) the mapped prefix *before* acquiring
        # fresh blocks — acquire recycles retained blocks and must never
        # recycle one this very admission is about to map
        self.allocator.share(mapped)
        n_fresh = self.allocator.blocks_for(plen) - len(mapped)
        try:
            fresh = self.allocator.acquire(n_fresh)
        except CacheFullError:           # unreachable given the check above
            self.allocator.release(mapped)
            return None
        self._reserved += needed - n_fresh
        return (free.pop(0), req, mapped + fresh, needed - n_fresh,
                matched, digests)

    def _ensure_paged_cache(self) -> None:
        if self._paged_cache is None:
            self._paged_cache = self.model.init_paged_cache(
                self.allocator.num_blocks, self.block_size,
                dtype=self.cache_dtype)

    def _extend_blocks(self, slot_i: int, slot: _PagedSlot,
                       n_tokens: int) -> None:
        """Grow a slot's page list to cover ``n_tokens`` cached tokens,
        drawing on its admission-time reservation (never fails)."""
        need = -(-n_tokens // self.block_size)
        while len(slot.blocks) < need:
            if slot.reserve_left <= 0:
                raise RuntimeError("block reservation under-counted")
            (bid,) = self.allocator.acquire(1)
            slot.blocks.append(bid)
            slot.reserve_left -= 1
            self._reserved -= 1
            self._page_table[slot_i, len(slot.blocks) - 1] = bid
            self._dev.mark_dirty()

    def _cow_write_range(self, slot_i: int, slot: _PagedSlot, start: int,
                         n_new: int) -> None:
        """Copy-on-write: fork every *shared* block in the page range
        the coming ``paged_scatter`` will touch, so the write can never
        leak into another slot's view of the pool."""
        bs = self.block_size
        first = start // bs
        last = (start + n_new - 1) // bs
        for p in range(first, min(last + 1, len(slot.blocks))):
            # fork if shared — or still registered: a resurrected block
            # can be held at refcount 1, but the content table still
            # advertises its KV, so writing in place would corrupt what
            # future joiners map
            if self.allocator.ref(slot.blocks[p]) > 1 \
                    or self.allocator.is_registered(slot.blocks[p]):
                self._fork_block(slot_i, slot, p)

    def _fork_block(self, slot_i: int, slot: _PagedSlot, p: int) -> None:
        """Give the slot a private copy of page ``p``: acquire a block
        from the slot's reservation, copy the page's KV across every
        layer, swap the page-table entry, and drop our reference to the
        shared original (its other holders keep it alive)."""
        old = slot.blocks[p]
        if slot.reserve_left <= 0:
            raise RuntimeError("COW fork not covered by the reservation")
        (new,) = self.allocator.acquire(1)
        slot.reserve_left -= 1
        self._reserved -= 1
        self._paged_cache = self.model.copy_paged_block(
            self._paged_cache, old, new)
        self.allocator.release([old])
        slot.blocks[p] = new
        self._page_table[slot_i, p] = new
        self._dev.mark_dirty()
        self.n_cow_forks += 1

    def _seq_tokens(self, slot: _PagedSlot, start: int,
                    stop: int) -> Tuple[int, ...]:
        """Tokens at cache positions [start, stop): prompt, then the
        generated stream (token ``g`` was written at ``len(prompt)+g``)."""
        L = len(slot.prompt)
        return tuple(int(slot.prompt[p]) if p < L
                     else int(slot.tokens[p - L])
                     for p in range(start, stop))

    def _register_full_pages(self, slot_i: int, slot: _PagedSlot) -> None:
        """Publish every newly completed page to the content table so
        later joiners can map it instead of re-prefilling."""
        bs = self.block_size
        length = int(self._lengths[slot_i])
        while (len(slot.digests) + 1) * bs <= length:
            p = len(slot.digests)
            toks = self._seq_tokens(slot, p * bs, (p + 1) * bs)
            parent = slot.digests[-1] if slot.digests else ROOT_DIGEST
            self.allocator.register(slot.blocks[p], parent, toks)
            slot.digests.append(chain_digest(parent, toks))

    def _evict_paged(self) -> List[GenerationResult]:
        out: List[GenerationResult] = []
        now = time.monotonic()
        for i, slot in enumerate(self._slots):
            if slot is None or not slot.done:
                continue
            res = self._make_result(slot, now)
            out.append(res)
            self._finish(res)
            # refcounted release: shared blocks stay resident (and
            # content-addressable) as long as any other slot maps them;
            # registered blocks at refcount 0 are *retained* — the next
            # identical prompt maps them instead of re-prefilling
            self.allocator.release(slot.blocks)
            self._reserved -= slot.reserve_left
            self._page_table[i, :] = 0
            self._lengths[i] = 0
            self._slots[i] = None
            self._dev.mark_dirty()
            self.n_evictions += 1
        return out
