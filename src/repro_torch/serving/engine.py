"""Continuous-batching serving engine, in its paged and dense modes
(port of ``repro/serving/engine.py``).

Requests enter a thread-safe queue (``submit``) and are scheduled into a
fixed array of ``batch_size`` *slots*; the decode loop never waits for a
full group: finished sequences (``eos_id`` or ``max_new_tokens``) are
evicted at once, and queued requests join mid-decode.  ``paged`` picks
the mode: on by default when the model supports it
(``model.supports_paged()``), else dense.

**Dense mode** (``paged=False``, and every model the paged mode cannot
serve: sliding windows) — one contiguous cache of ``capacity`` slots
per batch row and layer (a ring of ``sliding_window`` slots with a
window); all rows share one decode position ``_pos``.  A fresh wave
prefills its prompts left-padded to the longest and re-anchors ``_pos``
there; a mid-decode joiner must fit (prompt length <= ``_pos``) and is
prefilled left-padded to ``_pos`` with the whole batch, its rows then
spliced into the live cache.  Decode runs bursts at the shared position
(a host int: every layer's cache update is a slice write, no index
tensor and no host sync per layer); when ``_pos`` reaches ``capacity``
every in-flight request is truncated.  ``generate_batch`` is the
synchronous fixed-batch entry of the same model steps.

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

**Recurrent state slabs** — a model with mamba layers keeps each
sequence's state in fixed-size slabs beside the block pool, handed out
by a ``StateStore`` (``num_state_slots``, default one per batch slot).
Admission takes a slot, its block reservation and a slab all-or-nothing:
a request with no free slab stays queued.  Eviction frees the slab; the
model blanks a recycled slab on its new owner's first step.  A slab
summarizes its whole prefix, so such models never share prefixes
(``share_prefix=True`` raises, auto resolves to off).

**Decode loop** — per-step slot state (page tables, lengths, last
tokens, step counters, done flags) lives in device tensors
(``DeviceSlotState``) that the megasteps replace after every call; the
host rebuilds them only after a *structural* event (admission,
eviction, block extension, COW fork).  When no admissions or prefill
chunks are pending, the engine runs **decode bursts** of up to
``burst`` megasteps per host drain; whenever the request queue is
non-empty it degrades to K = 1 so join latency is unchanged.

**Int8 KV** — ``kv_dtype="int8"`` (paged mode only) keeps the pool as
int8 K/V with one f32 scale per (block row, KV head) beside it; the
model must compute in f32 (the dequantized K/V are f32), as in the
reference, which fails a bf16 model over an int8 pool (this port raises
``ValueError`` at construction).

**Lanes, deadlines and preemption** — ``submit(lane=)`` queues on the
``interactive`` or the ``batch`` lane; admission takes interactive work
first, FIFO within a lane, and batch work never slips past a blocked
interactive candidate.  An interactive candidate blocked on a slot, on
blocks or on a state slab preempts the youngest running batch slot
(paged mode): a decoding slot's used pages (K/V, and the int8 scale
pools) and its mamba slab are gathered to host memory and scattered
back into whatever blocks are free when it is re-admitted
(``gather_paged_pages``/``scatter_paged_pages``), so it decodes as if
never preempted; a slot still mid-prefill is simply restarted.  A
queued request whose ``deadline`` (relative TTFT budget) passes fails
with ``"expired"``.

**Sampling** — ``temperature == 0`` (the default) is greedy argmax;
``temperature > 0`` draws from ``softmax(logits / temperature)``, cut to
the ``top_k`` highest logits, with the per-row key ``fold_in(fold_in(
PRNGKey(seed), rid), step)`` (threefry, ``prng.py``).  One sampler core
serves both modes, so a request draws the same tokens paged or dense,
alone or in any batch.  ``generate_batch`` stays greedy.

**Speculative decoding** — with ``spec_k > 0`` (paged mode) a small
``draft_model`` runs ``spec_k`` tokens ahead inside each decode burst
round, the target verifies every drafted position in one
T = ``spec_k`` + 1 paged step, and the rejection-sampling rule keeps the
output distribution the target's (greedy output equals non-speculative
greedy output token for token).  The draft's KV pool shadows the target
pool block for block, through the same page tables; it spills and
restores beside the target pool on preemption.  Recurrent targets and
drafts, int8 pools and prefix sharing are refused, as in the reference.

The attention of every step runs through the hand-written CUDA kernels
on a CUDA device (``models/attention.py``).

**Bounded restart** — a failing step is non-attributable, so the engine
restarts: in paged mode every live slot is spilled through the
preemption path and re-queued at its lane's front, then the pool, the
allocator and the state store are rebuilt (a slot whose spill itself
fails — its mamba slab may have advanced in place past the host mirror
— fails alone with ``"lost in engine restart"``); in dense mode the
in-flight slots fail and queued work survives.  ``max_restarts``
consecutive failures fail everything and re-raise, as in the reference.
``fault_plan=`` (``faults.FaultPlan``) injects faults at the seams
``engine_step``, ``admit``, ``submit`` and ``worker``.

**Front-door hooks** — ``stream_cb(rid, new_tokens)`` fires whenever
generated tokens reach the host; ``as_pipeline_filter(use_meta=True)``
reads per-row ``prompt_len``/``lane``/``deadline``/``tag`` metadata and
writes ``status``/``ttft_s``/``n_tokens`` back (``net.py`` serves the
engine over TCP through them).

**Frontends** — ``generate_batch(prompts, extra_embeds=...)`` carries
the VLM's patch embeddings or the encoder-decoder's frames.  The
continuous API carries none: it serves the VLM text-only (dense mode,
as every M-RoPE model), and refuses the encoder-decoder with a
``ValueError`` (``check_continuous``), whose requests the reference
fails.

**Tensor parallelism** — ``mesh=`` (a ``launch.mesh.make_serving_mesh``)
serves the paged engine over N ranks, one per mesh device: the model
becomes a ``sharding.ShardedModel``, its weights and pool lists with one
shard per rank (heads, FFN, ``d_inner``, experts and vocab split;
xLSTM whole), each step runs every rank on its own thread through the
kernels at the rank's shapes, and the logits come back whole to the
sampler on rank 0's device.  Scheduling, page tables, slot state and
spills are the engine's as without a mesh, so the tokens are the
single-device engine's.  ``kv_bytes_per_block`` and the slab bytes count
one device's share.  ``spec_k`` and int8 KV under a mesh raise
``NotImplementedError`` as in the reference.  In dense mode
``share_prefix``, ``spec_k``, int8 KV and ``mesh=`` raise the
reference's ``ValueError``: they need the block pool.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import bridge
from ..models.common import dtype_of, resolve_device
from ..models.encdec import EncDecLM
from ..models.sharding import ShardedModel, normalize_device
from .kv_cache import (ROOT_DIGEST, SPEC_STATE_KEYS, BlockAllocator,
                       CacheFullError, DeviceSlotState, StateStore,
                       chain_digest)
from .scheduler import SchedRequest, Scheduler
from .steps import (greedy_sample, make_dense_burst, make_paged_burst,
                    make_paged_mixed_step, make_paged_spec_burst,
                    make_paged_spec_mixed_step, make_prefill_step,
                    make_sampler_core)


@dataclasses.dataclass
class GenerationResult:
    request_id: int
    prompt: np.ndarray
    tokens: np.ndarray
    latency_s: float
    # "ok" | "timeout" | "expired" | "cancelled" | "overrun" | "error" |
    # "oom" — non-ok results carry whatever tokens were generated before
    # the request was failed
    status: str = "ok"
    ttft_s: Optional[float] = None    # submit -> first generated token
    error: Optional[str] = None       # failure message (status "error")


class _Slot:
    """Per-slot decode state in dense mode: the position is the engine's
    shared ``_pos``; admission samples the first token."""
    __slots__ = ("rid", "prompt", "tokens", "t_submit", "done", "lane",
                 "deadline", "tag", "status", "t_first", "adm_seq")

    def __init__(self, req: SchedRequest, first_token: int,
                 eos_id: Optional[int], max_new: int):
        self.rid = req.rid
        self.prompt = req.prompt
        self.tokens: List[int] = [int(first_token)]
        self.t_submit = req.t_submit
        self.done = (eos_id is not None and int(first_token) == eos_id) \
            or max_new <= 1
        self.lane = req.lane
        self.deadline = req.deadline
        self.tag = req.tag
        self.status = "ok"
        self.t_first: Optional[float] = None
        self.adm_seq = 0


class _PagedSlot:
    """Per-slot decode state in paged mode: the true position counter
    lives in the engine's ``_lengths`` array; this tracks ownership."""
    __slots__ = ("rid", "prompt", "tokens", "t_submit", "done", "blocks",
                 "reserve_left", "prefill_off", "digests", "lane",
                 "deadline", "tag", "status", "t_first", "adm_seq",
                 "spec_rounds", "spec_deficit", "spec_prev")

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
        self.lane = req.lane
        self.deadline = req.deadline
        self.tag = req.tag
        self.status = "ok"
        self.t_first: Optional[float] = None
        self.adm_seq = 0              # admission order (preemption picks
        #                               the youngest batch-lane slot)
        # host mirrors of the speculative slot-state keys (spec engines
        # only): rounds run (PRNG stream position), draft-cache deficit
        # (0/1 positions the draft KV trails the target), and the token
        # at cache position lengths-1 (the deficit catch-up input)
        self.spec_rounds = 0
        self.spec_deficit = 0
        self.spec_prev = 0


_KV_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def check_continuous(model) -> None:
    """Raise unless the continuous API (``submit``/``serve`` and what
    drives them) can serve ``model``: an encoder-decoder needs its
    encoder frames, which a request does not carry (the reference fails
    such requests)."""
    if isinstance(model, EncDecLM):
        raise ValueError(
            "an encoder-decoder needs its encoder frames, which the "
            "continuous API (submit/serve) does not carry: call "
            "generate_batch(prompts, extra_embeds=frames)")


def _check_speculative(model, draft_model, draft_params, mesh,
                       prefill_chunk: int, share_prefix) -> None:
    """The reference's refusals of a speculative (``spec_k > 0``) paged
    engine, in its order and with its messages."""
    if draft_model is None or draft_params is None:
        raise ValueError(
            "spec_k > 0 requires draft_model= and draft_params= "
            "(a small model sharing the target's vocabulary)")
    if mesh is not None:
        raise NotImplementedError(
            "speculative decoding under mesh= is not implemented "
            "yet: the draft pool needs its own sharding specs and "
            "the accept rule a replicated gather per drafted "
            "position")
    if prefill_chunk < 2:
        raise ValueError(
            "spec_k > 0 requires prefill_chunk >= 2: the draft's "
            "deficit catch-up feeds two tokens through the mixed "
            f"megastep, got prefill_chunk={prefill_chunk}")
    for role, m in (("target", model), ("draft", draft_model)):
        if not m.supports_speculative():
            raise ValueError(
                f"spec_k > 0 but the {role} model "
                f"{type(m).__name__} (family={m.cfg.family!r}) "
                "has recurrent layers: rejected tokens roll back by "
                "arithmetic on per-slot lengths, and a recurrent "
                "state slab advanced through rejected tokens cannot "
                "be rolled back.  Serve this family with spec_k=0.")
    tv, dv = model.cfg.vocab_size, draft_model.cfg.vocab_size
    if tv != dv:
        raise ValueError(
            f"draft/target vocab mismatch: target {tv} vs draft {dv} — "
            "speculative decoding requires a shared tokenizer/vocabulary")
    if share_prefix:
        raise ValueError(
            "share_prefix=True is incompatible with spec_k > 0: the "
            "draft KV rides the same page tables as the target, but "
            "COW forks and content registration only cover the "
            "target pool.  Leave share_prefix on auto (speculative "
            "mode disables it) or set it False.")


class ServeEngine:
    def __init__(self, model, params, *, batch_size: int = 4,
                 capacity: int = 256, max_new_tokens: int = 16,
                 cache_dtype=torch.float32, greedy: Optional[bool] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 seed: int = 0, eos_id: Optional[int] = None,
                 paged: Optional[bool] = None, block_size: int = 16,
                 num_blocks: Optional[int] = None, prefill_chunk: int = 32,
                 share_prefix: Optional[bool] = None,
                 num_state_slots: Optional[int] = None, burst: int = 1,
                 trace_logits: bool = False, mesh=None,
                 retain_cap: Optional[int] = None,
                 retain_ttl_s: Optional[float] = None, draft_model=None,
                 draft_params=None, spec_k: int = 0,
                 kv_dtype: Optional[str] = None, fault_plan=None,
                 max_restarts: int = 3, device=None):
        if kv_dtype not in (None, "f32", "bf16", "int8"):
            raise ValueError(
                f"kv_dtype must be 'f32', 'bf16' or 'int8', got {kv_dtype!r}")
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k is not None and top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        # temperature drives the mode: 0 (the default) is exactly the
        # greedy path, > 0 samples; an explicit greedy=True still wins
        self._greedy = (temperature == 0) if greedy is None \
            else bool(greedy) or temperature == 0
        self.temperature = temperature
        self.top_k = top_k
        self.seed = seed
        # paged mode: auto-on when the model supports it
        has_paged = model.supports_paged()
        if paged and not has_paged:
            raise ValueError(
                f"paged=True but {type(model).__name__} does not implement "
                "init_paged_cache/paged_step (or supports_paged() is False)")
        self.paged = has_paged if paged is None else bool(paged)
        if not self.paged:
            # the reference's refusals: each needs the block pool
            if mesh is not None:
                raise ValueError(
                    "mesh= requires paged mode: tensor-parallel serving "
                    "shards the paged block pool (the dense per-slot cache "
                    "has no sharded layout)")
            if share_prefix:
                raise ValueError(
                    "share_prefix=True requires paged mode (the dense cache "
                    "has no block pool to share)")
            if spec_k > 0:
                raise ValueError(
                    "spec_k > 0 requires paged mode: speculative rollback "
                    "is arithmetic on per-slot lengths, which only the "
                    "block-paged cache tracks")
            if kv_dtype == "int8":
                raise ValueError(
                    "kv_dtype='int8' requires paged mode: quantized KV "
                    "lives in the shared block pool (the dense per-slot "
                    "cache stays full precision)")
        if kv_dtype == "int8":
            # the reference's int8 gates
            if spec_k > 0:
                raise ValueError(
                    "kv_dtype='int8' is incompatible with spec_k > 0: the "
                    "draft pool and the greedy verify-identity guarantee "
                    "are not quantization-aware.  Serve quantized without "
                    "speculation (spec_k=0).")
            if mesh is not None:
                raise NotImplementedError(
                    "kv_dtype='int8' under mesh= is not implemented yet: "
                    "the f32 scale pools need audited sharding specs "
                    "before the quantized pool can be distributed")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        self.spec_k = int(spec_k)
        self.draft_model = draft_model
        self.draft_params = draft_params
        self._spec = self.spec_k > 0
        if self._spec:
            _check_speculative(model, draft_model, draft_params, mesh,
                               prefill_chunk, share_prefix)
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        # tensor-parallel serving over a mesh: the model becomes one rank
        # model per mesh device (sharding.ShardedModel), whose weights and
        # pools are lists with one entry per rank; the engine, its slot
        # state and its sampler live on rank 0's device
        self.mesh = mesh
        if mesh is not None:
            model = ShardedModel(model, mesh)
            if device is not None and normalize_device(device) != model.device:
                raise ValueError(f"mesh= runs rank 0 on {model.device}, "
                                 f"not on the engine's device {device}")
            self.device = model.device
        else:
            self.device = resolve_device(device)
            for role, m in (("model", model), ("draft model", draft_model)):
                if m is not None and m.device != self.device:
                    raise ValueError(f"{role} lives on {m.device}, engine on "
                                     f"{self.device}: build both on one "
                                     "device")
        if kv_dtype in _KV_DTYPES:
            cache_dtype = _KV_DTYPES[kv_dtype]
        compute = dtype_of(model.cfg.compute_dtype)
        if compute == torch.bfloat16 and kv_dtype == "int8":
            # the reference cannot serve this either: the dequantized K/V
            # are f32 and promote the attention output and the residual
            # stream out of bf16, which fails its first step
            raise ValueError(
                "a bf16 model with kv_dtype='int8' is not supported: the "
                "dequantized K/V are f32; serve an f32 model, or a bf16 "
                "model with kv_dtype='bf16'")
        if compute == torch.bfloat16 and cache_dtype == torch.float32 \
                and (model.has_kv_cache() or (
                    not self.paged and model.has_cache_typed_state())):
            # the reference cannot serve this either: f32 K/V or an f32
            # latent cache promote the residual stream out of bf16, which
            # fails its first step; in dense mode an f32 mamba conv window
            # changes the decode carry's type, which fails its first
            # decode step.  The paged mamba step casts the window it reads
            # to the compute type, and the xLSTM carries are f32 whatever
            # the cache type: a stack of those serves paged, as in the
            # reference (the xLSTM one dense too)
            raise ValueError(
                "a bf16 model with an f32 KV pool is not supported: pass "
                "kv_dtype='bf16'")
        self.model = model
        self.params = model.shard(params) if mesh is not None else params
        self.batch_size = batch_size
        self.capacity = capacity
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.cache_dtype = cache_dtype
        self.kv_dtype = kv_dtype
        self.max_burst = int(burst)
        self.burst = int(burst)
        self.scheduler = Scheduler()
        self._slots: List[Any] = [None] * batch_size
        self._cache = None            # dense mode: the live cache
        self._pos = 0                 # dense mode: shared decode position
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
        # recurrent state slabs disable prefix sharing: a slab summarizes
        # the whole prefix, so resident KV pages alone cannot seed a joiner
        sharable = not self.paged or model.supports_prefix_sharing()
        if share_prefix and not sharable:
            raise ValueError(
                f"share_prefix=True but {type(model).__name__} "
                f"(family={model.cfg.family!r}) "
                "has recurrent layers whose state cannot be shared across "
                "requests: a mamba/xLSTM state slab summarizes its entire "
                "prefix, so mapping resident KV pages cannot reconstruct "
                "it.  Run with share_prefix=False (or leave it on auto).")
        self.share_prefix = (self.paged and sharable) \
            if share_prefix is None else bool(share_prefix)
        if self._spec:
            # the draft KV rides the target's page tables, but COW forks
            # and content registration only cover the target pool
            self.share_prefix = False
        self._pages_per_slot = -(-capacity // block_size)
        if num_blocks is None:
            num_blocks = batch_size * self._pages_per_slot
        self.allocator = BlockAllocator(num_blocks, block_size,
                                        retain_cap=retain_cap,
                                        retain_ttl_s=retain_ttl_s) \
            if self.paged else None
        self._page_table = np.zeros((batch_size, self._pages_per_slot),
                                    np.int32)
        # recurrent families: per-slot state slabs beside the block pool
        needs_state = self.paged and model.has_recurrent_state()
        self.num_state_slots = (batch_size if num_state_slots is None
                                else num_state_slots) if needs_state else 0
        self.state_store = StateStore(self.num_state_slots) \
            if needs_state else None
        self._lengths = np.zeros((batch_size,), np.int32)
        self._state_slots = np.zeros((batch_size,), np.int32)
        self._reserved = 0            # lazily-claimable blocks promised out
        self._paged_cache = None
        self._draft_cache = None      # spec: the draft's shadow pool
        self._prefill = make_prefill_step(model, capacity, cache_dtype)
        # both modes draw tokens through one sampler core, so a given
        # (seed, request, step) yields the same token either way; the
        # megasteps call it, and the dense admission wave calls it alone
        self._sample = make_sampler_core(seed, greedy=self._greedy,
                                         temperature=temperature or 1.0,
                                         top_k=top_k)
        if self.paged and self._spec:
            self._mixed_fn = make_paged_spec_mixed_step(
                model, draft_model, self._sample, eos_id=eos_id,
                max_new=max_new_tokens, capacity=capacity)
            self._burst_fn = make_paged_spec_burst(
                model, draft_model, eos_id=eos_id, max_new=max_new_tokens,
                capacity=capacity, spec_k=self.spec_k,
                k_static=self.max_burst, seed=seed, greedy=self._greedy,
                temperature=temperature or 1.0, top_k=top_k,
                trace=trace_logits)
        elif self.paged:
            self._mixed_fn = make_paged_mixed_step(
                model, self._sample, eos_id=eos_id, max_new=max_new_tokens,
                capacity=capacity)
            self._burst_fn = make_paged_burst(
                model, self._sample, eos_id=eos_id, max_new=max_new_tokens,
                capacity=capacity, k_static=self.max_burst,
                trace=trace_logits)
        else:
            self._mixed_fn = None
            self._burst_fn = make_dense_burst(
                model, self._sample, eos_id=eos_id, max_new=max_new_tokens,
                k_static=self.max_burst, trace=trace_logits)
        # True while a paged step runs: its mamba slabs are updated in
        # place, so after a failed step they may be ahead of the host
        # mirror and a decoding slot's spill would not restore it
        self._slabs_ahead = False
        self._adm_seq = 0             # admission order counter
        # token-streaming hook: stream_cb(rid, new_tokens) fires whenever
        # generated tokens for a request reach the host (once per slot per
        # drain); the network front door streams them back per request
        self.stream_cb = None
        # optional per-request logit recording (conformance tests): the
        # f32 logits of every generated token, in order
        self.trace_logits = trace_logits
        self.logit_trace: Dict[int, List[np.ndarray]] = {}
        # slot state on the device: uploaded (copied) only after
        # structural host mutations, otherwise replaced by each megastep
        self._dev = DeviceSlotState(
            put=lambda v: torch.tensor(v, device=self.device))
        # scheduler counters
        self.n_batches = 0            # prefill launches (generate_batch,
        #                     dense admission waves, completed paged prefills)
        self.last_batch_latency_s = 0.0
        self.n_requests = 0
        self.n_prefills = 0
        self.n_joins = 0              # requests admitted mid-decode
        self.n_evictions = 0          # slots freed by eos/max_new
        self.n_prefill_chunks = 0     # bounded prefill steps run
        self.n_prefix_hits = 0        # admissions that mapped blocks
        self.n_shared_tokens = 0      # prompt tokens served from shared blocks
        self.n_cow_forks = 0          # shared blocks forked before a write
        self.n_preemptions = 0        # slots spilled to host (or restarted)
        self.n_restores = 0           # preempted requests re-admitted
        self.n_expired = 0            # queued requests past their deadline
        # decode-loop counters (see loop_stats())
        self.n_bursts = 0             # burst launches (>= 1 device step each)
        self.n_device_steps = 0       # megasteps executed
        self.n_host_syncs = 0         # decode-loop device->host drains
        self.n_flag_reads = 0         # burst early-out reads of `active`
        self.n_burst_early_exits = 0  # bursts cut short by all-done
        # speculative-decode counters (see loop_stats())
        self.n_spec_rounds = 0        # draft+verify rounds executed
        self.n_spec_tokens = 0        # tokens emitted by those rounds
        self.n_draft_proposed = 0     # draft tokens offered to the verifier
        self.n_draft_accepted = 0     # draft tokens the verifier accepted
        # per-round accepted-length histogram: bin a counts rounds that
        # accepted exactly a draft tokens (a in [0, spec_k])
        self.spec_accept_hist = [0] * (self.spec_k + 1) if self._spec else []
        # fault injection (``faults.FaultPlan``, duck-typed: None costs
        # one check per seam) + bounded-restart accounting for
        # non-attributable step failures
        self.fault_plan = fault_plan
        self.max_restarts = int(max_restarts)
        self.n_step_failures = 0      # step() exceptions caught
        self.n_restarts = 0           # engine pool rebuilds performed
        self.n_cancelled = 0          # requests cancelled via cancel()
        self._consec_failures = 0     # resets on every clean step

    # -- synchronous fixed batch API ------------------------------------------
    def generate_batch(self, prompts: np.ndarray,
                       extra_embeds=None) -> np.ndarray:
        """prompts: (B, S) int32 -> generated (B, max_new_tokens), greedy:
        one prefill, then ``max_new_tokens - 1`` dense decode steps at
        positions S, S+1, ...  (in either mode: it runs the model's dense
        steps, not the engine's cache).  ``extra_embeds`` (numpy or a
        tensor, uploaded to the engine's device): the VLM's patch
        embeddings, or the encoder-decoder's frames, which only this
        entry carries."""
        B, S = prompts.shape
        if B != self.batch_size:
            raise ValueError(f"generate_batch takes batch_size="
                             f"{self.batch_size} prompts, got {B}")
        t0 = time.perf_counter()
        with torch.inference_mode():
            return self._generate_batch_impl(prompts, extra_embeds, t0)

    def _generate_batch_impl(self, prompts, extra_embeds, t0):
        B, S = prompts.shape
        tokens = torch.as_tensor(np.asarray(prompts, np.int32),
                                 device=self.device)
        if extra_embeds is not None:
            extra_embeds = bridge.leaf_to_torch(extra_embeds, self.device)
        logits, cache = self._prefill(self.params, tokens, extra_embeds)
        token = greedy_sample(logits)[:, None]
        out = [token]
        pos = S
        for _ in range(self.max_new_tokens - 1):
            logits, cache = self.model.decode_step(self.params, cache, token,
                                                   pos)
            token = greedy_sample(logits)[:, None]
            out.append(token)
            pos += 1
        gen = torch.cat(out, dim=1).cpu().numpy()
        self.n_batches += 1
        self.n_requests += B
        self.last_batch_latency_s = time.perf_counter() - t0
        return gen

    # -- continuous batching ------------------------------------------------
    def submit(self, prompt: np.ndarray, *, lane: str = "interactive",
               deadline: Optional[float] = None, tag: Any = None) -> int:
        """Enqueue a request; returns its request id (thread-safe).

        ``lane`` picks the priority lane (``"interactive"`` admits ahead
        of any queued ``"batch"`` work and may preempt running batch
        slots); ``deadline`` is a relative TTFT budget in seconds — a
        request still queued when it elapses fails with status
        ``"expired"``; ``tag`` is an opaque caller handle."""
        check_continuous(self.model)
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
            self.scheduler.push(SchedRequest(
                rid, prompt, lane=lane,
                deadline=None if deadline is None else now + deadline,
                tag=tag, t_submit=now))
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
        layer's pools — K and V, plus the f32 ``k_scale``/``v_scale``
        rows under ``kv_dtype='int8'``, as the reference's leaf-name rule
        counts them; 0 in dense mode (no block pool).  A stack without
        attention has no such leaf, and the reference then counts every
        leaf of the paged cache, its state slabs (sized by slots, not
        blocks): their bytes over ``num_blocks``, floored."""
        if self.allocator is None:
            return 0
        cfg = self.model.cfg
        if self.model.n_attn_layers() == 0:
            return self.model.state_slab_bytes(
                self.num_state_slots, self.cache_dtype) \
                // self.allocator.num_blocks
        # under a mesh, one device's share: the rank with most KV heads
        n_kv = max(c.n_kv_heads for c in self.model.rank_cfgs) \
            if self.mesh is not None else cfg.n_kv_heads
        hd = cfg.resolved_head_dim
        if self.kv_dtype == "int8":
            row = 2 * hd + 2 * 4              # int8 K, V + two f32 scales
        else:
            row = 2 * hd * torch.empty(
                (), dtype=self.cache_dtype).element_size()
        return self.model.n_attn_layers() * self.block_size * n_kv * row

    def pool_stats(self) -> Optional[Dict[str, Any]]:
        """Block-pool occupancy incl. shared vs private split, plus
        state-slab occupancy for recurrent families, plus the pool
        footprint: ``kv_dtype``, ``bytes_per_block`` and ``pool_bytes``.
        None in dense mode (no block pool), as in the reference."""
        if self.allocator is None:
            return None
        stats: Dict[str, Any] = self.allocator.stats()
        stats["n_reserved"] = self._reserved
        stats["kv_dtype"] = "int8" if self.kv_dtype == "int8" else \
            {torch.float32: "f32", torch.bfloat16: "bf16"}[self.cache_dtype]
        stats["bytes_per_block"] = self.kv_bytes_per_block()
        stats["pool_bytes"] = \
            stats["bytes_per_block"] * self.allocator.num_blocks
        if self.state_store is not None:
            s = self.state_store.stats()
            stats["num_state_slots"] = s["num_slots"]
            stats["n_state_free"] = s["n_free"]
            stats["n_state_live"] = s["n_live"]
        return stats

    def loop_stats(self) -> Dict[str, int]:
        """Decode-loop counters: device steps vs host drains vs state
        uploads (``n_state_uploads`` counts host->device slot-state
        rebuilds — structural events only).  ``n_host_syncs`` counts the
        reference's syncs (one token drain per burst or mixed step);
        ``n_flag_reads``, which the reference does not have, counts the
        burst loop's blocking reads of the ``active`` flags (one per
        step, plus one at an early exit).  A speculative engine adds its
        round counters, the accepted-length histogram and the accept
        rate."""
        out = {"burst": self.burst, "max_burst": self.max_burst,
               "n_bursts": self.n_bursts,
               "n_device_steps": self.n_device_steps,
               "n_host_syncs": self.n_host_syncs,
               "n_flag_reads": self.n_flag_reads,
               "n_burst_early_exits": self.n_burst_early_exits,
               "n_state_uploads": self._dev.n_uploads}
        if self._spec:
            out.update(
                spec_k=self.spec_k,
                n_spec_rounds=self.n_spec_rounds,
                n_spec_tokens=self.n_spec_tokens,
                n_draft_proposed=self.n_draft_proposed,
                n_draft_accepted=self.n_draft_accepted,
                spec_accept_hist=list(self.spec_accept_hist),
                spec_accept_rate=self.n_draft_accepted
                / max(1, self.n_draft_proposed))
        return out

    def step(self) -> List[GenerationResult]:
        """Admit what fits, run one decode burst (or a mixed
        prefill+decode megastep, or a dense prefill wave), evict what
        finished.  Returns results for requests that completed during
        this step.

        A step exception is *non-attributable* (no way to know which
        resident request poisoned the step), so the engine restarts:
        paged mode spills the live slots through the preemption path and
        re-queues them, dense mode fails them with ``"lost in engine
        restart"``; queued work survives and the pools are rebuilt.
        Restarts are bounded by ``max_restarts`` *consecutive* failures;
        past that every in-flight and queued request is failed and the
        exception propagates."""
        fault = self.fault_plan.fire("engine_step") if self.fault_plan \
            else None
        with torch.inference_mode():
            try:
                if fault is not None and fault.action == "raise":
                    raise fault.make_exc()
                out = self._step_paged() if self.paged \
                    else self._step_dense()
            except Exception as exc:
                return self._handle_step_failure(exc)
        self._consec_failures = 0
        return out

    def _handle_step_failure(self, exc: Exception) -> List[GenerationResult]:
        """Recover from a step exception: bounded restart (spill or fail
        the survivors, rebuild the pools) or, past the budget, fail
        everything and re-raise."""
        self.n_step_failures += 1
        self._consec_failures += 1
        if self._consec_failures > self.max_restarts:
            now = time.monotonic()
            msg = f"engine wedged after {self.n_restarts} restarts: {exc}"
            with self._lock:
                queued = list(self.scheduler.candidates())
                for req in queued:
                    self.scheduler.remove(req)
            for req in queued:
                self._finish(GenerationResult(
                    request_id=req.rid, prompt=req.prompt,
                    tokens=np.asarray(req.tokens, np.int32),
                    latency_s=now - req.t_submit, status="error", error=msg))
            self._fail_slots(msg, now)
            self._reset_pools()        # nothing leaks even in death
            raise exc
        self.n_restarts += 1
        self._restart()
        return []

    def _fail_slots(self, msg: str, now: float) -> None:
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            self._finish(GenerationResult(
                request_id=slot.rid, prompt=slot.prompt,
                tokens=np.asarray(slot.tokens, np.int32),
                latency_s=now - slot.t_submit, status="error", error=msg))
            self._slots[i] = None

    def _restart(self) -> None:
        """Rebuild the serving pools after a step failure.  Paged mode:
        every live slot is spilled through the preemption path (decoding
        slots gather their pages and slab to host memory, mid-prefill
        slots simply restart) and re-queued at its lane's front; a slot
        whose spill itself fails is failed alone with ``"lost in engine
        restart"``.  Dense mode has no spill path: every live slot is
        failed.  Queued work survives untouched."""
        now = time.monotonic()
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            spilled = False
            if self.paged and not slot.done:
                try:
                    self._preempt_slot(i)
                    spilled = True
                except Exception:
                    pass               # unsalvageable: fail it below
            if not spilled:
                self._finish(GenerationResult(
                    request_id=slot.rid, prompt=slot.prompt,
                    tokens=np.asarray(slot.tokens, np.int32),
                    latency_s=now - slot.t_submit, status="error",
                    error="lost in engine restart"))
            self._slots[i] = None
        self._reset_pools()

    def _reset_pools(self) -> None:
        """Rebuild the caches and the host accounting from scratch (all
        slots must already be empty); the device slot state is rebuilt
        on next use.  Paged mode: a fresh allocator (the old one's
        content table is cleared: it advertises KV of a dropped pool)
        and state store, the pool dropped."""
        if self.paged:
            old = self.allocator
            old.clear_registry()
            self.allocator = BlockAllocator(
                old.num_blocks, old.block_size,
                retain_cap=old.retain_cap, retain_ttl_s=old.retain_ttl_s)
            if self.state_store is not None:
                self.state_store = StateStore(self.num_state_slots)
            self._paged_cache = None
            self._draft_cache = None
        else:
            self._cache = None
            self._pos = 0
        self._slabs_ahead = False
        self._reserved = 0
        self._page_table[:, :] = 0
        self._lengths[:] = 0
        self._state_slots[:] = 0
        self._dev.mark_dirty()

    def cancel(self, rid: int, status: str = "cancelled") -> bool:
        """Cancel one request wherever it is: queued, or in flight (its
        result carries every token generated so far).  Returns True if
        the request was live and is now terminal with ``status``; False
        if it was unknown or already finished (the existing result is
        left for its waiter)."""
        with self._results_cv:
            if rid in self._results:
                return False
        self._cancel([rid], status)
        with self._results_cv:
            done = rid in self._results
        if done:
            self.n_cancelled += 1
        return done

    def inflight_rids(self) -> List[int]:
        """Rids with no result yet: queued plus resident in a slot."""
        with self._lock:
            queued = [req.rid for req in self.scheduler.candidates()]
        return queued + [s.rid for s in self._slots if s is not None]

    def serve(self, requests: List[np.ndarray], timeout_s: float = 120.0,
              lane: str = "interactive") -> List[GenerationResult]:
        """Serve via continuous batching; results in request order.

        On timeout the results completed before the deadline are
        returned as-is and every unfinished request is failed with
        status ``"timeout"`` (its tokens so far attached)."""
        rids = [self.submit(r, lane=lane) for r in requests]
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
            dirty = False
            dead_blocks: List[int] = []
            for slot in self._slots:
                if slot is not None and slot.rid in rids:
                    slot.status = status
                    slot.done = True
                    if self.paged:
                        dead_blocks += list(slot.blocks)
                    dirty = True
            if dirty:
                self._evict_paged() if self.paged else self._evict()
                # a cancelled request's pages must not linger as
                # retained prefix bait
                for b in dead_blocks:
                    self.allocator.retire(b)

    def as_pipeline_filter(self, *, use_meta: bool = False,
                           on_submit=None, timeout_s: Optional[float] = None):
        """Adapter: (n, S) prompt batch -> (n, max_new_tokens) generations,
        numpy in and out.

        Row order in == row order out, so TensorUnbatcher downstream can
        restore per-request pts/meta.  Rows shorter than max_new (early
        eos) are right-padded with eos_id (or 0), as are rows that failed
        at submit (per-row isolation: a bad prompt fails only its own
        row).

        With ``use_meta`` the returned callable accepts the per-row meta
        dicts a ``pass_meta`` TensorFilter forwards: each row's
        ``meta["query"]`` may carry ``prompt_len`` (strip transport
        left-padding), ``lane``, ``deadline`` (relative seconds) and
        ``tag``; after serving, ``status`` / ``ttft_s`` / ``n_tokens``
        (and ``error``) are written back into the meta.
        ``on_submit(rid, meta)`` fires right after each row is submitted,
        before any token is generated, so a streaming front door can
        route ``stream_cb`` tokens by request id."""
        pad = self.eos_id if self.eos_id is not None else 0

        def fn(prompts, metas=None):
            prompts = np.asarray(prompts, np.int32)
            ms = list(metas) if (use_meta and metas is not None) \
                else [None] * len(prompts)
            rids: List[Optional[int]] = []
            for row, m in zip(prompts, ms):
                q = m.get("query", {}) if isinstance(m, dict) else {}
                plen = int(q.get("prompt_len", 0)) or row.shape[0]
                # per-row isolation: a poison prompt (bad shape, vocab
                # overflow, injected "submit" fault) fails only its row
                try:
                    f = self.fault_plan.fire("submit") if self.fault_plan \
                        else None
                    if f is not None and f.action == "raise":
                        raise f.make_exc()
                    rid = self.submit(row[row.shape[0] - plen:],
                                      lane=q.get("lane", "interactive"),
                                      deadline=q.get("deadline"),
                                      tag=q.get("tag"))
                except Exception as exc:
                    rids.append(None)
                    if isinstance(m, dict):
                        m.update(status="error", error=str(exc), n_tokens=0)
                    continue
                rids.append(rid)
                if isinstance(m, dict):
                    m["rid"] = rid
                if on_submit is not None:
                    on_submit(rid, m)
            live = [r for r in rids if r is not None]
            err = None
            try:
                f = self.fault_plan.fire("worker") if self.fault_plan \
                    else None
                if f is not None and f.action == "raise":
                    raise f.make_exc()
                results = self.wait(live, timeout_s=timeout_s)
            except Exception as exc:
                # worker-level failure after submission: fail exactly
                # this batch's requests (with a clean pool) and surface
                # the message; other workers' requests keep going
                err = str(exc)
                self._cancel(live, "error")
                with self._results_cv:
                    results = [self._results.pop(r) for r in live
                               if r in self._results]
            by_id = {r.request_id: r for r in results}
            out = np.full((len(rids), self.max_new_tokens), pad, np.int32)
            for i, rid in enumerate(rids):
                if rid is None:
                    continue          # failed at submit; meta already set
                r = by_id.get(rid)
                if r is None:
                    if isinstance(ms[i], dict):
                        ms[i].update(status="error", n_tokens=0,
                                     error=err or "request lost")
                    continue
                out[i, : len(r.tokens)] = r.tokens
                if isinstance(ms[i], dict):
                    ms[i].update(status=r.status, ttft_s=r.ttft_s,
                                 n_tokens=int(len(r.tokens)))
                    if r.status == "error":
                        ms[i]["error"] = r.error or err or "request failed"
            return out
        return fn

    # -- device-resident slot state -----------------------------------------
    def _dense_state(self) -> Dict[str, np.ndarray]:
        """Host rebuild of the dense-mode device state (dirty path)."""
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
            tokens[i] = s.tokens[-1]
            active[i] = not s.done
        return {"tokens": tokens, "rids": rids, "steps": steps,
                "active": active}

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
        out = {"tokens": tokens, "rids": rids, "steps": steps,
               "active": active, "page_table": self._page_table,
               "lengths": self._lengths, "state_slots": self._state_slots}
        if self._spec:
            slots = [(i, s) for i, s in enumerate(self._slots)
                     if s is not None]
            for key in SPEC_STATE_KEYS:
                arr = np.zeros((B,), np.int32)
                for i, s in slots:
                    arr[i] = getattr(s, key)
                out[key] = arr
        return out

    def _drain_burst(self, tok_buf, val_buf, logit_buf, *, k: int) -> None:
        """One host sync per burst: fetch the token ring buffer, append
        tokens to their slots, and replay the device-side done rule (eos
        / max_new / paged: cache exhausted) so the host mirror stays
        coherent with the device's ``active`` flags; then hand each
        slot's new tokens to ``stream_cb``.  Dense mode advances the
        shared position by the steps the burst ran."""
        toks, valid = tok_buf.cpu().numpy(), val_buf.cpu().numpy()
        logits = None if logit_buf is None else logit_buf.cpu().numpy()
        self.n_host_syncs += 1
        paged = self.paged
        n_steps = int(valid.any(axis=1).sum())
        self.n_bursts += 1
        self.n_device_steps += n_steps
        if n_steps < k:
            self.n_burst_early_exits += 1
        fresh: Dict[int, List[int]] = {}
        for kstep in range(n_steps):
            for i, slot in enumerate(self._slots):
                if slot is None or not valid[kstep, i]:
                    continue
                if logits is not None:
                    self.logit_trace.setdefault(slot.rid, []).append(
                        logits[kstep, i].copy())
                slot.tokens.append(int(toks[kstep, i]))
                fresh.setdefault(i, []).append(slot.tokens[-1])
                if paged:
                    self._lengths[i] += 1
                if ((self.eos_id is not None
                     and slot.tokens[-1] == self.eos_id)
                        or len(slot.tokens) >= self.max_new_tokens
                        or (paged
                            and int(self._lengths[i]) >= self.capacity)):
                    slot.done = True
        if not paged:
            self._pos += n_steps
        now = time.monotonic()
        for i, new_toks in fresh.items():
            slot = self._slots[i]
            if slot.t_first is None:
                slot.t_first = now
            if self.stream_cb is not None:
                self.stream_cb(slot.rid, new_toks)

    def _drain_spec_burst(self, tok_buf, val_buf, logit_buf, *,
                          k: int) -> None:
        """Speculative-burst drain: the rings are ``(k, B, spec_k+1)``;
        round ``r`` emitted slot ``b``'s tokens at the valid positions,
        always a contiguous prefix (accepted drafts, then one replacement
        or bonus token, cut at eos).  Replays the device-side done rule
        per token and the spec-field update (``spec_rounds`` /
        ``spec_deficit`` / ``spec_prev``) per round, so the host mirror
        can rebuild the device state after any structural event, and
        accumulates the acceptance statistics."""
        toks, valid = tok_buf.cpu().numpy(), val_buf.cpu().numpy()
        logits = None if logit_buf is None else logit_buf.cpu().numpy()
        self.n_host_syncs += 1
        n_rounds = int(valid.any(axis=(1, 2)).sum())
        self.n_bursts += 1
        self.n_device_steps += n_rounds
        if n_rounds < k:
            self.n_burst_early_exits += 1
        fresh: Dict[int, List[int]] = {}
        for r in range(n_rounds):
            for i, slot in enumerate(self._slots):
                if slot is None or not valid[r, i].any():
                    continue
                # the round's draft budget, from the pre-round host
                # mirrors (the device's formula)
                gb = max(0, min(self.max_new_tokens - len(slot.tokens) - 1,
                                self.capacity - int(self._lengths[i]) - 1,
                                self.spec_k))
                m = int(valid[r, i].sum())
                for j in range(m):
                    if logits is not None:
                        self.logit_trace.setdefault(slot.rid, []).append(
                            logits[r, i, j].copy())
                    slot.tokens.append(int(toks[r, i, j]))
                    fresh.setdefault(i, []).append(slot.tokens[-1])
                    self._lengths[i] += 1
                    if ((self.eos_id is not None
                         and slot.tokens[-1] == self.eos_id)
                            or len(slot.tokens) >= self.max_new_tokens
                            or int(self._lengths[i]) >= self.capacity):
                        slot.done = True
                slot.spec_rounds += 1
                slot.spec_deficit = 1 if m == gb + 1 else 0
                L = int(self._lengths[i])
                slot.spec_prev = self._seq_tokens(slot, L - 1, L)[0]
                self.n_spec_rounds += 1
                self.n_spec_tokens += m
                self.n_draft_proposed += gb
                # the round's last emitted token is the replacement or
                # bonus draw, everything before it an accepted draft (a
                # round cut short by an eos inside the drafted prefix
                # under-counts by one; the slot finishes then)
                self.n_draft_accepted += m - 1
                self.spec_accept_hist[min(m - 1, self.spec_k)] += 1
        now = time.monotonic()
        for i, new_toks in fresh.items():
            slot = self._slots[i]
            if slot.t_first is None:
                slot.t_first = now
            if self.stream_cb is not None:
                self.stream_cb(slot.rid, new_toks)

    def _sample_rows(self, logits, rids: np.ndarray,
                     steps: np.ndarray) -> np.ndarray:
        """Draw one token per batch row through the shared sampler (the
        dense admission wave; the decode loop samples inside the
        megastep).  The per-row key comes from ``rids``/``steps`` alone,
        so a slot's draw is a function of (seed, request, step) in either
        mode.  Idle rows carry (0, 0); callers read only the rows they
        filled."""
        put = self._dev.put
        return self._sample(logits, put(rids), put(steps)).cpu().numpy()

    # -- dense scheduler ----------------------------------------------------
    def _step_dense(self) -> List[GenerationResult]:
        """One engine tick in dense mode: admit (a fresh prefill wave, or
        joiners that fit the shared position), then one decode burst at
        the shared position — K = 1 while requests are queued, capped at
        the cache strip's remainder; an exhausted strip truncates every
        in-flight request."""
        self._admit()
        finished = self._evict()
        if self.n_active == 0:
            return finished
        if self._pos >= self.capacity:
            for slot in self._slots:
                if slot is not None:
                    slot.done = True
            return finished + self._evict()
        with self._lock:
            pending = self.scheduler.pending
        k = 1 if pending else min(self.burst, self.max_burst)
        k = max(1, min(k, self.capacity - self._pos))
        st = self._dev.device(self._dense_state)
        self._cache, st, tok_buf, val_buf, n_reads, logit_buf = \
            self._burst_fn(self.params, self._cache, st, self._pos, k)
        self._dev.adopt(st)
        self.n_flag_reads += n_reads
        self._drain_burst(tok_buf, val_buf, logit_buf, k=k)
        return finished + self._evict()

    def _admit(self) -> None:
        """Dense admission.  With no request in flight, a fresh wave takes
        up to one request per free slot (FIFO), re-anchors ``_pos`` to its
        longest prompt and prefills them left-padded into a new cache.
        Mid-decode, only prompts with ``len <= _pos`` join (the whole
        queue is scanned: a long prompt never blocks a short one behind
        it); they are left-padded to ``_pos``, the whole (B, _pos) batch
        is prefilled once, and the joiners' rows are spliced into the
        live cache.  The first token is sampled from the prefill.
        Candidates come in lane-priority order; queued requests past
        their deadline expire first."""
        self._expire_queued()
        free = [i for i, s in enumerate(self._slots) if s is None]
        if not free:
            return
        with self._lock:
            if not self.scheduler.pending:
                return
            if self.n_active == 0:
                self._cache = None
                take = list(self.scheduler.candidates())[:len(free)]
                for req in take:
                    self.scheduler.remove(req)
                joins = list(zip(free, take))
                fresh = True
            elif self._pos >= self.capacity:
                # cache exhausted: in-flight slots are about to be
                # truncated; hold newcomers for the fresh re-anchor
                return
            else:
                joins = []
                for req in self.scheduler.candidates():
                    if len(joins) < len(free) \
                            and req.prompt.shape[0] <= self._pos:
                        self.scheduler.remove(req)
                        joins.append((free[len(joins)], req))
                fresh = False
        if not joins:
            return
        B = self.batch_size
        if fresh:
            self._pos = max(req.prompt.shape[0] for _, req in joins)
        batch = np.zeros((B, self._pos), np.int32)
        for slot_i, req in joins:
            batch[slot_i, self._pos - req.prompt.shape[0]:] = req.prompt
        logits, cache = self._prefill(
            self.params, torch.as_tensor(batch, device=self.device))
        if self._greedy:
            first_np = greedy_sample(logits).cpu().numpy()
        else:
            rids = np.zeros((B,), np.int32)
            for slot_i, req in joins:
                rids[slot_i] = req.rid
            first_np = self._sample_rows(logits, rids,
                                         np.zeros((B,), np.int32))
        self.n_prefills += 1
        self.n_batches += 1
        if fresh:
            self._cache = cache
        else:
            self._splice_cache(self._cache, cache,
                               [slot_i for slot_i, _ in joins])
            self.n_joins += len(joins)
        logits_np = logits.float().cpu().numpy() if self.trace_logits \
            else None
        now = time.monotonic()
        for slot_i, req in joins:
            if logits_np is not None:
                self.logit_trace.setdefault(req.rid, []).append(
                    logits_np[slot_i].copy())
            slot = _Slot(req, first_np[slot_i], self.eos_id,
                         self.max_new_tokens)
            slot.t_first = now
            slot.adm_seq = self._adm_seq
            self._adm_seq += 1
            self._slots[slot_i] = slot
            if self.stream_cb is not None:
                self.stream_cb(slot.rid, [slot.tokens[-1]])
        self._dev.mark_dirty()

    def _evict(self) -> List[GenerationResult]:
        """Dense eviction: finished slots leave; their cache rows stay
        until a joiner's splice or the next wave overwrites them."""
        out: List[GenerationResult] = []
        now = time.monotonic()
        for i, slot in enumerate(self._slots):
            if slot is None or not slot.done:
                continue
            res = self._make_result(slot, now)
            out.append(res)
            self._finish(res)
            self._slots[i] = None
            self.n_evictions += 1
        return out

    def _splice_cache(self, live, fresh, slot_ids: List[int]) -> None:
        """Copy the joiners' rows of a fresh prefill cache into the live
        cache, in place.  The batch axis is known by construction: axis 1
        of the stacked ``blocks/s{j}`` leaves (after the layer axis),
        axis 0 of the ``prefix`` leaves."""
        sel = torch.as_tensor(slot_ids, dtype=torch.long, device=self.device)
        for st, new in zip(live.get("prefix", []), fresh.get("prefix", [])):
            for name, leaf in st.items():
                leaf[sel] = new[name][sel]
        for j, st in live["blocks"].items():
            for name, leaf in st.items():
                leaf[:, sel] = fresh["blocks"][j][name][:, sel]

    # -- paged scheduler ----------------------------------------------------
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
        self._slabs_ahead = True
        if self._spec:
            self._paged_cache, self._draft_cache, st, sampled, logits = \
                self._mixed_fn(self.params, self.draft_params,
                               self._paged_cache, self._draft_cache, st,
                               put(tokens), put(t_valid), put(emit))
        else:
            self._paged_cache, st, sampled, logits = self._mixed_fn(
                self.params, self._paged_cache, st, put(tokens),
                put(t_valid), put(emit))
        self._dev.adopt(st)
        self.n_prefill_chunks += 1
        self.n_device_steps += 1
        sampled_np = sampled.cpu().numpy()
        logits_np = logits.float().cpu().numpy() if self.trace_logits \
            else None
        self.n_host_syncs += 1
        for i, slot in busy:
            if not t_valid[i]:
                continue
            was_prefilling = slot.prefill_off < len(slot.prompt)
            self._lengths[i] += t_valid[i]
            if self._spec:
                # replay of the device-side spec-field update: consuming
                # any chunk catches the draft cache up (deficit 0) and the
                # chunk's last token sits at position lengths-1
                slot.spec_deficit = 0
                slot.spec_prev = int(tokens[i, int(t_valid[i]) - 1])
            if was_prefilling:
                slot.prefill_off += int(t_valid[i])
                if slot.prefill_off < len(slot.prompt):
                    continue          # more chunks to go; no token yet
                self.n_prefills += 1
                self.n_batches += 1   # the reference's alias, paged too
            if logits_np is not None:
                self.logit_trace.setdefault(slot.rid, []).append(
                    logits_np[i].copy())
            slot.tokens.append(int(sampled_np[i]))
            if slot.t_first is None:
                slot.t_first = time.monotonic()
            if self.stream_cb is not None:
                self.stream_cb(slot.rid, [slot.tokens[-1]])
            # replay of the megastep's device-side done rule
            if ((self.eos_id is not None and slot.tokens[-1] == self.eos_id)
                    or len(slot.tokens) >= self.max_new_tokens
                    or int(self._lengths[i]) >= self.capacity):
                slot.done = True
        self._slabs_ahead = False

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
            # a plain burst writes at most k tokens; a speculative one
            # writes up to spec_k+1 positions per round (even rejected
            # drafts are written, then rolled back by arithmetic).  Both
            # stop at max_new (final length = prompt + max_new - 1, and
            # the per-round draft budget keeps every write under that
            # too) and at capacity
            span = (self.spec_k + 1) if self._spec else 1
            target = min(L + k * span,
                         len(slot.prompt) + self.max_new_tokens - 1,
                         self.capacity)
            if target > L:
                self._cow_write_range(i, slot, L, target - L)
                self._extend_blocks(i, slot, target)
            any_active = True
        if not any_active:
            return
        st = self._dev.device(self._paged_state)
        self._slabs_ahead = True
        if self._spec:
            (self._paged_cache, self._draft_cache, st, tok_buf, val_buf,
             n_reads, logit_buf) = self._burst_fn(
                self.params, self.draft_params, self._paged_cache,
                self._draft_cache, st, k)
            self._dev.adopt(st)
            self.n_flag_reads += n_reads
            self._drain_spec_burst(tok_buf, val_buf, logit_buf, k=k)
        else:
            self._paged_cache, st, tok_buf, val_buf, n_reads, logit_buf = \
                self._burst_fn(self.params, self._paged_cache, st, k)
            self._dev.adopt(st)
            self.n_flag_reads += n_reads
            self._drain_burst(tok_buf, val_buf, logit_buf, k=k)
        self._slabs_ahead = False

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

    def _expire_queued(self) -> None:
        """Fail queued requests whose TTFT deadline has passed."""
        now = time.monotonic()
        with self._lock:
            dead = self.scheduler.expire(now)
        for req in dead:
            self.n_expired += 1
            self._finish(GenerationResult(
                request_id=req.rid, prompt=req.prompt,
                tokens=np.asarray(req.tokens, np.int32),
                latency_s=now - req.t_submit, status="expired"))

    def _admit_paged(self) -> None:
        """Admit queued requests into free slots, in lane-priority order
        (interactive first, FIFO within a lane).

        A request needs a slot plus a worst-case *private*-block
        reservation: the pages its matched prefix shares forever are
        discounted, everything else (fresh prompt pages, decode
        extensions, possible COW forks in the write range) is budgeted
        up front, so mid-decode allocation never fails.  Recurrent
        families also need a free state slab.  The scan is *size-aware*:
        a candidate that does not fit stays queued and the scan moves
        on, so a too-large request can never head-of-line-block a
        smaller one behind it.  If an interactive candidate is blocked
        on resources while batch-lane slots are running, the youngest
        batch slot is preempted and the scan retries."""
        self._expire_queued()
        while True:
            blocked_interactive = self._admit_paged_scan()
            if blocked_interactive and self._preempt_for_interactive():
                continue
            return

    def _admit_paged_scan(self) -> bool:
        """One admission pass; returns True if an interactive candidate
        was left queued for lack of resources."""
        free = [i for i, s in enumerate(self._slots) if s is None]
        mid_decode = self.n_active > 0
        joins = []
        blocked_interactive = False
        with self._lock:
            for req in self.scheduler.candidates():
                if blocked_interactive and req.lane == "batch":
                    # strict priority: batch work must not slip past a
                    # resource-blocked interactive candidate (it would
                    # be preempted right back — livelock)
                    continue
                if not free:
                    if req.lane == "interactive":
                        blocked_interactive = True
                    break
                try:
                    fit = self._restore_fit(req, free) if req.preempted \
                        else self._fresh_fit(req, free)
                except CacheFullError:
                    # transient allocator storm (real or injected): the
                    # candidate stays queued, never oom-failed
                    continue
                except Exception as exc:
                    # attributable to this candidate alone: fail it and
                    # keep scanning — one bad request must not block the
                    # queue or fail the engine
                    self.scheduler.remove(req)
                    self._finish(GenerationResult(
                        request_id=req.rid, prompt=req.prompt,
                        tokens=np.asarray(req.tokens, np.int32),
                        latency_s=time.monotonic() - req.t_submit,
                        status="error", error=f"admission failed: {exc}"))
                    continue
                if fit is None:
                    if self.allocator.n_live == 0 and self._reserved == 0 \
                            and (self.state_store is None
                                 or self.state_store.n_live == 0):
                        # does not fit an *empty* pool: it never will —
                        # fail it instead of wedging the queue forever
                        self.scheduler.remove(req)
                        self._finish(GenerationResult(
                            request_id=req.rid, prompt=req.prompt,
                            tokens=np.asarray(req.tokens, np.int32),
                            latency_s=time.monotonic() - req.t_submit,
                            status="oom"))
                        continue
                    if req.lane == "interactive":
                        blocked_interactive = True
                    continue           # size-aware: scan past this one
                self.scheduler.remove(req)
                joins.append(fit)
        for join in joins:
            slot_i = join[1]
            slot = self._build_restore_slot(join) if join[0] == "restore" \
                else self._build_fresh_slot(join, mid_decode)
            slot.adm_seq = self._adm_seq
            self._adm_seq += 1
            self._slots[slot_i] = slot
        if joins:
            self._dev.mark_dirty()
        return blocked_interactive

    def _fresh_fit(self, req: SchedRequest, free: List[int]):
        """Try to take resources for a fresh admission (all-or-nothing);
        None if the request does not fit right now."""
        f = self.fault_plan.fire("admit") if self.fault_plan else None
        if f is not None and f.action == "raise":
            raise f.make_exc()         # before anything is taken
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
        if self.state_store is not None and self.state_store.n_free == 0:
            return None                # state slabs exhausted: stay queued
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
        slab = 0
        if self.state_store is not None:
            slab = self.state_store.admit(req.rid)
            # the slab's previous state is zeroed by the model's first
            # step for this slot (lengths == 0 blanking)
            self.state_store.mark_reset(slab)
        return ("fresh", free.pop(0), req, mapped + fresh, needed - n_fresh,
                matched, digests, slab)

    def _build_fresh_slot(self, join, mid_decode: bool) -> _PagedSlot:
        _, slot_i, req, blocks, reserve, matched, digests, slab = join
        if mid_decode:
            self.n_joins += 1
        if matched:
            self.n_prefix_hits += 1
            self.n_shared_tokens += matched
        slot = _PagedSlot(req, blocks, reserve, prefill_off=matched,
                          digests=list(digests))
        self._page_table[slot_i, :] = 0
        self._page_table[slot_i, :len(blocks)] = blocks
        self._lengths[slot_i] = matched
        self._state_slots[slot_i] = slab
        return slot

    def _restore_fit(self, req: SchedRequest, free: List[int]):
        """Try to take resources to re-admit a preempted request.  No
        prefix-share discount: every page is acquired private and the
        spilled pages and slab are scattered back, so the restored slot
        decodes as if it had never been preempted."""
        plen = req.prompt.shape[0]
        total = self.allocator.blocks_for(
            min(plen + self.max_new_tokens, self.capacity))
        if total > self.allocator.n_free - self._reserved:
            return None
        if self.state_store is not None and self.state_store.n_free == 0:
            return None
        n_now = self.allocator.blocks_for(max(req.length, 1))
        blocks = self.allocator.acquire(n_now)
        self._reserved += total - n_now
        slab = 0
        if self.state_store is not None:
            slab = self.state_store.admit(req.rid)
            self.state_store.mark_reset(slab)   # the scatter overwrites it
        return ("restore", free.pop(0), req, blocks, total - n_now, slab)

    def _build_restore_slot(self, join) -> _PagedSlot:
        """Scatter a preempted request's spilled pages and slab into their
        new physical homes and rebuild the slot mid-sequence.  Attention
        reads go through the page table and the slab through the slot's
        state slot, so decode resumes where it stopped."""
        _, slot_i, req, blocks, reserve, slab = join
        self._ensure_paged_cache()
        if req.spill is not None:
            spill = req.spill["target"] if self._spec else req.spill
            ids = self._block_ids(blocks)
            self._paged_cache = self.model.scatter_paged_pages(
                self._paged_cache, spill, ids, slab)
            if self._spec:
                self._draft_cache = self.draft_model.scatter_paged_pages(
                    self._draft_cache, req.spill["draft"], ids, 0)
        slot = _PagedSlot(req, blocks, reserve,
                          prefill_off=len(req.prompt),
                          digests=list(req.digests))
        slot.tokens = list(req.tokens)
        if self._spec and req.spec is not None:
            slot.spec_rounds = int(req.spec["rounds"])
            slot.spec_deficit = int(req.spec["deficit"])
            slot.spec_prev = int(req.spec["prev"])
        self._page_table[slot_i, :] = 0
        self._page_table[slot_i, :len(blocks)] = blocks
        self._lengths[slot_i] = req.length
        self._state_slots[slot_i] = slab
        self.n_restores += 1
        if self.n_active > 0:
            self.n_joins += 1
        return slot

    def _block_ids(self, blocks: List[int]) -> torch.Tensor:
        return torch.as_tensor(blocks, dtype=torch.long, device=self.device)

    def _paged_cache_kwargs(self) -> Dict[str, Any]:
        """Keyword args for ``model.init_paged_cache`` beyond the block
        geometry: state-slab provisioning, and the int8 switch."""
        kw: Dict[str, Any] = {"num_state_slots": self.num_state_slots}
        if self.kv_dtype == "int8":
            kw["kv_dtype"] = "int8"
        return kw

    def _ensure_paged_cache(self) -> None:
        if self._paged_cache is None:
            self._paged_cache = self.model.init_paged_cache(
                self.allocator.num_blocks, self.block_size,
                dtype=self.cache_dtype, **self._paged_cache_kwargs())
        if self._spec and self._draft_cache is None:
            # the draft pool shadows the target pool one to one: the same
            # block count, block size and page tables, draft-model dims
            self._draft_cache = self.draft_model.init_paged_cache(
                self.allocator.num_blocks, self.block_size,
                dtype=self.cache_dtype)

    # -- preemption ---------------------------------------------------------
    def preempt(self, rid: int) -> bool:
        """Spill the slot serving ``rid`` to host memory and re-queue it
        at the front of its lane (an operator and test hook; admission
        calls the same path for blocked interactive work).  Returns
        False if ``rid`` is not in a slot."""
        if not self.paged:
            raise ValueError("preemption requires paged mode")
        for i, slot in enumerate(self._slots):
            if slot is not None and slot.rid == rid and not slot.done:
                with torch.inference_mode():
                    self._preempt_slot(i)
                return True
        return False

    def _preempt_for_interactive(self) -> bool:
        """Spill the youngest running batch-lane slot (least cached work
        lost) to make room for a blocked interactive candidate."""
        victims = [(slot.adm_seq, i) for i, slot in enumerate(self._slots)
                   if slot is not None and slot.lane == "batch"
                   and not slot.done]
        if not victims:
            return False
        self._preempt_slot(max(victims)[1])
        return True

    def _preempt_slot(self, slot_i: int) -> None:
        """Evict slot ``slot_i`` mid-flight, keeping its work: a decoding
        slot's used pages (and mamba state slab) are gathered to host
        memory for the restore; a slot still mid-prefill (no token
        emitted yet) is simply restarted — re-prefilling is
        deterministic, so nothing observable is lost.  The request
        re-enters the *front* of its lane."""
        slot = self._slots[slot_i]
        req = SchedRequest(rid=slot.rid, prompt=slot.prompt, lane=slot.lane,
                           deadline=slot.deadline, tag=slot.tag,
                           t_submit=slot.t_submit)
        if slot.tokens and slot.prefill_off >= len(slot.prompt):
            if self._slabs_ahead and self.state_store is not None:
                raise RuntimeError(
                    f"request {slot.rid}: a failed step may have advanced "
                    "its state slab past the host mirror in place; its "
                    "spill would not restore it")
            L = int(self._lengths[slot_i])
            n_pages = self.allocator.blocks_for(L)
            ids = self._block_ids(slot.blocks[:n_pages])
            payload = self.model.gather_paged_pages(
                self._paged_cache, ids, int(self._state_slots[slot_i]))
            req.spill = bridge.to_torch(payload, "cpu")
            if self._spec:
                # spill the draft pool's view of the same pages and the
                # spec mirrors, so the restore resumes the same draft
                # state and PRNG stream
                dpayload = self.draft_model.gather_paged_pages(
                    self._draft_cache, ids, 0)
                req.spill = {"target": req.spill,
                             "draft": bridge.to_torch(dpayload, "cpu")}
                req.spec = {"rounds": slot.spec_rounds,
                            "deficit": slot.spec_deficit,
                            "prev": slot.spec_prev}
            req.length = L
            req.tokens = list(slot.tokens)
            req.digests = list(slot.digests)
        self.allocator.release(slot.blocks)
        if self.state_store is not None:
            self.state_store.evict(slot.rid)
        self._reserved -= slot.reserve_left
        self._page_table[slot_i, :] = 0
        self._lengths[slot_i] = 0
        self._slots[slot_i] = None
        self._dev.mark_dirty()
        self.n_preemptions += 1
        with self._lock:
            self.scheduler.push(req, front=True)

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
        the coming ``paged_write`` will touch, so the write can never
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
            if self.state_store is not None:
                self.state_store.evict(slot.rid)
            self._reserved -= slot.reserve_left
            self._page_table[i, :] = 0
            self._lengths[i] = 0
            self._slots[i] = None
            self._dev.mark_dirty()
            self.n_evictions += 1
        return out
