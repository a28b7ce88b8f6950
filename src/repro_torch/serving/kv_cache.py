"""Block-paged KV cache: host-side bookkeeping (port of the host classes
of ``repro/serving/kv_cache.py``).

The serving engine carves one shared pool of ``num_blocks`` fixed-size
blocks (cf. vLLM):

  * ``BlockAllocator`` — host-side free list with **per-block
    refcounts** and a **content-hash table** over full blocks.  Slots
    ``acquire`` private blocks, ``share`` already-resident ones
    (refcount + 1), and ``release`` everything on eviction; a block
    returns to the free list only when its refcount reaches zero.  The
    content table maps ``(parent chain digest, block tokens)`` to the
    physical block holding that prefix's KV, which is what lets
    ``ServeEngine`` map a joiner's common prompt prefix straight into
    its page table instead of re-prefilling it.  A *registered* block
    whose refcount drops to zero is **retained**: it stays in the
    content table on an LRU free list (its KV is still resident and
    valid — nothing has written over it), so an identical prompt
    arriving right after its twin finished maps the whole prefix
    instead of re-prefilling from scratch.  ``share`` resurrects such a
    block off the free list; ``acquire`` recycles retained blocks
    (oldest first, unregistering at that moment) only after the plain
    free list is exhausted — a table hit therefore always points at
    valid KV.
  * ``DeviceSlotState`` — the device-resident copy of the engine's
    per-slot arrays and its coherence protocol with the host mirror.
  * ``StateStore`` — the recurrent families' per-request state slabs
    (mamba conv/ssm state): exclusive ownership, no sharing.

The page primitives (``paged_write_index``/``paged_write``,
``paged_gather``) live with the attention math in
``models/attention.py``.

Layout convention: storage is ``(num_blocks, block_size, ...)``; a page
table row ``page_table[b]`` lists the physical block of each logical
page of slot ``b`` (unused entries may hold any valid block id — reads
beyond a slot's true length are masked by the attention kernels, so
stale pointers are harmless).  Logical position ``l`` of slot ``b``
lives at flat row ``page_table[b, l // block_size] * block_size +
l % block_size``.

Content addressing uses *chain digests*: the key of block ``p`` in a
sequence is ``sha256(digest(p-1) || tokens of page p)`` with a fixed
root digest, so a match on page ``p`` certifies the entire token prefix
``0 .. (p+1)*block_size`` — not just the page's own tokens.  Sharing a
matched chain is therefore exact, never probabilistic-by-suffix.  The
root digest is the reference's, so both packages address blocks alike.
"""
from __future__ import annotations

import collections
import hashlib
import time
from typing import (Callable, Dict, Iterable, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np
import torch

__all__ = ["BlockAllocator", "CacheFullError", "DeviceSlotState",
           "ROOT_DIGEST", "SPEC_STATE_KEYS", "StateStore", "chain_digest"]

# Chain root: the digest "before" a sequence's first page.
ROOT_DIGEST = hashlib.sha256(b"repro.kv_cache.root").digest()


def chain_digest(parent: bytes, tokens: Sequence[int]) -> bytes:
    """Digest of a token chain extended by one full page of tokens."""
    h = hashlib.sha256(parent)
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.digest()


class CacheFullError(RuntimeError):
    """Raised by ``BlockAllocator.acquire`` when the pool cannot satisfy
    the request.  The allocator state is unchanged (all-or-nothing)."""


# Slot-state keys that exist only when speculative decoding is enabled
# (see ``steps.make_paged_spec_burst``).  They ride the same
# ``DeviceSlotState`` protocol as the core keys: rebuilt from the host
# mirror on structural events, updated on the device otherwise.  The
# draft model's KV pool needs no bookkeeping here: it is indexed by the
# same page tables, lengths and block allocator as the target pool (one
# logical position maps to one physical block id in both), so
# reservation, extension and eviction apply to the pair at once.
SPEC_STATE_KEYS = ("spec_rounds", "spec_deficit", "spec_prev")


class DeviceSlotState:
    """Device-resident mirror of the engine's per-slot decode state.

    The serving engine keeps two views of its slot arrays (page tables,
    lengths, last tokens, sampling counters, done flags):

      * **host mirror** — numpy arrays plus slot bookkeeping, mutated at
        *structural* events only (admission, eviction, block extension,
        COW fork);
      * **device view** — a dict of tensors replaced by the megastep and
        burst functions after every call.

    Speculative serving adds the ``SPEC_STATE_KEYS`` entries to the same
    dict, under the same protocol.

    ``mark_dirty`` records a structural host mutation; the next
    ``device(build)`` rebuilds the view from the host (one upload) and
    clears the flag.  While clean, ``device`` returns the tensors adopted
    from the last device-side update (``adopt``) — no uploads on the
    steady decode path.  ``n_uploads`` counts rebuilds.
    """

    def __init__(self, put: Callable[[np.ndarray], torch.Tensor]):
        self._dev: Optional[Dict[str, torch.Tensor]] = None
        self._dirty = True
        self.n_uploads = 0
        # host array -> device tensor; must copy (the host mirror keeps
        # changing while the device view advances on its own)
        self.put = put

    def mark_dirty(self) -> None:
        """Host mirror changed structurally: the device view is stale."""
        self._dirty = True

    def adopt(self, dev: Dict[str, torch.Tensor]) -> None:
        """Adopt the state dict returned by a device-side update as the
        current device view."""
        self._dev = dev

    def device(self, build: Callable[[], Dict[str, np.ndarray]]):
        """Current device view; rebuilds from ``build()`` iff dirty."""
        if self._dirty or self._dev is None:
            self._dev = {k: self.put(v) for k, v in build().items()}
            self._dirty = False
            self.n_uploads += 1
        return self._dev


class StateStore:
    """Fixed-capacity pool of recurrent-state slabs, keyed by request.

    Recurrent layers (mamba conv/ssm, xLSTM matrix/scalar memory) carry
    constant-size per-sequence state that page tables cannot address: a
    slab is a running summary of the *entire* prefix, so — unlike KV
    pages — it can never be shared between slots or grown lazily.  The
    store therefore mirrors only ``BlockAllocator``'s *lifecycle*
    semantics, not its refcounting: ``admit`` hands a request exclusive
    ownership of one slab (all-or-nothing — a full store raises
    ``CacheFullError`` with the store unchanged, so the engine keeps the
    request queued), ``evict`` frees the slab on eos.

    The device arrays live in the model's paged cache (leading
    ``num_slots`` axis per recurrent layer leaf); this class is the
    host-side source of truth for who owns which slab and which slabs
    still hold a *previous* occupant's state.  A recycled slab is
    ``stale`` until its new owner's first step zeroes it (the model's
    paged step blanks rows whose ``lengths == 0``); the engine marks
    that handoff via ``mark_reset`` at admission.  The property suite
    checks exactly these invariants: no slab is ever owned twice, no
    slab leaks, and stale state is never handed to a new owner
    unreset.
    """

    def __init__(self, num_slots: int):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = int(num_slots)
        # FIFO reuse keeps slab placement deterministic for tests
        self._free: collections.deque = collections.deque(range(num_slots))
        self._slab_of: Dict[int, int] = {}       # request id -> slab
        self._owner: Dict[int, int] = {}         # slab -> request id
        self._stale: Set[int] = set()            # freed slabs, state resident

    # -- occupancy ----------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return len(self._owner)

    def slab_of(self, rid: int) -> Optional[int]:
        """Slab owned by request ``rid`` (None if not admitted)."""
        return self._slab_of.get(rid)

    def owner_of(self, slab: int) -> Optional[int]:
        """Request owning ``slab`` (None if free)."""
        return self._owner.get(slab)

    def is_stale(self, slab: int) -> bool:
        """True while a previous occupant's state is still resident."""
        return slab in self._stale

    def stats(self) -> Dict[str, int]:
        return {"num_slots": self.num_slots, "n_free": self.n_free,
                "n_live": self.n_live}

    # -- lifecycle ----------------------------------------------------------
    def admit(self, rid: int) -> int:
        """Give request ``rid`` exclusive ownership of one slab,
        all-or-nothing."""
        if rid in self._slab_of:
            raise ValueError(f"request {rid} already holds slab "
                             f"{self._slab_of[rid]}")
        if not self._free:
            raise CacheFullError(
                f"no state slab free (0/{self.num_slots}) for request {rid}")
        slab = self._free.popleft()
        self._slab_of[rid] = slab
        self._owner[slab] = rid
        return slab

    def mark_reset(self, slab: int) -> None:
        """Record that ``slab``'s resident state has been (or is about
        to be, on the owner's first step) zeroed for its new owner."""
        if slab not in self._owner:
            raise ValueError(f"cannot reset free slab {slab}")
        self._stale.discard(slab)

    def evict(self, rid: int) -> int:
        """Free request ``rid``'s slab (eos / truncation).  The slab
        returns to the pool but keeps the evictee's state until the next
        owner resets it — hence it becomes ``stale``."""
        slab = self._slab_of.pop(rid, None)
        if slab is None:
            raise ValueError(
                f"request {rid} holds no state slab (double evict?)")
        del self._owner[slab]
        self._stale.add(slab)
        self._free.append(slab)
        return slab



class BlockAllocator:
    """Refcounted free-list allocator with a full-block content table.

    ``retain_cap`` bounds how many refcount-0 registered blocks stay
    parked on the retained (prefix-reuse) list; beyond it the oldest are
    retired to the plain free list and unregistered, so retention can
    never crowd the content table with stale chains under churn.
    ``retain_ttl_s`` optionally expires retained blocks by age (time
    since their last reference dropped), swept at every allocator
    mutation.  Neither affects ``n_free``: retained blocks were already
    reusable — the cap/TTL only bound how long their *content* stays
    addressable.
    """

    def __init__(self, num_blocks: int, block_size: int, *,
                 retain_cap: Optional[int] = None,
                 retain_ttl_s: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if retain_cap is not None and retain_cap < 0:
            raise ValueError(f"retain_cap must be >= 0, got {retain_cap}")
        if retain_ttl_s is not None and retain_ttl_s <= 0:
            raise ValueError(f"retain_ttl_s must be > 0, got {retain_ttl_s}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.retain_cap = None if retain_cap is None else int(retain_cap)
        self.retain_ttl_s = retain_ttl_s
        self._clock = clock if clock is not None else time.monotonic
        self.n_retain_evictions = 0
        # FIFO reuse keeps physical placement deterministic for tests
        self._free: collections.deque = collections.deque(range(num_blocks))
        # retained: registered blocks at refcount 0, LRU order (dicts
        # preserve insertion order; oldest entry is recycled first),
        # valued by the time their last reference dropped (TTL sweeps)
        self._retained: Dict[int, float] = {}
        self._ref: Dict[int, int] = {}
        # content table: parent digest -> {page tokens -> block id}, plus
        # the reverse index used to unregister a block when it is recycled
        self._table: Dict[bytes, Dict[Tuple[int, ...], int]] = {}
        self._key_of: Dict[int, Tuple[bytes, Tuple[int, ...]]] = {}
        # bumped whenever the content table changes (register/unregister):
        # prefix matches memoized against an unchanged epoch stay valid
        self.epoch = 0

    # -- occupancy ----------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free) + len(self._retained)

    @property
    def n_retained(self) -> int:
        """Free blocks still addressable through the content table."""
        return len(self._retained)

    @property
    def n_live(self) -> int:
        return len(self._ref)

    @property
    def n_shared(self) -> int:
        """Live blocks referenced by more than one slot."""
        return sum(1 for r in self._ref.values() if r > 1)

    @property
    def n_table(self) -> int:
        """Content-table entries (always <= n_live)."""
        return len(self._key_of)

    def ref(self, block: int) -> int:
        """Current refcount of ``block`` (0 if free)."""
        return self._ref.get(block, 0)

    def is_registered(self, block: int) -> bool:
        """True while ``block`` is addressable through the content
        table.  A writer must COW-fork such a block even at refcount 1
        (post-resurrection): overwriting it would silently corrupt the
        KV the table still advertises."""
        return block in self._key_of

    def registered_blocks(self) -> Set[int]:
        """Blocks currently addressable through the content table."""
        return set(self._key_of)

    def retained_blocks(self) -> Set[int]:
        """Registered blocks at refcount 0 (on the LRU retained list)."""
        return set(self._retained)

    def stats(self) -> Dict[str, int]:
        shared = self.n_shared
        return {"num_blocks": self.num_blocks, "n_free": self.n_free,
                "n_live": self.n_live, "n_shared": shared,
                "n_private": self.n_live - shared, "n_table": self.n_table,
                "n_retained": self.n_retained}

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` (at least one)."""
        return max(1, -(-int(n_tokens) // self.block_size))

    # -- lifecycle ----------------------------------------------------------
    def acquire(self, n: int = 1) -> List[int]:
        """Take ``n`` private blocks (refcount 1) off the free list,
        all-or-nothing.  Plain (unregistered) free blocks are handed out
        first; retained blocks are recycled oldest-first and leave the
        content table only at that moment."""
        if n < 0:
            raise ValueError(f"cannot acquire {n} blocks")
        self._sweep_ttl()
        if n > self.n_free:
            raise CacheFullError(
                f"need {n} blocks, only {self.n_free}/{self.num_blocks} free")
        out: List[int] = []
        while len(out) < n and self._free:
            out.append(self._free.popleft())
        while len(out) < n:
            b = next(iter(self._retained))     # LRU: oldest insertion
            del self._retained[b]
            self._unregister(b)
            out.append(b)
        for b in out:
            self._ref[b] = 1
        return out

    def share(self, blocks: Iterable[int]) -> None:
        """Add a reference to already-live blocks (prefix sharing).  A
        *retained* block (registered, refcount 0) is resurrected off the
        free list with refcount 1 — this is the post-eviction prefix-hit
        path.  Sharing an unregistered free block raises."""
        blocks = list(blocks)
        for b in blocks:
            if b not in self._ref and b not in self._retained:
                raise ValueError(f"cannot share free block {b}")
        for b in blocks:
            if b in self._ref:
                self._ref[b] += 1
            else:
                del self._retained[b]
                self._ref[b] = 1

    def release(self, blocks: Iterable[int]) -> None:
        """Drop one reference per block; a block returns to a free list
        only at refcount zero — the LRU retained list if it is in the
        content table (its KV stays addressable for future prefix hits),
        the plain free list otherwise.  Releasing a free/foreign block
        raises."""
        for b in blocks:
            r = self._ref.get(b, 0)
            if r <= 0:
                raise ValueError(f"block {b} is not allocated (double free?)")
            if r == 1:
                del self._ref[b]
                if b in self._key_of:
                    self._retained[b] = self._clock()
                    self._trim_retained()
                else:
                    self._free.append(b)
            else:
                self._ref[b] = r - 1
        self._sweep_ttl()

    def sweep(self) -> int:
        """Expire retained blocks whose TTL has lapsed, *now* (an idle
        server has no allocation traffic to trigger the sweep).  Returns
        the number of blocks retired by this call."""
        before = self.n_retain_evictions
        self._sweep_ttl()
        return self.n_retain_evictions - before

    def retire(self, block: int) -> bool:
        """Retire one *specific* retained block: drop its content-table
        entry and move it to the plain free list (its resident KV is
        known to be garbage).  Returns True if the block was retained."""
        if block not in self._retained:
            return False
        del self._retained[block]
        self._unregister(block)
        self._free.append(block)
        self.n_retain_evictions += 1
        return True

    def clear_registry(self) -> None:
        """Forget every content-table entry and retire all retained
        blocks to the plain free list (the device pool was rebuilt, so
        every registered block advertises KV that no longer exists)."""
        while self._retained:
            self._retire_oldest_retained()
        for b in list(self._key_of):
            self._unregister(b)

    def _retire_oldest_retained(self) -> None:
        b = next(iter(self._retained))
        del self._retained[b]
        self._unregister(b)
        self._free.append(b)
        self.n_retain_evictions += 1

    def _trim_retained(self) -> None:
        if self.retain_cap is None:
            return
        while len(self._retained) > self.retain_cap:
            self._retire_oldest_retained()

    def _sweep_ttl(self) -> None:
        if self.retain_ttl_s is None or not self._retained:
            return
        now = self._clock()
        while self._retained:
            b = next(iter(self._retained))     # oldest retire time first
            if now - self._retained[b] < self.retain_ttl_s:
                break
            self._retire_oldest_retained()

    # -- content addressing -------------------------------------------------
    def register(self, block: int, parent: bytes,
                 tokens: Sequence[int]) -> None:
        """Publish a *full* block as the KV of chain ``parent`` extended
        by ``tokens``.  First writer wins: re-registering the same chain
        (e.g. a COW fork re-completing a page) is a no-op, so a table
        entry always points at the block that originally computed it."""
        if block not in self._ref:
            raise ValueError(f"cannot register free block {block}")
        if len(tokens) != self.block_size:
            raise ValueError(
                f"only full blocks are addressable: got {len(tokens)} tokens, "
                f"block_size={self.block_size}")
        if block in self._key_of:
            return
        kids = self._table.setdefault(parent, {})
        key = tuple(int(t) for t in tokens)
        if key in kids:
            return                      # identical content already resident
        kids[key] = block
        self._key_of[block] = (parent, key)
        self.epoch += 1

    def lookup(self, parent: bytes,
               tokens: Sequence[int]) -> Optional[int]:
        """Block holding exactly chain ``parent`` + full page ``tokens``."""
        return self._table.get(parent, {}).get(tuple(int(t) for t in tokens))

    def lookup_tail(self, parent: bytes,
                    prefix: Sequence[int]) -> Optional[int]:
        """A resident full block whose page *starts with* ``prefix``
        under chain ``parent`` — lets a joiner map its final partial
        page onto another sequence's completed block (rows past the
        joiner's length are masked by attention, so the stranger's
        suffix in the same block is never read)."""
        prefix = tuple(int(t) for t in prefix)
        if not prefix or len(prefix) >= self.block_size:
            return None
        for key, block in self._table.get(parent, {}).items():
            if key[:len(prefix)] == prefix:
                return block
        return None

    def _unregister(self, block: int) -> None:
        key = self._key_of.pop(block, None)
        if key is None:
            return
        parent, tokens = key
        kids = self._table.get(parent)
        if kids is not None and kids.get(tokens) == block:
            del kids[tokens]
            if not kids:
                del self._table[parent]
        self.epoch += 1
