r"""Tensor parallelism: the sharding plan, the collectives and the
sharded model (port of ``repro/models/sharding.py`` and of what the
reference's ``with mesh:`` does to a model).

**Single controller.**  As under JAX, one process drives every rank: a
``ServingMesh`` is an ordered list of N torch devices (a device may
repeat: ``["cpu", "cpu"]`` simulates two ranks on one host, as XLA's
``--xla_force_host_platform_device_count`` does).  ``ShardedModel``
runs one rank model per device, each on its own thread
(``run_ranks``), and the model code is written once, for one rank: it
calls ``all_reduce(x)`` and ``all_gather(x, dim)``, which go to the
calling thread's ``Group`` — the identity outside ``run_ranks``, so the
single-device model pays nothing.  The ranks of the in-process group
take turns, one running at a time from one collective to the next (they
would otherwise trade the GIL at every torch op), and every rank sums
(or concatenates) the parts itself **in rank order** on its own device:
the replicated activations stay bit for bit the same on every rank, and
a run is deterministic.  A rank that raises breaks the group, so every
rank and the caller raise instead of waiting.  A later
multi-process group (NCCL) can stand behind the same two calls.

**The plan** (``param_plan``) is the port's copy of the reference's
``_rules``, keyed on the same parameter paths with the sub-layer's
block kind in front (``"attn:blocks/s0/attn/wq"``).  A leaf is either
replicated (None) or a ``Split``: the indices each rank takes along one
axis.  ``shard_params`` applies a plan and ``unshard_params`` inverts
it bit for bit.  Megatron's placement: column-parallel into a block
(q/k/v heads, the FFN and mamba's ``d_inner`` inputs), row-parallel out
of it (``wo``, ``w_down``, ``x_proj``, ``out_proj``), whose partial sum
is all-reduced; experts over ranks; embedding and head over the vocab.

Where the port differs from the reference's specs:

- Attention splits by **KV head** (q heads go with their KV group), not
  by head_dim: K1 and K2 take a whole head's softmax.  The split is
  uneven where heads do not divide: smollm-360m's 15/5 heads at N = 2
  give ranks of 9/3 and 6/2, each keeping G = 3.
- Experts split over ranks unevenly where their count does not divide
  (the reference replicates them then).
- Leaves the plan keeps whole on every rank that the reference's specs
  put on "model" (``DIFFERENCES``: the ``"block:path"`` pattern, then
  the reason):

  - ``^attn:.*attn/[wb][kv]$``: fewer KV heads than ranks: each rank
    keeps whole copies of the KV heads its q heads read (the pool too;
    a rank with no q head keeps none, skips attention and adds a zero
    partial).
  - ``^mla:.*attn/``: MLA serves on the dense engine only, which takes
    no mesh.
  - ``^(mlstm|slstm):``: the xLSTM blocks run whole on every rank (the
    reference replicates mLSTM's C/n/m and sLSTM's 4 heads too).
  - ``^\w*:mtp/``: the multi-token head trains only; no sharded path
    runs it.
  - ``^encdec:``: the encoder-decoder is served dense only.
  - ``^:(embed|lm_head)$``: the vocab does not divide the ranks (the
    reference's ``_filter_divisible``, as whisper's 51865).

The paged pool (``paged_cache_plan``): K/V pools split by KV head
(replicated KV heads as above), mamba's conv and SSM slabs by
``d_inner``, xLSTM slabs replicated; the block and slot axes stay whole
on every rank, so page tables and slab ids mean the same everywhere.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..kernels import build as kernel_build
from .config import ModelConfig

AXIS_NAMES = ("data", "model")

# (regex on "block:path", reason): where the plan leaves a leaf whole
# that the reference's specs put on "model" (the docstring's table)
DIFFERENCES = (
    (r"^attn:.*attn/[wb][kv]$", "fewer KV heads than ranks"),
    (r"^mla:.*attn/", "MLA serves on the dense engine only"),
    (r"^(mlstm|slstm):", "the xLSTM blocks run whole on every rank"),
    (r"^\w*:mtp/", "the multi-token head trains only"),
    (r"^encdec:", "the encoder-decoder is served dense only"),
    (r"^:(embed|lm_head)$", "the vocab does not divide the ranks"),
)

# sub-layer blocks whose output is whole on every rank (no all-reduce)
REPLICATED_BLOCKS = ("mla", "mlstm", "slstm")


# -- the mesh ------------------------------------------------------------------

def normalize_device(device) -> torch.device:
    """``device`` as a torch.device with a CUDA index (``"cuda"`` is the
    current CUDA device), so two names of one device compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """A ``(1, N)`` data x model mesh: ``devices[r]`` runs rank ``r``."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = AXIS_NAMES

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": 1, "model": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


# -- collectives ----------------------------------------------------------------

class Group:
    """The collectives a rank's model code calls.  This one is the
    identity: one rank, whose parts are the whole."""
    rank = 0
    size = 1

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x


IDENTITY = Group()
_TLS = threading.local()


def current() -> Group:
    """The calling thread's group (the identity outside ``run_ranks``)."""
    return getattr(_TLS, "group", IDENTITY)


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on every rank."""
    return current().all_reduce(x)


def all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    return current().all_gather(x, dim)


class _Turns:
    """Whose turn it is among ``n`` rank threads.  One rank runs at a
    time, from one collective to the next: torch releases the GIL in
    every op, and two runnable ranks would hand it back and forth at
    each one."""

    def __init__(self, n: int, timeout_s: float):
        self.n, self.timeout_s = n, timeout_s
        self.turn, self.broken = 0, False
        self.cv = threading.Condition()
        self.slots = ([None] * n, [None] * n)

    def wait(self, rank: int) -> None:
        with self.cv:
            if not self.cv.wait_for(lambda: self.turn == rank or self.broken,
                                    timeout=self.timeout_s):
                self.broken = True
                self.cv.notify_all()
            if self.broken:
                raise threading.BrokenBarrierError

    def hand_on(self, rank: int) -> None:
        with self.cv:
            self.turn = (rank + 1) % self.n
            self.cv.notify_all()

    def abort(self) -> None:
        with self.cv:
            self.broken = True
            self.cv.notify_all()


class _RankGroup(Group):
    """Rank ``rank`` of an in-process group.  A collective posts the
    rank's part into one of two alternating slot lists and hands the
    turn on; when the turn comes back every rank has posted its part.
    The next collective uses the other list, so a rank that runs ahead
    never overwrites parts another rank has still to read."""

    def __init__(self, turns: _Turns, rank: int, device: torch.device):
        self.rank, self.size = rank, turns.n
        self._turns, self._device = turns, device
        self._n = 0

    def _exchange(self, x: torch.Tensor) -> List[torch.Tensor]:
        parts = self._turns.slots[self._n & 1]
        self._n += 1
        parts[self.rank] = x
        self._turns.hand_on(self.rank)
        self._turns.wait(self.rank)
        return [p.to(self._device) for p in parts]

    def all_reduce(self, x):
        parts = self._exchange(x)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def all_gather(self, x, dim):
        return torch.cat(self._exchange(x), dim=dim)


def run_ranks(fn: Callable[[int], Any], devices: Sequence[torch.device],
              timeout_s: float = 600.0) -> List[Any]:
    """``[fn(0), ..., fn(N-1)]``, rank ``r`` on its own thread with its
    ``Group``, its device current, the caller's CUDA stream on it, and the
    caller's grad and inference modes (both are thread-local in torch).
    The ranks take turns between collectives (``_Turns``).  Kernel
    launches count per rank (``CudaKernel.rank_launches``).  The first
    exception of any rank is raised here once every rank has stopped; a
    rank that waits ``timeout_s`` for its turn breaks the group."""
    n = len(devices)
    if n == 1:
        with kernel_build.launch_rank(0):
            return [fn(0)]
    turns = _Turns(n, timeout_s)
    results: List[Any] = [None] * n
    errors: List[Optional[BaseException]] = [None] * n
    grad, infer = torch.is_grad_enabled(), torch.is_inference_mode_enabled()
    streams = {d: torch.cuda.current_stream(d) for d in set(devices)
               if d.type == "cuda"}

    def body(r: int) -> None:
        dev = devices[r]
        _TLS.group = _RankGroup(turns, r, dev)
        try:
            with contextlib.ExitStack() as stack:
                if dev.type == "cuda":
                    stack.enter_context(torch.cuda.device(dev))
                    stack.enter_context(torch.cuda.stream(streams[dev]))
                stack.enter_context(torch.inference_mode(infer))
                stack.enter_context(torch.set_grad_enabled(grad))
                stack.enter_context(kernel_build.launch_rank(r))
                turns.wait(r)
                results[r] = fn(r)
                turns.hand_on(r)
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            errors[r] = exc
            turns.abort()
        finally:
            del _TLS.group

    threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                name=f"tp-rank-{r}") for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    raised = [e for e in errors if e is not None]
    if raised:
        # the rank's own error, not the broken group it left the others
        raise min(raised, key=lambda e: isinstance(
            e, threading.BrokenBarrierError))
    return results


# -- the plan ------------------------------------------------------------------

def ranges(n: int, parts: int) -> List[Tuple[int, int]]:
    """``n`` items cut into ``parts`` contiguous ranges, the first ``n %
    parts`` one longer."""
    base, extra = divmod(n, parts)
    out, start = [], 0
    for r in range(parts):
        stop = start + base + (r < extra)
        out.append((start, stop))
        start = stop
    return out


def head_split(n_heads: int, n_kv: int, parts: int
               ) -> List[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """(q heads, KV heads) of each rank.  Up to one rank per KV head the
    KV heads are cut into ranges and each rank takes its groups' q heads;
    with more ranks, ``parts`` must be a multiple of ``n_kv``: each KV
    head's group of q heads is cut over ``parts // n_kv`` ranks, which
    all keep that KV head (a rank left without q heads keeps none)."""
    G = n_heads // n_kv
    if parts <= n_kv:
        return [(tuple(range(a * G, b * G)), tuple(range(a, b)))
                for a, b in ranges(n_kv, parts)]
    if parts % n_kv:
        raise ValueError(
            f"tensor parallelism over {parts} ranks: {n_kv} KV heads "
            "neither reach nor divide the rank count")
    m = parts // n_kv
    out = []
    for r in range(parts):
        kv = r // m
        a, b = ranges(G, m)[r % m]
        q = tuple(range(kv * G + a, kv * G + b))
        out.append((q, (kv,) if q else ()))
    return out


def rank_config(cfg: ModelConfig, rank: int, parts: int,
                has_gqa: bool) -> ModelConfig:
    """The configuration rank ``rank`` of ``parts`` runs: its own GQA
    heads (``head_dim`` pinned, since ``d_model // n_heads`` no longer
    gives it) and its share of mamba's ``d_inner``.  Everything else —
    vocab, experts, widths — stays global: a rank reads its share of
    those off its weights and its group."""
    kw: Dict[str, Any] = {}
    if has_gqa:
        q, kv = head_split(cfg.n_heads, cfg.n_kv_heads, parts)[rank]
        kw.update(n_heads=len(q), n_kv_heads=len(kv),
                  head_dim=cfg.resolved_head_dim)
    if cfg.ssm is not None:
        a, b = ranges(cfg.d_inner, parts)[rank]
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_inner=b - a)
    return cfg.replace(**kw)


@dataclasses.dataclass(frozen=True)
class Split:
    """A leaf split along ``dim``: rank ``r`` holds
    ``leaf.index_select(dim, index[r])`` (indices may repeat across ranks:
    a replicated KV head)."""
    dim: int
    index: Tuple[torch.Tensor, ...]


def _idx(chunks) -> torch.Tensor:
    return torch.cat([torch.arange(a, b, dtype=torch.long)
                      for a, b in chunks] or
                     [torch.zeros((0,), dtype=torch.long)])


def _style_index(style: str, size: int, parts: int, cfg: ModelConfig,
                 heads) -> Optional[List[torch.Tensor]]:
    """Each rank's indices along the split axis of ``size``."""
    if style == "vocab" and size % parts:
        return None
    if style in ("range", "vocab"):
        return [_idx([ab]) for ab in ranges(size, parts)]
    if style == "halves":              # [x | z]: split each half alike
        half = size // 2
        return [_idx([(a, b), (half + a, half + b)])
                for a, b in ranges(half, parts)]
    hd = cfg.resolved_head_dim
    which = 0 if style == "q" else 1
    return [_idx([(h * hd, (h + 1) * hd) for h in hs[which]])
            for hs in heads]


# (regex on "block:path", style, axis of the unstacked leaf)
_RULES = (
    (r"^\w*:mtp/", None, 0),
    (r"^encdec:", None, 0),
    (r"^:embed$", "vocab", 0),
    (r"^:lm_head$", "vocab", 1),
    (r"^attn:.*attn/wq$", "q", 1),
    (r"^attn:.*attn/bq$", "q", 0),
    (r"^attn:.*attn/w[kv]$", "kv", 1),
    (r"^attn:.*attn/b[kv]$", "kv", 0),
    (r"^attn:.*attn/wo$", "q", 0),
    (r"mlp/w_(gate|up)$", "range", 1),
    (r"mlp/w_down$", "range", 0),
    (r"moe/w_(gate|up|down)$", "range", 0),          # experts
    (r"moe/shared/w_(gate|up)$", "range", 1),
    (r"moe/shared/w_down$", "range", 0),
    (r"mamba/in_proj$", "halves", 1),
    (r"mamba/(conv_w|dt_proj)$", "range", 1),
    (r"mamba/(conv_b|dt_bias|D|A_log|x_proj|out_proj)$", "range", 0),
)


def _walk(tree, path: str, fn):
    if isinstance(tree, dict):
        return {k: _walk(v, f"{path}/{k}" if path else k, fn)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, f"{path}/{i}" if path else str(i), fn)
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _block_of(model, path: str) -> str:
    """The block kind of the sub-layer a parameter path lies in ("" for
    the embedding, head and final norm; "encdec" in an encoder-decoder)."""
    if not hasattr(model, "period_descs"):
        return "encdec"
    m = re.match(r"blocks/s(\d+)/", path)
    if m:
        return model.period_descs[int(m.group(1))][0]
    m = re.match(r"prefix/(\d+)/", path)
    if m:
        return model.prefix_descs[int(m.group(1))][0]
    if path.startswith("mtp/"):
        return model.period_descs[0][0]
    return ""


def has_gqa(model) -> bool:
    return any(d[0] == "attn" for d in
               getattr(model, "prefix_descs", []) +
               getattr(model, "period_descs", []))


def param_plan(model, params, parts: int):
    """A tree of ``params``' structure: a ``Split`` or None per leaf."""
    cfg = model.cfg
    heads = (head_split(cfg.n_heads, cfg.n_kv_heads, parts)
             if has_gqa(model) else None)

    def leaf(path, a):
        key = f"{_block_of(model, path)}:{path}"
        for pat, style, axis in _RULES:
            if re.search(pat, key):
                if style is None or parts == 1:
                    return None
                dim = axis + (1 if path.startswith("blocks/") else 0)
                idx = _style_index(style, a.shape[dim], parts, cfg, heads)
                return None if idx is None else Split(dim, tuple(idx))
        return None
    return _walk(params, "", leaf)


def _leaves_with(plan, tree, fn):
    """``fn(split, leaf)`` over matching leaves of ``plan`` and ``tree``."""
    if isinstance(tree, dict):
        return {k: _leaves_with(plan[k], v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_leaves_with(p, v, fn) for p, v in zip(plan, tree))
    return fn(plan, tree)


def shard_params(params, plan, devices: Sequence[torch.device]):
    """One tree per rank: its slice of every split leaf, every replicated
    leaf whole, on ``devices[r]``."""
    def take(r):
        def one(split, a):
            if split is None:
                return a.to(devices[r])
            return a.index_select(split.dim,
                                  split.index[r].to(a.device)).to(devices[r])
        return _leaves_with(plan, params, one)
    return [take(r) for r in range(len(devices))]


def unshard_params(shards, plan, device="cpu"):
    """The inverse of ``shard_params``: the whole tree on ``device``
    (a replicated leaf from rank 0, a split leaf assembled from every
    rank's slice)."""
    def build(path_plan, *leaves):
        if path_plan is None:
            return leaves[0].to(device)
        shape = list(leaves[0].shape)
        shape[path_plan.dim] = int(max(int(i.max()) + 1 if i.numel() else 0
                                       for i in path_plan.index))
        out = torch.empty(shape, dtype=leaves[0].dtype, device=device)
        for idx, a in zip(path_plan.index, leaves):
            out.index_copy_(path_plan.dim, idx.to(device), a.to(device))
        return out

    def rec(p, trees):
        t0 = trees[0]
        if isinstance(t0, dict):
            return {k: rec(p[k], [t[k] for t in trees]) for k in t0}
        if isinstance(t0, (list, tuple)):
            return type(t0)(rec(p[i], [t[i] for t in trees])
                            for i in range(len(t0)))
        return build(p, *trees)
    return rec(plan, list(shards))


def paged_cache_plan(model, cache, parts: int):
    """A tree of the paged pool's structure: a ``Split`` or None per leaf.
    K/V pools (…, nb, bs, KV, hd) split by KV head, mamba's ``conv``
    (…, ns, dc-1, di) and ``ssm`` (…, ns, di, N) by ``d_inner``; the
    xLSTM slabs stay whole (replicated)."""
    cfg = model.cfg
    heads = (head_split(cfg.n_heads, cfg.n_kv_heads, parts)
             if has_gqa(model) and parts > 1 else None)

    def leaf(path, a):
        name = path.rsplit("/", 1)[-1]
        if parts == 1:
            return None
        if name in ("k", "v") and heads is not None:
            return Split(a.dim() - 2, tuple(_idx([(h, h + 1) for h in hs[1]])
                                            for hs in heads))
        if name in ("conv", "ssm"):
            dim = a.dim() - 1 if name == "conv" else a.dim() - 2
            return Split(dim, tuple(_idx([ab]) for ab in
                                    ranges(a.shape[dim], parts)))
        return None
    return _walk(cache, "", leaf)


# -- the sharded model ---------------------------------------------------------

class ShardedModel:
    """``model`` over a ``ServingMesh``: one rank model per device, each
    built from its ``rank_config``, its weights from ``shard``.  It has
    the model's serving interface — ``paged_step``, ``apply``, the paged
    pool's ``init``/``copy``/``gather``/``scatter`` — over lists with one
    entry per rank (parameters, pools, spill payloads), so the engine
    drives it as it drives one model.  The step's control tensors (tokens,
    page tables, lengths) are replicated: each rank reads its own copy,
    and the logits come back whole on ``devices[0]``."""

    def __init__(self, model, mesh: ServingMesh):
        from . import build_model
        self.base = model
        self.mesh = mesh
        self.cfg = model.cfg
        self.devices = tuple(normalize_device(d) for d in mesh.devices)
        self.device = self.devices[0]
        gqa = has_gqa(model)
        self.rank_cfgs = ([rank_config(model.cfg, r, mesh.size, gqa)
                           for r in range(mesh.size)]
                          if hasattr(model, "period_descs")
                          else [model.cfg] * mesh.size)
        self.ranks = [build_model(c, device=d,
                                  mla_absorb=getattr(model, "mla_absorb",
                                                     False))
                      for c, d in zip(self.rank_cfgs, self.devices)]

    # -- weights ---------------------------------------------------------------
    def shard(self, params):
        """Each rank's weights on its device (the plan is kept for
        ``unshard``)."""
        self.param_plan = param_plan(self.base, params, self.mesh.size)
        return shard_params(params, self.param_plan, self.devices)

    def unshard(self, shards, device="cpu"):
        return unshard_params(shards, self.param_plan, device)

    # -- what the engine asks of a model ---------------------------------------
    # the predicates: the whole model answers
    def supports_paged(self) -> bool:
        return self.base.supports_paged()

    def supports_prefix_sharing(self) -> bool:
        return self.base.supports_prefix_sharing()

    def supports_speculative(self) -> bool:
        return self.base.supports_speculative()

    def has_recurrent_state(self) -> bool:
        return self.base.has_recurrent_state()

    def has_kv_cache(self) -> bool:
        return self.base.has_kv_cache()

    def has_cache_typed_state(self) -> bool:
        return self.base.has_cache_typed_state()

    def n_attn_layers(self) -> int:
        return self.base.n_attn_layers()

    def state_slab_bytes(self, num_slots: int, dtype) -> int:
        """The largest rank's slab bytes: what one device must hold."""
        return max(m.state_slab_bytes(num_slots, dtype) for m in self.ranks)

    def _run(self, fn):
        return run_ranks(fn, self.devices)

    def init_paged_cache(self, num_blocks: int, block_size: int, **kw):
        return [m.init_paged_cache(num_blocks, block_size, **kw)
                for m in self.ranks]

    def copy_paged_block(self, cache, src: int, dst: int):
        return [m.copy_paged_block(c, src, dst)
                for m, c in zip(self.ranks, cache)]

    def gather_paged_pages(self, cache, blocks, slab: int):
        return [m.gather_paged_pages(c, blocks.to(d), slab)
                for m, c, d in zip(self.ranks, cache, self.devices)]

    def scatter_paged_pages(self, cache, payload, blocks, slab: int):
        return [m.scatter_paged_pages(c, p, blocks.to(d), slab)
                for m, c, p, d in zip(self.ranks, cache, payload,
                                      self.devices)]

    def paged_step(self, params, cache, tokens, page_table, lengths, t_valid,
                   state_slots=None, *, all_logits: bool = False):
        """Every rank's ``paged_step`` on its weights and pool; the write
        index (a host sync) is computed once per device, not per rank."""
        from .attention import paged_write_index
        index = {}
        bs = self.ranks[0].paged_block_size(cache[0])
        if bs is not None:
            for d in set(self.devices):
                index[d] = paged_write_index(
                    page_table.to(d), lengths.to(d), t_valid.to(d),
                    tokens.shape[1], bs)
        ctrl = (tokens, page_table, lengths, t_valid, state_slots)

        def one(r):
            d = self.devices[r]
            args = [None if t is None else t.to(d) for t in ctrl]
            return self.ranks[r].paged_step(
                params[r], cache[r], *args, all_logits=all_logits,
                index=index.get(d))
        outs = self._run(one)
        return outs[0][0], [o[1] for o in outs]

    def prefill(self, params, tokens, capacity: int, extra_embeds=None,
                cache_dtype=torch.bfloat16):
        """Every rank's dense prefill -> (rank 0's last-token logits, the
        ranks' caches)."""
        def one(r):
            d = self.devices[r]
            return self.ranks[r].prefill(
                params[r], tokens.to(d), capacity,
                extra_embeds=None if extra_embeds is None
                else extra_embeds.to(d), cache_dtype=cache_dtype)
        outs = self._run(one)
        return outs[0][0], [o[1] for o in outs]

    def decode_step(self, params, cache, token, pos: int):
        """Every rank's dense decode step -> (rank 0's logits, caches)."""
        outs = self._run(lambda r: self.ranks[r].decode_step(
            params[r], cache[r], token.to(self.devices[r]), pos))
        return outs[0][0], [o[1] for o in outs]

    def apply(self, params, tokens, *extra):
        """The full-sequence forward of every rank -> rank 0's (logits,
        aux), whole."""
        def one(r):
            d = self.devices[r]
            return self.ranks[r].apply(
                params[r], tokens.to(d),
                *[None if e is None else e.to(d) for e in extra])
        return self._run(one)[0]
