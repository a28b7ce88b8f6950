"""Decode attention: CUDA kernel wrappers, plain versions, checks.

``paged_decode_attention`` is the port of
``repro/kernels/decode_attention/kernel.py::paged_decode_attention``
(see ``csrc/paged_decode.cu`` for the kernel and what bounds it).  It
takes the serving engine's pool layout ``(nb, bs, KV, hd)`` directly.
``decode_attention`` is the port of ``decode_attention`` in the same
file, the dense engine's one-token step over a contiguous cache (see
``csrc/dense_decode.cu``).  ``paged_decode_attention_quant`` is the port
of ``paged_decode_attention_quant`` there, the paged step over int8
pools with per-row f32 scales (see ``csrc/paged_decode_quant.cu``).
``mla_decode_attention`` is ``decode_attention`` on DeepSeek-V3's MLA
operands as the expanded decode makes them: the rope key shared by every
head, read in place from the latent cache, and V at its own head dim (its
bf16 body, ``csrc/decode_mla.cuh``, is built for one query head per K/V
head).  On a CPU tensor each runs its plain version; on a CUDA tensor it
launches its kernel or raises.

All of them split each row's key range over ``n_split`` blocks and
combine the partial softmaxes in the same launch
(``csrc/decode_body.cuh``, ``csrc/decode_mla.cuh``,
``csrc/decode_gqa_mma.cuh``).  ``decode_entry`` picks K1's and B4's C
entry, ``quant_decode_entry`` B3's, from dtypes, the group size G = H /
KV and head_dim alone: bf16 and f32 at ``G <= MMA_MAX_GROUP`` and
``MMA_HEAD_DIMS`` go to the tensor-core body (``*_bf16_bf16_mma``,
``*_f32_f32_tf32``), and so do int8 pools there
(``paged_decode_attention_quant_f32_tf32``); everything else to
``decode_body.cuh``.  ``split_plan`` (and
``mma_split_plan`` for the tensor-core body) picks the split from
host-known values only (shapes, ``P * bs``, ``n_valid``), never from
``lengths``, so a call reads no device tensor on the host; the f32
partials and the per-pair counters live in one workspace per device
(``workspace``), grown when a shape needs more and used on the current
stream.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from ..build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
# every entry ends in: scale, split_keys, n_split, workspace, counters,
# stream
_SPLIT = [ctypes.c_float, _I, _I, _P, _P, _P]
# the GQA entries' type suffixes: decode_body.cuh's (q, K/V) pairs, then
# the tensor-core body's (csrc/decode_gqa_mma.cuh)
_PAIRS = ("f32_f32", "f32_bf16", "bf16_bf16")
_MMA_SUFFIXES = ("bf16_bf16_mma", "f32_f32_tf32")
# the tensor-core body: head dims it is built for, and the largest group
# G = H / KV (its 16 MMA rows).  The dispatch sends it every G up to that:
# chip_smoke.py phase 3 times both bodies at G = 1, 3, 4, 8, 12 and 16,
# and decode_body.cuh was the faster at none (PERF.md §6)
MMA_HEAD_DIMS = (64, 128, 192)
MMA_MAX_GROUP = 16
MMA_KEY_TILE = 16        # its splits are multiples of its 16-key tiles
# a split of the tensor-core body moves about this many K/V bytes, and no
# plan gives an SM more than one block: at phase 3's shapes smaller
# splits and more blocks than SMs measured slower (kernel_ab.py
# --decode-splits; merging the splits costs more than spreading them
# gains).  Split TF32 does about four times bf16's work on each byte
# (three products and their splits), and its best splits held a quarter
# of the bytes.  int8 pools (B3) count a key's int8 K and V rows and their
# two f32 scales (2 * hd + 8 bytes)
MMA_SPLIT_BYTES = {torch.bfloat16: 512 << 10, torch.float32: 128 << 10,
                   torch.int8: 64 << 10}


KERNEL = CudaKernel(
    "paged_decode_attention",
    Path(__file__).parent / "csrc" / "paged_decode.cu",
    {f"paged_decode_attention_{s}": [_P] * 6 + [_I] * 6 + _SPLIT
     for s in _PAIRS + _MMA_SUFFIXES})

QUANT_KERNEL = CudaKernel(
    "paged_decode_attention_quant",
    Path(__file__).parent / "csrc" / "paged_decode_quant.cu",
    {f"paged_decode_attention_quant_{s}": [_P] * 8 + [_I] * 6 + _SPLIT
     for s in ("f32", "f32_tf32")})

DENSE_KERNEL = CudaKernel(
    "decode_attention",
    Path(__file__).parent / "csrc" / "dense_decode.cu",
    {**{f"decode_attention_{s}": [_P] * 4 + [_I] * 6 + _SPLIT
        for s in _PAIRS + _MMA_SUFFIXES},
     "decode_attention_mla_bf16": [_P] * 5 + [_I] * 5 + _SPLIT})
# (qk_nope_head_dim, qk_rope_head_dim, v_head_dim) the MLA entries are
# built for: DeepSeek-V3's, as csrc/common.cuh's MlaDims states them
MLA_DIMS = (128, 64, 128)

KEY_TILE = 32          # keys per tile of the kernels: splits are multiples
MIN_SPLIT_KEYS = 64    # no split takes fewer keys
TARGET_BLOCKS = 264    # two blocks for each of an H100's 132 SMs


def _host_ints(name, *xs):
    if any(isinstance(x, torch.Tensor) for x in xs):
        raise TypeError(f"{name} takes host ints: reading a tensor would "
                        "sync the device")
    xs = tuple(int(x) for x in xs)
    if min(xs) < 1:
        raise ValueError(f"{name}{xs}: all must be >= 1")
    return xs


def split_plan(max_keys: int, pairs: int):
    """(n_split, split_keys) for ``pairs`` (row, KV head) pairs whose rows
    hold at most ``max_keys`` keys: enough splits that ``pairs * n_split``
    reaches ``TARGET_BLOCKS``, none shorter than ``MIN_SPLIT_KEYS``, each
    a whole number of key tiles.  Host ints in, host ints out: the plan
    never depends on what a device tensor holds."""
    max_keys, pairs = _host_ints("split_plan", max_keys, pairs)
    n_split = max(1, min(-(-max_keys // MIN_SPLIT_KEYS),
                         -(-TARGET_BLOCKS // pairs)))
    return _whole_tiles(max_keys, n_split, KEY_TILE)


def _whole_tiles(max_keys: int, n_split: int, tile: int):
    """(n_split, split_keys): about ``n_split`` splits of whole tiles."""
    split_keys = -(-max_keys // n_split)
    split_keys = -(-split_keys // tile) * tile
    return -(-max_keys // split_keys), split_keys


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The streaming multiprocessors of CUDA ``device``, from its
    properties (a host read: no device sync), once a device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def mma_split_plan(max_keys: int, pairs: int, key_bytes: int,
                   split_bytes: int, sms: int):
    """(n_split, split_keys) of the tensor-core body
    (``csrc/decode_gqa_mma.cuh``) for ``pairs`` (row, KV head) pairs of at
    most ``max_keys`` keys, each key ``key_bytes`` of K and V, on a device
    of ``sms`` SMs: as many splits as a row's K/V bytes hold
    ``split_bytes`` (rounded up), but no more blocks than SMs
    (``pairs * n_split <= sms`` unless the pairs alone are more), each a
    whole number of ``MMA_KEY_TILE`` tiles.  Host ints in, host ints
    out."""
    max_keys, pairs, key_bytes, split_bytes, sms = _host_ints(
        "mma_split_plan", max_keys, pairs, key_bytes, split_bytes, sms)
    n_split = max(1, min(-(-max_keys * key_bytes // split_bytes),
                         sms // pairs))
    return _whole_tiles(max_keys, n_split, MMA_KEY_TILE)


def decode_entry(prefix: str, qdt, kvdt, G: int, hd: int) -> str:
    """The C entry ``prefix`` (``paged_decode_attention`` or
    ``decode_attention``) launches for q of type ``qdt`` over K/V of type
    ``kvdt``, ``G`` query heads a KV head, head_dim ``hd``: the
    tensor-core body (``_bf16_bf16_mma``, ``_f32_f32_tf32``) for one type
    throughout at ``G <= MMA_MAX_GROUP`` and
    ``MMA_HEAD_DIMS``, else decode_body.cuh's ``_{q}_{kv}``.  From dtypes
    and shapes alone, never from a failed build or launch."""
    name = f"{prefix}_{_NAMES[qdt]}_{_NAMES[kvdt]}"
    if qdt == kvdt and G <= MMA_MAX_GROUP \
            and hd in MMA_HEAD_DIMS:
        return name + ("_mma" if qdt == torch.bfloat16 else "_tf32")
    return name


def quant_decode_entry(G: int, hd: int) -> str:
    """The C entry B3 (f32 q over int8 pools) launches for ``G`` query
    heads a KV head at head_dim ``hd``: the tensor-core body's
    ``paged_decode_attention_quant_f32_tf32`` at ``G <= MMA_MAX_GROUP``
    and ``MMA_HEAD_DIMS``, else decode_body.cuh's
    ``paged_decode_attention_quant_f32``.  From shapes alone, never from a
    failed build or launch."""
    if G <= MMA_MAX_GROUP and hd in MMA_HEAD_DIMS:
        return "paged_decode_attention_quant_f32_tf32"
    return "paged_decode_attention_quant_f32"


def _occupancy(lib, prefix: str, dt: str, hd: int) -> dict:
    fn = getattr(lib, f"{prefix}_gqa_occupancy")
    fn.argtypes, fn.restype = [_I, _I, ctypes.POINTER(_I)], _I
    out = (_I * 7)()
    rc = fn(int(dt == "bf16"), hd, out)
    if rc != 0:
        raise RuntimeError(f"{prefix}_gqa_occupancy: CUDA error {rc} "
                           f"({lib.kernel_error_string(rc).decode()})")
    return dict(zip(("registers", "spill_bytes", "smem_bytes",
                     "blocks_per_sm", "warps", "tile_keys", "stages"), out))


def gqa_decode_occupancy(kernel, dt: str, hd: int) -> dict:
    """What the card makes of the tensor-core body in ``kernel``
    (``KERNEL`` or ``DENSE_KERNEL`` for ``dt`` "bf16" or "f32" operands,
    ``QUANT_KERNEL`` for "int8" K/V under f32 q) at head_dim ``hd``:
    registers and local (spill) bytes a thread, dynamic shared bytes a
    block, resident blocks an SM, warps a block, keys a warp tile, ring
    stages.  Builds the library; launches nothing."""
    if (kernel is QUANT_KERNEL) != (dt == "int8"):
        raise ValueError(f"{kernel.name} has no {dt} tensor-core body")
    return _occupancy(kernel.load(), kernel.name, dt, hd)


_WORKSPACE = {}


def workspace(device, n_floats: int, n_pairs: int):
    """(f32 partials, int32 counters) of at least these sizes on
    ``device``: one pair per device, allocated at first use and grown (the
    counters zeroed) when a call needs more.  The kernels leave every
    counter at 0, so the buffers carry nothing from one call to the next
    on a stream."""
    key = torch.device(device)
    ws, cnt = _WORKSPACE.get(key, (None, None))
    if ws is None or ws.numel() < n_floats:
        ws = torch.empty((max(n_floats, 1),), dtype=torch.float32,
                         device=device)
    if cnt is None or cnt.numel() < n_pairs:
        cnt = torch.zeros((n_pairs,), dtype=torch.int32, device=device)
    _WORKSPACE[key] = (ws, cnt)
    return ws, cnt


def _is_mma(entry: str) -> bool:
    return entry.endswith(("_mma", "_tf32"))


def key_bytes(kv_dtype, hd: int) -> int:
    """Bytes a key of K/V of ``kv_dtype`` at head_dim ``hd`` moves: its
    K and V rows, and for int8 pools their two f32 row scales."""
    return 2 * hd * kv_dtype.itemsize + (8 if kv_dtype == torch.int8 else 0)


def entry_split_plan(entry: str, max_keys: int, pairs: int, kv_dtype,
                     hd: int, sms: int):
    """(n_split, split_keys) that C entry ``entry`` runs with for
    ``pairs`` (row, KV head) pairs of at most ``max_keys`` keys, K/V of
    ``kv_dtype`` (q's type, or int8) at head_dim ``hd``, on a device of
    ``sms`` SMs: ``mma_split_plan`` for the tensor-core body's entries
    (``MMA_SPLIT_BYTES`` of the K/V type), ``split_plan`` for the
    others."""
    if _is_mma(entry):
        return mma_split_plan(max_keys, pairs, key_bytes(kv_dtype, hd),
                              MMA_SPLIT_BYTES[kv_dtype], sms)
    return split_plan(max_keys, pairs)


def _split_args(q, max_keys: int, KV: int, vd: int = 0, entry: str = "",
                kv_dtype=None):
    """The kernels' trailing split arguments for q (B, H, hd) over rows of
    at most ``max_keys`` keys of K/V of ``kv_dtype`` (default q's type),
    output rows ``vd`` wide (default hd), for C entry ``entry``:
    split_keys, n_split and the workspace."""
    B, H, hd = q.shape
    kv_dtype = q.dtype if kv_dtype is None else kv_dtype
    n_split, split_keys = entry_split_plan(
        entry, max_keys, B * KV, kv_dtype, hd,
        sm_count(q.device) if _is_mma(entry) else 1)
    G = H // KV
    ws, cnt = workspace(q.device, B * KV * n_split * G * ((vd or hd) + 2),
                        B * KV)
    return (split_keys, n_split, ws.data_ptr(), cnt.data_ptr())

_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# (query type, K/V type) pairs the kernels are built for: a bf16 model
# with an f32 pool is refused by the engine (see ServeEngine)
SUPPORTED = {(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.bfloat16)}


def check_paged_operands(q, k_pool, v_pool, page_table, lengths, n_q_dims,
                         scales=()):
    """Raise unless the operands are what the paged kernels take: one
    CUDA device, contiguous, a supported (q, K/V) type pair, pools of
    shape (nb, bs, KV, hd) with KV dividing q's heads and hd % 8 == 0,
    int32 page table (B, P) and lengths (B,).  With ``scales`` (the
    int8 kernels' k_scale, v_scale): f32 q, int8 pools, f32 scales of
    shape (nb, bs, KV) and hd % 16 == 0."""
    ts = (q, k_pool, v_pool, page_table, lengths) + tuple(scales)
    if any(t.device != q.device for t in ts):
        raise ValueError("paged attention operands must share one device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("paged attention operands must be contiguous")
    if scales:
        if q.dtype != torch.float32 or k_pool.dtype != torch.int8 \
                or v_pool.dtype != torch.int8 \
                or any(s.dtype != torch.float32 for s in scales):
            raise TypeError(f"the int8 kernels take f32 q, int8 pools and "
                            f"f32 scales, got q={q.dtype} k={k_pool.dtype} "
                            f"v={v_pool.dtype} scales="
                            f"{[s.dtype for s in scales]}")
        if any(tuple(s.shape) != tuple(k_pool.shape[:3]) for s in scales):
            raise ValueError(f"scales {[tuple(s.shape) for s in scales]} do "
                             f"not match pool {tuple(k_pool.shape)}")
    elif (q.dtype, k_pool.dtype) not in SUPPORTED \
            or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"unsupported dtypes q={q.dtype} k={k_pool.dtype} "
                        f"v={v_pool.dtype}; kernels take {sorted(map(str, SUPPORTED))}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    if q.dim() != n_q_dims or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"bad shapes q={tuple(q.shape)} "
                         f"k={tuple(k_pool.shape)} v={tuple(v_pool.shape)}")
    B, H, hd = q.shape[0], q.shape[-2], q.shape[-1]
    KV = k_pool.shape[2]
    if k_pool.shape[3] != hd or H % KV:
        raise ValueError(f"q heads/head_dim {H}/{hd} do not fit pool "
                         f"{tuple(k_pool.shape)}")
    chunk = 16 if scales else 8          # values per 16-byte load
    if hd % chunk:
        raise ValueError(f"head_dim {hd}: the kernels load K/V rows in "
                         f"16-byte chunks and need head_dim % {chunk} == 0")
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {B}")


def paged_decode_attention_plain(q, k_pool, v_pool, page_table, lengths):
    """The same function in plain PyTorch: the reference's
    ``paged_attention`` over ``paged_gather`` with query position
    ``lengths - 1`` (keys ``kpos < lengths`` are visible)."""
    # imported here: models.attention imports this module
    from ...models.attention import paged_attention, paged_gather
    o = paged_attention(q[:, None], paged_gather(k_pool, page_table),
                        paged_gather(v_pool, page_table),
                        (lengths - 1)[:, None])
    return o[:, 0]


def paged_decode_attention(q, k_pool, v_pool, page_table, lengths):
    """q: (B, H, hd); k_pool/v_pool: (nb, bs, KV, hd); page_table: (B, P)
    int32; lengths: (B,) int32 >= 1, the number of valid keys of each
    slot -> (B, H, hd) in the pool's dtype."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, page_table,
                                            lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    check_paged_operands(q, k_pool, v_pool, page_table, lengths, 3)
    B, H, hd = q.shape
    bs, KV = k_pool.shape[1], k_pool.shape[2]
    out = torch.empty(q.shape, dtype=k_pool.dtype, device=q.device)
    # the kernel launches on the runtime's current device: one card
    stream = torch.cuda.current_stream(q.device).cuda_stream
    P = page_table.shape[1]
    entry = decode_entry("paged_decode_attention", q.dtype, k_pool.dtype,
                         H // KV, hd)
    KERNEL.launch(
        entry, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, H, KV, hd, bs, P, ctypes.c_float(1.0 / np.sqrt(hd)),
        *_split_args(q, P * bs, KV, entry=entry), stream)
    return out


def paged_decode_attention_quant_plain(q, k_pool, v_pool, k_scale, v_scale,
                                       page_table, lengths):
    """The same function in plain PyTorch: the reference's
    ``paged_attention`` over ``dequant_gather`` with
    query position ``lengths - 1``."""
    # imported here: models.attention imports this module
    from ...models.attention import dequant_gather, paged_attention
    k = dequant_gather(k_pool, k_scale, page_table)
    v = dequant_gather(v_pool, v_scale, page_table)
    return paged_attention(q[:, None], k, v, (lengths - 1)[:, None])[:, 0]


def paged_decode_attention_quant(q, k_pool, v_pool, k_scale, v_scale,
                                 page_table, lengths):
    """q: (B, H, hd) f32; k_pool/v_pool: (nb, bs, KV, hd) int8;
    k_scale/v_scale: (nb, bs, KV) f32 per-row scales; page_table: (B, P)
    int32; lengths: (B,) int32 >= 1 valid keys -> (B, H, hd) f32."""
    if q.device.type == "cpu":
        return paged_decode_attention_quant_plain(
            q, k_pool, v_pool, k_scale, v_scale, page_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_decode_attention_quant: no kernel for {q.device}")
    check_paged_operands(q, k_pool, v_pool, page_table, lengths, 3,
                         scales=(k_scale, v_scale))
    B, H, hd = q.shape
    bs, KV = k_pool.shape[1], k_pool.shape[2]
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    P = page_table.shape[1]
    entry = quant_decode_entry(H // KV, hd)
    QUANT_KERNEL.launch(
        entry, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, H, KV, hd, bs, P,
        ctypes.c_float(1.0 / np.sqrt(hd)),
        *_split_args(q, P * bs, KV, entry=entry, kv_dtype=torch.int8),
        stream)
    return out


def check_dense_operands(q, k_cache, v_cache, n_valid):
    """Raise unless the operands are what the dense decode kernel takes:
    one CUDA device, contiguous, a supported (q, K/V) type pair, q (B, H,
    hd) and caches (B, C, KV, hd) with KV dividing H and hd % 8 == 0, and
    1 <= n_valid <= C."""
    ts = (q, k_cache, v_cache)
    if any(t.device != q.device for t in ts):
        raise ValueError("decode attention operands must share one device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("decode attention operands must be contiguous")
    if (q.dtype, k_cache.dtype) not in SUPPORTED \
            or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"unsupported dtypes q={q.dtype} k={k_cache.dtype} "
                        f"v={v_cache.dtype}; the kernel takes "
                        f"{sorted(map(str, SUPPORTED))}")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"bad shapes q={tuple(q.shape)} "
                         f"k={tuple(k_cache.shape)} v={tuple(v_cache.shape)}")
    B, H, hd = q.shape
    C, KV = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != hd or H % KV:
        raise ValueError(f"q {tuple(q.shape)} does not fit cache "
                         f"{tuple(k_cache.shape)}")
    if hd % 8:
        raise ValueError(f"head_dim {hd}: the kernel loads K/V rows in "
                         "16-byte chunks and needs head_dim % 8 == 0")
    if not 1 <= n_valid <= C:
        raise ValueError(f"n_valid {n_valid} outside [1, {C}]")


def decode_attention_plain(q, k_cache, v_cache, n_valid: int):
    """The same function in plain PyTorch: the reference's
    ``decode_attention`` with the new token at position ``n_valid - 1``
    (slots ``< n_valid`` are visible)."""
    # imported here: models.attention imports this module
    from ...models.attention import decode_attention as reference
    return reference(q[:, None], k_cache, v_cache, n_valid - 1)[:, 0]


def decode_attention(q, k_cache, v_cache, n_valid: int):
    """q: (B, H, hd); k_cache/v_cache: (B, C, KV, hd); n_valid: host int,
    the slots every row attends to (``min(pos + 1, C)``: a wrapped ring
    has all C valid) -> (B, H, hd) in the cache's dtype."""
    n_valid = int(n_valid)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, n_valid)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    check_dense_operands(q, k_cache, v_cache, n_valid)
    B, H, hd = q.shape
    C, KV = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty(q.shape, dtype=k_cache.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    entry = decode_entry("decode_attention", q.dtype, k_cache.dtype,
                         H // KV, hd)
    DENSE_KERNEL.launch(
        entry, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        out.data_ptr(), B, C, H, KV, hd, n_valid,
        ctypes.c_float(1.0 / np.sqrt(hd)),
        *_split_args(q, n_valid, KV, entry=entry), stream)
    return out


# -- MLA (DeepSeek-V3): K = [k_nope | one rope key shared by every head] ----

def mla_entry(dtypes, dims) -> str:
    """The C entry of ``DENSE_KERNEL`` that serves MLA's operands of these
    types (q, k_nope, rope key, V) and ``dims`` (nope, rope, v head dims):
    ``decode_attention_mla_bf16`` for bf16 throughout at ``MLA_DIMS``,
    else the GQA entry (``decode_entry`` at G = 1, head_dim nope + rope)
    that ``mla_gqa_operands``' concatenation goes to.  From dtypes and
    dims alone, never from a failed build or launch."""
    if tuple(dims) == MLA_DIMS and all(d == torch.bfloat16 for d in dtypes):
        return "decode_attention_mla_bf16"
    kv = torch.promote_types(dtypes[1], dtypes[2])
    # the padded operands: one K/V head a query head, head_dim nope + rope
    return decode_entry("decode_attention", dtypes[0], kv, 1,
                        dims[0] + dims[1])


def mla_gqa_operands(k_nope, k_rope, v):
    """MLA's K/V as one-head_dim GQA operands: k = [k_nope | the shared rope
    key broadcast to every head] (B, T, H, nope + rope) in the promoted
    type of the two, V zero-padded from its head dim to that one (the
    padded output columns are 0 and are cut off), both contiguous.
    k_nope, v: (B, T, H, .); k_rope: (B, T, rope)."""
    nope, rope, vd = k_nope.shape[-1], k_rope.shape[-1], v.shape[-1]
    if vd > nope + rope:
        raise ValueError(f"MLA v_head_dim {vd} > q/k head {nope + rope}: the "
                         "GQA kernels take one head_dim")
    dt = torch.promote_types(k_nope.dtype, k_rope.dtype)
    k = torch.cat([k_nope.to(dt), k_rope[:, :, None].to(dt).expand(
        k_nope.shape[:3] + (rope,))], dim=-1)
    v = torch.nn.functional.pad(v, (0, nope + rope - vd))
    return k.contiguous(), v.to(dt).contiguous()


def check_mla_operands(q, k_nope, k_rope, v, n_q_dims: int):
    """Raise unless the operands are what the MLA entries take: one CUDA
    device, bf16, contiguous, 16-byte aligned; q (B, [S,] H, nope + rope),
    k_nope (B, T, H, nope), V (B, T, H, v) and a rope key (B, C, rope)
    with C >= T, at ``MLA_DIMS``."""
    ts = (q, k_nope, k_rope, v)
    if any(t.device != q.device for t in ts):
        raise ValueError("MLA attention operands must share one device")
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise TypeError(f"the MLA entries take bf16, got "
                        f"{[t.dtype for t in ts]}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in ts):
        raise ValueError("MLA attention operands must be contiguous and "
                         "16-byte aligned")
    if q.dim() != n_q_dims or k_nope.dim() != 4 or k_rope.dim() != 3 \
            or v.dim() != 4:
        raise ValueError(f"bad shapes q={tuple(q.shape)} "
                         f"k_nope={tuple(k_nope.shape)} "
                         f"k_rope={tuple(k_rope.shape)} v={tuple(v.shape)}")
    B, T, H, nope = k_nope.shape
    dims = (nope, k_rope.shape[-1], v.shape[-1])
    if dims != MLA_DIMS:
        raise ValueError(f"MLA dims {dims}: the entries are built for "
                         f"{MLA_DIMS}")
    if q.shape[0] != B or q.shape[-2:] != (H, nope + dims[1]) \
            or v.shape[:3] != (B, T, H) or k_rope.shape[0] != B \
            or k_rope.shape[1] < T:
        raise ValueError(f"q {tuple(q.shape)}, v {tuple(v.shape)} and rope "
                         f"key {tuple(k_rope.shape)} do not fit k_nope "
                         f"{tuple(k_nope.shape)}")


def mla_decode_occupancy() -> dict:
    """What the card makes of ``decode_attention_mla_bf16``'s kernel
    (``csrc/decode_mla.cuh``): registers and local (spill) bytes a
    thread, dynamic shared bytes a block, resident blocks an SM, and its
    layout (warps a block, keys a warp tile, ring stages).  Builds the
    library; launches nothing."""
    lib = DENSE_KERNEL.load()
    fn = lib.decode_attention_mla_bf16_occupancy
    fn.argtypes, fn.restype = [ctypes.POINTER(_I)], _I
    out = (_I * 7)()
    rc = fn(out)
    if rc != 0:
        raise RuntimeError(f"decode_attention_mla_bf16_occupancy: CUDA error "
                           f"{rc} ({lib.kernel_error_string(rc).decode()})")
    return dict(zip(("registers", "spill_bytes", "smem_bytes",
                     "blocks_per_sm", "warps", "tile_keys", "stages"), out))


def mla_decode_attention_plain(q, k_nope, kr_cache, v, n_valid: int):
    """The same function in plain PyTorch: ``decode_attention_plain`` over
    ``mla_gqa_operands`` of the first ``n_valid`` rope slots, cut to V's
    head dim."""
    k, vp = mla_gqa_operands(k_nope, kr_cache[:, :k_nope.shape[1]], v)
    return decode_attention_plain(q, k, vp, n_valid)[..., :v.shape[-1]]


def mla_decode_attention(q, k_nope, kr_cache, v, n_valid: int):
    """q: (B, H, nope + rope) = [q_nope | q_rope]; k_nope (B, T, H, nope)
    and v (B, T, H, vd): the keys and values of the T >= n_valid first
    slots; kr_cache: (B, C, rope), C >= T, the rope key of each slot,
    shared by every head and read in place; n_valid: host int, the slots
    the new token attends to -> (B, H, vd) in K/V's type.  Scale
    1/sqrt(nope + rope).  bf16 at ``MLA_DIMS`` launches
    ``decode_attention_mla_bf16``; other types or dims launch the GQA
    entry over ``mla_gqa_operands``."""
    n_valid = int(n_valid)
    if q.device.type == "cpu":
        return mla_decode_attention_plain(q, k_nope, kr_cache, v, n_valid)
    if q.device.type != "cuda":
        raise ValueError(f"mla_decode_attention: no kernel for {q.device}")
    dims = (k_nope.shape[-1], kr_cache.shape[-1], v.shape[-1])
    entry = mla_entry((q.dtype, k_nope.dtype, kr_cache.dtype, v.dtype), dims)
    if entry != "decode_attention_mla_bf16":
        k, vp = mla_gqa_operands(k_nope, kr_cache[:, :k_nope.shape[1]], v)
        return decode_attention(q, k, vp, n_valid)[..., :v.shape[-1]]
    check_mla_operands(q, k_nope, kr_cache, v, 3)
    B, T, H, _ = k_nope.shape
    if not 1 <= n_valid <= T:
        raise ValueError(f"n_valid {n_valid} outside [1, {T}]")
    vd = v.shape[-1]
    out = torch.empty((B, H, vd), dtype=v.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    DENSE_KERNEL.launch(
        entry, q.data_ptr(), k_nope.data_ptr(), kr_cache.data_ptr(),
        v.data_ptr(), out.data_ptr(), B, T, kr_cache.shape[1], H, n_valid,
        ctypes.c_float(1.0 / np.sqrt(q.shape[-1])),
        *_split_args(q, n_valid, H, vd), stream)
    return out
