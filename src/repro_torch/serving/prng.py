"""Counter-based PRNG of the serving sampler: threefry2x32 keys and draws
as torch integer operations (the port's copy of what the reference takes
from ``jax.random``, at its defaults: the threefry2x32 implementation
with ``jax_threefry_partitionable=True``).

A key is a pair of uint32 words.  torch's uint32 dtype lacks most
arithmetic, so every word here is held in an **int64** tensor in
``[0, 2**32)``, and each add and rotate is masked back to 32 bits.  The
functions are vectorised over leading axes: ``keys`` is ``(..., 2)``.

* ``prng_key(seed)`` — ``jax.random.PRNGKey(seed)``: the words
  ``(seed >> 32, seed & 0xffffffff)``.
* ``fold_in(keys, data)`` — ``jax.random.fold_in``: threefry of the
  counter pair ``(0, data)`` under the key.
* ``random_bits(keys, n)`` — 32-bit ``jax.random.bits`` of shape
  ``(n,)`` per key: threefry of the hi and lo words of a 64-bit iota,
  ``bits1 ^ bits2``.
* ``uniform``, ``gumbel`` and ``categorical`` — the float draws built on
  them; ``categorical`` is the Gumbel-max draw with ties to the lowest
  index, as ``jnp.argmax``.

Keys, bits and uniforms equal ``jax.random``'s bit for bit; the Gumbel
noise is ``-log(-log(u))`` through torch's ``log``, which may differ
from XLA's in the last bit or so.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY_F32 = torch.finfo(torch.float32).tiny


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a (2,) int64 tensor of uint32
    words."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32],
                        dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    # x < 2**32 and r <= 29, so x << r stays inside int64
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter words
    ``(x1, x2)`` under the key words ``(k1, k2)``; all int64 tensors of
    uint32 values, broadcast together.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` per row: keys (..., 2), data an int or an
    integer tensor broadcastable to ``keys.shape[:-1]`` (taken as uint32,
    as the reference converts it) -> new keys (..., 2)."""
    if isinstance(data, int):
        hi, lo = 0, data & MASK32
    else:
        lo = data.to(torch.int64) & MASK32
        hi = torch.zeros_like(lo)
    y1, y2 = threefry2x32(keys[..., 0], keys[..., 1], hi, lo)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit random words: keys (..., 2) -> (..., n) int64 in
    [0, 2**32), each row ``jax.random.bits(key, (n,))`` of its key."""
    iota = torch.arange(n, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(keys[..., :1], keys[..., 1:], iota >> 32,
                          iota & MASK32)
    return b1 ^ b2


def _f32(v: float) -> float:
    """``v`` rounded to f32 (exact as a scalar operand of f32 ops)."""
    return torch.tensor(v, dtype=torch.float32).item()


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 uniforms in [minval, maxval): keys (..., 2) -> (..., n), as
    ``jax.random.uniform(key, (n,), minval=, maxval=)``: the top 23 bits
    of each word become the mantissa of a float in [1, 2), less one, then
    ``max(minval, u * (maxval - minval) + minval)`` in f32."""
    bits = random_bits(keys, n)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = _f32(minval)
    return (floats * _f32(_f32(maxval) - lo) + lo).clamp_min(lo)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Standard Gumbel noise (..., n) f32, ``jax.random.gumbel``'s default
    ("low") mode: ``-log(-log(u))`` with u uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(keys, n, minval=_TINY_F32)))


def argmax_first(x: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis, int32, as ``jnp.argmax``: ties to the
    lowest index, and a NaN counts as the maximum (so the index is always
    in range, even on a garbage row)."""
    mx = x.max(dim=-1, keepdim=True).values          # NaN if any is NaN
    hit = (x == mx) | (torch.isnan(x) & torch.isnan(mx))
    idx = torch.arange(x.shape[-1], device=x.device)
    return torch.where(hit, idx, x.shape[-1]).min(dim=-1).values \
        .to(torch.int32)


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row from ``softmax(logits)``: keys (..., 2), logits
    (..., V) f32 -> (...,) int32, as ``jax.random.categorical(key, row)``
    per row (Gumbel-max: argmax of ``logits + gumbel``)."""
    return argmax_first(gumbel(keys, logits.shape[-1]) + logits)
