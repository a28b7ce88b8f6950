"""The port's threefry PRNG (``repro_torch/serving/prng.py``) against
``jax.random`` at its defaults, on the CPU.

Keys, 32-bit words and uniforms must be equal bit for bit.  The Gumbel
noise goes through torch's ``log`` where the reference goes through
XLA's, so it is held within 1e-6 (the largest difference seen over
49152 draws is 4.8e-7, one or two f32 ulps near |g| ~ 1-3); the
categorical draws on top of it must give the same tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from repro_torch.serving import prng

GUMBEL_ATOL = 1e-6
TINY = float(np.finfo(np.float32).tiny)


def _key_data(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def _jax_keys(seed, rows):
    base = jax.random.PRNGKey(seed)
    return jax.vmap(lambda r: jax.random.fold_in(base, r))(jnp.asarray(rows))


def _port_keys(seed, rows):
    return prng.fold_in(prng.prng_key(seed), torch.as_tensor(rows))


@pytest.mark.parametrize("seed", [0, 11, 2**31 - 1])
def test_prng_key_bitwise(seed):
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(),
                                  _key_data(jax.random.PRNGKey(seed)))


def test_fold_in_chains_bitwise():
    """``fold_in(fold_in(PRNGKey(s), rid), step)`` per row (the engine's
    sampler keys) and scalar chains, including data past 2**31."""
    rng = np.random.default_rng(0)
    rids = rng.integers(0, 2**31 - 1, 64).astype(np.int32)
    steps = rng.integers(0, 4096, 64).astype(np.int32)
    want = jax.vmap(lambda r, t: jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(7), r), t))(
        jnp.asarray(rids), jnp.asarray(steps))
    got = prng.fold_in(prng.fold_in(prng.prng_key(7), torch.as_tensor(rids)),
                       torch.as_tensor(steps))
    np.testing.assert_array_equal(got.numpy(), _key_data(want))
    k, tk = jax.random.PRNGKey(11), prng.prng_key(11)
    for d in (3, 5, 0x5BEC, 2**32 - 1):
        k, tk = jax.random.fold_in(k, np.uint32(d)), prng.fold_in(tk, d)
        np.testing.assert_array_equal(tk.numpy(), _key_data(k))


def test_threefry2x32_random_words_bitwise():
    rng = np.random.default_rng(1)
    k = rng.integers(0, 2**32, 2, dtype=np.uint32)
    x = rng.integers(0, 2**32, (2, 1000), dtype=np.uint32)
    want = np.asarray(jprng.threefry_2x32(
        (jnp.uint32(k[0]), jnp.uint32(k[1])), jnp.asarray(x.reshape(-1))))
    t = [torch.as_tensor(a.astype(np.int64)) for a in (k[0], k[1], x[0], x[1])]
    y1, y2 = prng.threefry2x32(*t)
    np.testing.assert_array_equal(np.concatenate([y1.numpy(), y2.numpy()]),
                                  want.astype(np.int64))


@pytest.mark.parametrize("n", [1, 3, 4096, 49152])
def test_random_bits_bitwise(n):
    rows = np.arange(4, dtype=np.int32) * 7919
    want = jax.vmap(lambda k: jax.random.bits(k, (n,)))(_jax_keys(3, rows))
    got = prng.random_bits(_port_keys(3, rows), n)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("minval", [TINY, 0.0])
def test_uniform_bitwise(minval):
    rows = np.arange(8, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (4099,), minval=minval, maxval=1.0))(_jax_keys(5, rows)))
    got = prng.uniform(_port_keys(5, rows), 4099, minval=minval).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got.min() >= minval and got.max() < 1.0


def test_gumbel_within_tolerance():
    rows = np.arange(2, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (49152,)))(
        _jax_keys(11, rows)))
    got = prng.gumbel(_port_keys(11, rows), 49152).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=GUMBEL_ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_categorical_tokens_equal(masked):
    """256 rows of random logits, with and without -inf entries (the
    top-k mask's form): the drawn tokens are equal."""
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((256, 1000)).astype(np.float32)
    if masked:
        logits[rng.random(logits.shape) < 0.9] = -np.inf
        logits[:, 0] = 0.0                 # every row keeps one entry
    rows = np.arange(256, dtype=np.int32)
    want = np.asarray(jax.vmap(jax.random.categorical)(
        _jax_keys(13, rows), jnp.asarray(logits)))
    got = prng.categorical(_port_keys(13, rows), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)


def test_argmax_first_ties_and_nan_as_jnp():
    x = np.array([[1.0, 3.0, 3.0, 0.0], [np.nan, 1.0, np.nan, 5.0],
                  [-np.inf] * 4, [2.0, np.inf, np.inf, 1.0]], np.float32)
    np.testing.assert_array_equal(
        prng.argmax_first(torch.from_numpy(x)).numpy(),
        np.asarray(jnp.argmax(jnp.asarray(x), axis=-1)))
