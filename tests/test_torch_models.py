"""The port's model layers against the JAX reference, on the CPU.

Weights come from the reference's ``init`` through ``repro_torch.bridge``;
inputs are made with numpy from fixed seeds and fed to both sides.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from conftest import TINY_SERVE
from repro.models import attention as JA
from repro.models import build_model as jax_build_model
from repro.models import common as JC
from repro.models import mlp as JM
from repro_torch import bridge
from repro_torch.models import attention as TA
from repro_torch.models import build_model
from repro_torch.models import common as TC
from repro_torch.models import mlp as TM

torch.backends.cuda.matmul.allow_tf32 = False
CPU = torch.device("cpu")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """(jax model, jax params, port model, port params) for TINY_SERVE."""
    jm = jax_build_model(TINY_SERVE)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(TINY_SERVE, device="cpu")
    return jm, jp, tm, bridge.to_torch(_np_tree(jp), CPU)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_every_leaf(dtype):
    cfg = TINY_SERVE.replace(param_dtype=dtype, compute_dtype=dtype)
    jp = _np_tree(jax_build_model(cfg).init(jax.random.PRNGKey(1)))
    tp = bridge.to_torch(jp, CPU)
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert leaves
    for path, a in leaves:
        t = tp
        for key in path:
            t = t[key.key if hasattr(key, "key") else key.idx]
        assert tuple(t.shape) == a.shape, path
        if dtype == "bfloat16":
            assert a.dtype == ml_dtypes.bfloat16 and t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
    # the port's own init builds the same tree
    own = build_model(cfg, device="cpu").init(seed=0)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, tp))
    assert all(o.shape == t.shape and o.dtype == t.dtype for o, t in
               zip(jax.tree.leaves(own), jax.tree.leaves(tp)))


def test_norm_rope_swiglu_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = rng.standard_normal((16,)).astype(np.float32)
    pos = rng.integers(0, 1000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        TC.rmsnorm({"scale": torch.tensor(scale)}, torch.tensor(x)).numpy(),
        np.asarray(JC.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        atol=1e-6, rtol=0)
    for pct in (1.0, 0.5):
        np.testing.assert_allclose(
            TC.apply_rope(torch.tensor(x), torch.tensor(pos), 10000.0,
                          pct).numpy(),
            np.asarray(JC.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                     10000.0, pct)),
            atol=1e-6, rtol=0)
    h = rng.standard_normal((3, 32)).astype(np.float32)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.2 for k, s in
         (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    np.testing.assert_allclose(
        TM.mlp_forward({k: torch.tensor(v) for k, v in p.items()}, "swiglu",
                       torch.tensor(h)).numpy(),
        np.asarray(JM.mlp_forward({k: jnp.asarray(v) for k, v in p.items()},
                                  "swiglu", jnp.asarray(h))),
        atol=1e-6, rtol=0)


def test_gqa_paged_step_matches_with_scatter_and_oob_drop(tiny):
    _, jp, _, tp = tiny
    cfg = TINY_SERVE
    jattn = jax.tree.map(lambda a: a[0], jp["blocks"]["s0"]["attn"])
    tattn = {k: v[0] for k, v in tp["blocks"]["s0"]["attn"].items()}
    rng = np.random.default_rng(5)
    B, T, nb, bs, P = 4, 6, 12, 4, 3
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    k0 = rng.standard_normal((nb, bs, kv, hd)).astype(np.float32)
    v0 = rng.standard_normal((nb, bs, kv, hd)).astype(np.float32)
    pt = np.stack([rng.permutation(nb)[:P] for _ in range(B)]).astype(np.int32)
    # decode-like row, idle row, full chunk, a chunk running past the
    # page table (its last positions must be dropped, not written)
    lengths = np.array([5, 0, 2, P * bs - 3], np.int32)
    t_valid = np.array([1, 0, T, T], np.int32)
    jy, jk, jv = JA.gqa_paged_step(jattn, cfg, jnp.asarray(x),
                                   jnp.asarray(k0), jnp.asarray(v0),
                                   jnp.asarray(pt), jnp.asarray(lengths),
                                   jnp.asarray(t_valid))
    tk, tv = torch.tensor(k0), torch.tensor(v0)
    ty, tk2, tv2 = TA.gqa_paged_step(tattn, cfg, torch.tensor(x), tk, tv,
                                     torch.tensor(pt), torch.tensor(lengths),
                                     torch.tensor(t_valid))
    assert tk2 is tk and tv2 is tv          # updated in place
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)
    # rows past t_valid are garbage on both sides: compare the real ones
    for b in range(B):
        n = t_valid[b]
        np.testing.assert_allclose(ty[b, :n].numpy(), np.asarray(jy)[b, :n],
                                   atol=1e-5, rtol=0)
    # untouched blocks keep their content exactly
    written = {int(pt[b, (lengths[b] + t) // bs]) for b in range(B)
               for t in range(t_valid[b]) if (lengths[b] + t) // bs < P}
    for blk in set(range(nb)) - written:
        np.testing.assert_array_equal(tk[blk].numpy(), k0[blk])


def test_paged_step_logits_match_chunked_prefill_then_decode(tiny):
    jm, jp, tm, tp = tiny
    nb, bs, P, chunk = 16, 4, 6, 4
    jc = jm.init_paged_cache(nb, bs, dtype=jnp.float32)
    tc = tm.init_paged_cache(nb, bs, dtype=torch.float32)
    rng = np.random.default_rng(11)
    pt = np.stack([rng.permutation(nb)[:P] for _ in range(2)]).astype(np.int32)
    prompts = [rng.integers(0, TINY_SERVE.vocab_size, n).astype(np.int32)
               for n in (9, 6)]
    lengths = np.zeros(2, np.int32)
    step = jax.jit(jm.paged_step)
    nxt = None
    for it in range(8):
        tokens = np.zeros((2, chunk), np.int32)
        t_valid = np.zeros(2, np.int32)
        for b, pr in enumerate(prompts):
            if lengths[b] < len(pr):
                n = min(chunk, len(pr) - lengths[b])
                tokens[b, :n] = pr[lengths[b]:lengths[b] + n]
                t_valid[b] = n
            else:
                tokens[b, 0] = nxt[b]
                t_valid[b] = 1
        if all(lengths[b] >= len(pr) for b, pr in enumerate(prompts)):
            tokens = tokens[:, :1]            # pure decode: T = 1
        jl, jc = step(jp, jc, jnp.asarray(tokens), jnp.asarray(pt),
                      jnp.asarray(lengths), jnp.asarray(t_valid))
        tl, tc = tm.paged_step(tp, tc, torch.tensor(tokens), torch.tensor(pt),
                               torch.tensor(lengths), torch.tensor(t_valid))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0, err_msg=f"step {it}")
        nxt = np.asarray(jl).argmax(-1)
        lengths = lengths + t_valid
    assert tokens.shape[1] == 1               # decode steps were reached
    all_l, _ = tm.paged_step(tp, tc, torch.tensor(tokens), torch.tensor(pt),
                             torch.tensor(lengths), torch.tensor(t_valid),
                             all_logits=True)
    assert tuple(all_l.shape) == (2, 1, TINY_SERVE.vocab_size)
