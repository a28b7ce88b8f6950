"""The port's sharding plan and in-process collectives
(``repro_torch/models/sharding.py``), on the CPU.

Shard then unshard gives every smoke config's parameters back bit for
bit; every leaf the reference's ``param_specs`` puts on "model" is
split by the port's plan or is listed, with its reason, in the module's
table of differences; one rank holds about half the weights at N = 2;
the uneven head split (smollm-360m's 15/5 heads) and KV heads shared by
ranks (TINY's 4/2 at N = 4) run the reference's tokens; the expert
split over a rank count that does not divide the experts; the pool's
per-rank shapes are the plan's; and a rank that raises aborts the
others instead of hanging them.  Sharded forwards are held to the
unsharded one within ``ATOL_MESH`` (f32 sums reordered by the split).
"""
import re
import threading

import jax
import numpy as np
import pytest
import torch

from conftest import FAMILY_CFGS
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.sharding import _path_str, param_specs
from repro.serving import ServeEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import build_model
from repro_torch.models import sharding as S
from repro_torch.serving import ServeEngine
from repro_torch.tree import tree_leaves
from test_torch_dense import _port_cfg

# f32 logits, sharded against unsharded: up to 9.1e-6 seen (the smoke
# jamba over three ranks), 2.5e-6 in test_torch_mesh_serving.py
ATOL_MESH = 1e-5


def _mesh(n):
    return make_serving_mesh(model=n, devices=["cpu"] * n)


def _smoke(arch):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, device="cpu")
    return model, model.init(seed=0)


def _tokens(cfg, B=2, S=12, seed=0):
    S = max(S, cfg.vision_seq + 4)
    return torch.tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int32)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shard_unshard_round_trip(arch):
    """Bit for bit, at N = 2, 3 (uneven splits) and 4."""
    model, params = _smoke(arch)
    for n in (2, 3, 4):
        if S.has_gqa(model) and n > model.cfg.n_kv_heads \
                and n % model.cfg.n_kv_heads:
            continue                     # no head split exists there
        sm = S.ShardedModel(model, _mesh(n))
        back = sm.unshard(sm.shard(params))
        a, b = tree_leaves(params), tree_leaves(back)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y), (arch, n)


def _reference_model_leaves(arch, parts):
    """Paths of the leaves the reference's ``param_specs`` puts on
    "model" over a (1, parts) mesh."""
    jm = jax_build_model(jax_get_config(arch, smoke=True))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    specs = param_specs(shapes, dp=("data",),
                        axis_sizes={"data": 1, "model": parts})
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    return [_path_str(p) for p, s in flat if "model" in tuple(s)]


def _plan_by_path(plan, path=""):
    if isinstance(plan, dict):
        out = {}
        for k, v in plan.items():
            out.update(_plan_by_path(v, f"{path}/{k}" if path else k))
        return out
    if isinstance(plan, (list, tuple)):
        out = {}
        for i, v in enumerate(plan):
            out.update(_plan_by_path(v, f"{path}/{i}" if path else str(i)))
        return out
    return {path: plan}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reference_model_leaves_split_or_listed(arch):
    """Every leaf on "model" in the reference is split by the port (each
    rank holds less than the whole), or its ``"block:path"`` key matches
    a row of ``DIFFERENCES``, which the module docstring lists with the
    same pattern and reason."""
    doc = " ".join(S.__doc__.split())
    for pat, why in S.DIFFERENCES:
        assert pat in doc and why in doc, pat
    model, params = _smoke(arch)
    plan = _plan_by_path(S.param_plan(model, params, 2))
    shapes = {p: a.shape for p, a in _plan_by_path(params).items()}
    for path in _reference_model_leaves(arch, 2):
        split = plan[path]
        if split is not None and all(
                len(i) < shapes[path][split.dim] for i in split.index):
            continue
        key = f"{S._block_of(model, path)}:{path}"
        assert any(re.search(p, key) for p, _ in S.DIFFERENCES), \
            f"{arch}: {key} is on 'model' in the reference, whole here"


@pytest.mark.parametrize("arch", ["smollm-360m", "jamba-v0.1-52b"])
def test_rank_holds_at_most_0_6_of_the_weights(arch):
    model, params = _smoke(arch)
    whole = sum(a.numel() * a.element_size() for a in tree_leaves(params))
    shards = S.ShardedModel(model, _mesh(2)).shard(params)
    for r, shard in enumerate(shards):
        mine = sum(a.numel() * a.element_size() for a in tree_leaves(shard))
        assert mine <= 0.6 * whole, (arch, r, mine / whole)


def test_uneven_heads_15_over_5():
    """smollm-360m's 15 q / 5 KV heads at N = 2: ranks of 9/3 and 6/2,
    each with G = 3; a small model of those heads serves the reference's
    tokens over the uneven split."""
    full = get_config("smollm-360m")
    assert (full.n_heads, full.n_kv_heads) == (15, 5)
    split = S.head_split(15, 5, 2)
    assert [(len(q), len(kv)) for q, kv in split] == [(9, 3), (6, 2)]
    cfg = FAMILY_CFGS["transformer"].replace(
        arch_id="tiny-15-5", d_model=60, n_heads=15, n_kv_heads=5)
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(_port_cfg(cfg), device="cpu")
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(59)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 7)]
    kw = dict(batch_size=2, capacity=24, max_new_tokens=6, block_size=4)
    ref = JaxEngine(jm, jp, **kw).serve(prompts)
    eng = ServeEngine(tm, tp, device="cpu", mesh=_mesh(2), **kw)
    got = eng.serve(prompts)
    assert [list(r.tokens) for r in got] == [list(r.tokens) for r in ref]
    assert [c.n_heads for c in eng.model.rank_cfgs] == [9, 6]
    assert [c.n_kv_heads for c in eng.model.rank_cfgs] == [3, 2]
    assert all(c.resolved_head_dim == 4 for c in eng.model.rank_cfgs)


def test_replicated_kv_heads_tiny_n4():
    """TINY's 4 q / 2 KV heads over 4 ranks: one q head each, KV head 0
    on ranks 0-1 and KV head 1 on ranks 2-3, whole copies of its wk/wv
    columns (and its pool)."""
    assert S.head_split(4, 2, 4) == [((0,), (0,)), ((1,), (0,)),
                                     ((2,), (1,)), ((3,), (1,))]
    cfg = _port_cfg(FAMILY_CFGS["transformer"])
    model = build_model(cfg, device="cpu")
    params = model.init(seed=0)
    sm = S.ShardedModel(model, _mesh(4))
    shards = sm.shard(params)
    hd = cfg.resolved_head_dim
    wk = params["blocks"]["s0"]["attn"]["wk"]
    for r, kv in enumerate((0, 0, 1, 1)):
        assert torch.equal(shards[r]["blocks"]["s0"]["attn"]["wk"],
                           wk[..., kv * hd:(kv + 1) * hd])
    pools = sm.init_paged_cache(6, 4, dtype=torch.float32)
    assert all(p["blocks"]["s0"]["k"].shape == (2, 6, 4, 1, hd)
               for p in pools)
    with pytest.raises(ValueError, match="neither reach nor divide"):
        S.head_split(4, 2, 3)


def test_expert_parallel_uneven_and_vocab_replicated():
    """jamba's smoke MoE (4 experts) over 3 ranks splits the experts
    2/1/1; its vocab of 512 does not divide 3, so the embedding and head
    stay whole.  The sharded forward equals the unsharded one."""
    model, params = _smoke("jamba-v0.1-52b")
    sm = S.ShardedModel(model, _mesh(3))
    shards = sm.shard(params)
    moe = [k for k, d in enumerate(model.period_descs) if d[1] == "moe"][0]
    assert [s["blocks"][f"s{moe}"]["moe"]["w_up"].shape[1]
            for s in shards] == [2, 1, 1]
    assert all(s["embed"].shape == params["embed"].shape for s in shards)
    tokens = _tokens(model.cfg)
    with torch.inference_mode():
        ref, ref_aux = model.apply(params, tokens)
        got, aux = sm.apply(shards, tokens)
    torch.testing.assert_close(got, ref, rtol=0, atol=ATOL_MESH)
    torch.testing.assert_close(aux, ref_aux, rtol=0, atol=1e-7)


@pytest.mark.parametrize("arch,smaller", [
    ("jamba-v0.1-52b", True), ("xlstm-350m", False),
    # one KV head at smoke size: both ranks keep it whole
    ("smollm-360m", False)])
def test_rank_pools_follow_the_cache_plan(arch, smaller):
    """Each rank's paged pool is the plan's slice of the whole model's
    pool, leaf by leaf: K/V by KV head, mamba by d_inner, xLSTM whole."""
    model, params = _smoke(arch)
    sm = S.ShardedModel(model, _mesh(2))
    whole = model.init_paged_cache(5, 4, dtype=torch.float32,
                                   num_state_slots=3)
    plan = S.paged_cache_plan(model, whole, 2)
    ranks = sm.init_paged_cache(5, 4, dtype=torch.float32, num_state_slots=3)
    for r, pool in enumerate(ranks):
        want = S._leaves_with(plan, whole, lambda p, a: a if p is None else
                              a.index_select(p.dim, p.index[r]))
        trio = list(zip(tree_leaves(whole), tree_leaves(want),
                        tree_leaves(pool)))
        for _, a, b in trio:
            assert a.shape == b.shape and a.dtype == b.dtype, (arch, r)
        assert any(b.numel() < w.numel() for w, _, b in trio) == smaller


def test_collectives_rank_order_and_abort():
    """``all_reduce`` sums in rank order and ``all_gather`` concatenates
    in rank order on every rank; outside ``run_ranks`` both are the
    identity; a rank that raises breaks the barrier for the rest, and the
    caller gets its exception, not a hang."""
    devs = _mesh(3).devices
    x = torch.tensor([1.0])
    assert S.all_reduce(x) is x and S.all_gather(x, 0) is x

    def body(r):
        g = S.current()
        v = torch.tensor([float(r + 1)])
        return (g.rank, g.size, S.all_reduce(v), S.all_gather(v, 0))
    outs = S.run_ranks(body, devs)
    for r, (rank, size, red, gat) in enumerate(outs):
        assert (rank, size) == (r, 3)
        assert red.tolist() == [6.0] and gat.tolist() == [1.0, 2.0, 3.0]

    def failing(r):
        if r == 1:
            raise RuntimeError("rank 1 failed")
        return S.all_reduce(torch.ones(1))
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        S.run_ranks(failing, devs, timeout_s=30.0)
    assert threading.active_count() == before


def test_stress_turns_and_rank_launch_counts():
    """More ranks than cores, a shortened switch interval: every rank's
    sums stay exact over many collectives, and launch counts made from
    every rank's thread lose no update (a ``CudaKernel`` whose entry is a
    Python stand-in, since the CPU has no library to load)."""
    import os
    import sys

    from repro_torch.kernels.build import CudaKernel

    class _Lib:
        def fake_entry(self, *args):
            return 0

    kern = CudaKernel("fake", __file__, {"fake_entry": []})
    kern._lib = _Lib()
    n = (os.cpu_count() or 4) + 2
    devs = _mesh(n).devices
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def body(r):
            v = torch.tensor([float(r)])
            for i in range(50):
                kern.launch("fake_entry")
                v = S.all_reduce(v) / n
            return v
        outs = S.run_ranks(body, devs, timeout_s=60.0)
    finally:
        sys.setswitchinterval(old)
    mean = (n - 1) / 2
    assert all(o.tolist() == [mean] for o in outs)
    assert kern.launches == 50 * n
    assert kern.rank_launches == {(r, "fake_entry"): 50 for r in range(n)}
