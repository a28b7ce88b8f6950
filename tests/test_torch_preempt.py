"""Preemption spill and restore in the port's paged engine, against the
JAX reference, on the CPU.

A slot preempted mid-decode has its used KV pages (under int8 also the
scale pools) and its mamba state slab gathered to host memory, and is
re-admitted later into whatever blocks are free; a slot preempted
mid-prefill is restarted.  For transformer, mamba, hybrid and an int8
pool the port must give the tokens, counters and pool accounting of the
JAX engine under the same schedule; its preempted run must equal its
own never-preempted run, logits bit for bit (as the reference's does),
and its per-step logits must stay within f32 tolerance of the
reference's.  Weights come from the reference's ``init`` through the
bridge; prompts from a seeded numpy generator.
"""
import jax
import numpy as np
import pytest
import torch

from conftest import FAMILY_CFGS
from repro.models import build_model as jax_build_model
from repro.serving import ServeEngine as JaxEngine
from repro_torch import bridge
from repro_torch.models import build_model
from repro_torch.serving import ServeEngine
from test_torch_dense import _port_cfg

ATOL_F32 = 1e-4      # per-step logits, port against reference (f32 CPU)
# over an int8 pool a K/V row that differs by an f32 ulp between the
# packages can round one int8 code the other way (a step of 1/127 of the
# row's absmax): logit differences up to 9.7e-4 seen on these inputs
ATOL_INT8 = 5e-3
CASES = {"transformer": ("transformer", None), "mamba": ("mamba", None),
         "hybrid": ("hybrid", None), "int8": ("transformer", "int8")}
COUNTERS = ("n_preemptions", "n_restores", "n_joins", "n_prefills",
            "n_evictions", "n_prefill_chunks")
_PAIRS = {}


def _pair(family):
    """(jax model, jax params, port model, port params), built once."""
    if family not in _PAIRS:
        cfg = FAMILY_CFGS[family]
        jm = jax_build_model(cfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(_port_cfg(cfg), device="cpu")
        _PAIRS[family] = (jm, jp, tm,
                          bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu"))
    return _PAIRS[family]


def _engines(case, **kw):
    family, kv_dtype = CASES[case]
    jm, jp, tm, tp = _pair(family)
    kw = dict(batch_size=2, capacity=32, max_new_tokens=8, block_size=4,
              kv_dtype=kv_dtype, trace_logits=True, **kw)
    return (lambda: JaxEngine(jm, jp, **kw),
            lambda: ServeEngine(tm, tp, device="cpu", **kw),
            ATOL_INT8 if kv_dtype == "int8" else ATOL_F32)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    vocab = FAMILY_CFGS["transformer"].vocab_size
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lengths]


def serve_traced(eng, prompts, *, preempt_rid=None, after_tokens=2,
                 mid_prefill=False):
    """Serve ``prompts`` on the batch lane, preempting ``preempt_rid``
    once: mid-decode once it holds ``after_tokens`` tokens, or while it
    is still mid-prefill.  The schedule is a function of the step count
    alone.  Returns {rid: result}."""
    for p in prompts:
        eng.submit(p, lane="batch")
    pending = preempt_rid is not None
    results = []
    while eng.has_work:
        for s in eng._slots if pending else ():
            if s is None or s.rid != preempt_rid:
                continue
            prefilled = s.prefill_off >= len(s.prompt)
            if (mid_prefill and not prefilled) or (
                    not mid_prefill and prefilled
                    and len(s.tokens) >= after_tokens):
                assert eng.preempt(preempt_rid)
                pending = False
        results += eng.step()
    assert not pending, "never caught the slot in the target phase"
    return {r.request_id: r for r in results}


def _pool(eng):
    s = eng.pool_stats()
    return {k: s.get(k) for k in ("n_free", "n_live", "n_reserved",
                                  "n_state_live", "n_state_free")}


def _assert_same_run(je, jr, te, tr, atol=ATOL_F32):
    assert sorted(tr) == sorted(jr)
    for rid in jr:
        assert tr[rid].status == jr[rid].status == "ok"
        np.testing.assert_array_equal(tr[rid].tokens, jr[rid].tokens)
    for name in COUNTERS:
        assert getattr(te, name) == getattr(je, name), name
    assert _pool(te) == _pool(je)
    for rid, trace in je.logit_trace.items():
        other = te.logit_trace[rid]
        assert len(other) == len(trace)
        np.testing.assert_allclose(np.stack(other), np.stack(trace),
                                   atol=atol, rtol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_preempt_mid_decode_restores_bit_identical(case):
    """Rid 0 is preempted after two tokens and restored: the port's
    tokens and logits equal its never-preempted run's bit for bit, and
    its tokens, counters, pool accounting and logits (within f32
    tolerance) the reference's preempted run's.  The pool is clean."""
    make_jax, make_port, atol = _engines(case)
    prompts = _prompts(13, (8, 6))
    je = make_jax()
    jr = serve_traced(je, prompts, preempt_rid=0)
    ref, pre = make_port(), make_port()
    rr = serve_traced(ref, prompts)
    tr = serve_traced(pre, prompts, preempt_rid=0)
    assert pre.n_preemptions == pre.n_restores == 1
    assert ref.n_preemptions == 0
    for rid in rr:
        np.testing.assert_array_equal(tr[rid].tokens, rr[rid].tokens)
        trace, other = ref.logit_trace[rid], pre.logit_trace[rid]
        assert len(trace) == len(other) == 8
        for x, y in zip(trace, other):
            assert np.array_equal(x, y), f"{case}: rid {rid} logits differ"
    _assert_same_run(je, jr, pre, tr, atol)
    assert pre.allocator.n_free == pre.allocator.num_blocks
    assert pre._reserved == 0
    if pre.state_store is not None:
        assert pre.state_store.n_live == 0


@pytest.mark.parametrize("case", list(CASES))
def test_preempt_mid_prefill_restarts_deterministically(case):
    """A slot spilled before its first token is restarted (no payload,
    no restore) and re-prefilled: the same tokens as the reference under
    the same schedule, and as an uninterrupted run."""
    make_jax, make_port, atol = _engines(case, prefill_chunk=4)
    prompts = _prompts(19, (12,))
    je, te = make_jax(), make_port()
    jr = serve_traced(je, prompts, preempt_rid=0, mid_prefill=True)
    tr = serve_traced(te, prompts, preempt_rid=0, mid_prefill=True)
    assert te.n_preemptions == 1 and te.n_restores == 0
    _assert_same_run(je, jr, te, tr, atol)
    plain = serve_traced(make_port(), prompts)
    np.testing.assert_array_equal(tr[0].tokens, plain[0].tokens)


@pytest.mark.parametrize("case", list(CASES))
def test_interactive_admission_preempts_the_youngest_batch_slot(case):
    """Both slots run batch work; an interactive request arrives and
    preempts the youngest batch slot (strict priority), which is
    restored once a slot frees.  Tokens, counters and pool accounting
    equal the reference's."""
    make_jax, make_port, atol = _engines(case)
    batch, inter = _prompts(23, (9, 7)), _prompts(29, (5,))
    out = []
    for eng in (make_jax(), make_port()):
        rids = [eng.submit(p, lane="batch") for p in batch]
        while not all(s is not None and s.tokens for s in eng._slots):
            eng.step()
        rids.append(eng.submit(inter[0], lane="interactive"))
        res = {r.request_id: r for r in eng.wait(rids, timeout_s=120)}
        out.append((eng, res))
    (je, jr), (te, tr) = out
    assert te.n_preemptions == te.n_restores == 1
    _assert_same_run(je, jr, te, tr, atol)


@pytest.mark.parametrize("case", list(CASES))
def test_gather_scatter_round_trip(case):
    """gather -> scatter to other blocks and another slab -> gather
    returns equal tensors (every attention pool, the int8 scale pools,
    the mamba conv and SSM slabs); blocks and slabs outside the write
    are untouched."""
    family, kv_dtype = CASES[case]
    _, _, tm, _ = _pair(family)
    kw = {"kv_dtype": kv_dtype} if kv_dtype else {}
    if tm.has_recurrent_state():
        kw["num_state_slots"] = 4
    cache = tm.init_paged_cache(12, 4, dtype=torch.float32, **kw)
    gen = torch.Generator().manual_seed(0)
    for a in _leaves(cache):
        if a.dtype == torch.int8:
            a.copy_(torch.randint(-127, 128, a.shape, generator=gen))
        else:
            a.copy_(torch.randn(a.shape, generator=gen))
    before = _clone(cache)
    src, dst = torch.tensor([1, 5, 2]), torch.tensor([9, 0, 7])
    first = tm.gather_paged_pages(cache, src, 1)
    names = {k for st in first["blocks"].values() for k in st}
    if kv_dtype:
        assert {"k_scale", "v_scale"} <= names
    if tm.has_recurrent_state():
        assert {"conv", "ssm"} <= names
    tm.scatter_paged_pages(cache, first, dst, 3)
    again = tm.gather_paged_pages(cache, dst, 3)
    for a, b in zip(_leaves(first), _leaves(again)):
        assert torch.equal(a, b)
    for j, d in enumerate(tm.period_descs):
        written = (9, 0, 7) if d[0] == "attn" else (3,)
        for name, a in cache["blocks"][f"s{j}"].items():
            keep = [b for b in range(a.shape[1]) if b not in written]
            assert torch.equal(a[:, keep],
                               before["blocks"][f"s{j}"][name][:, keep]), name


def _leaves(tree):
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _leaves(v)]
    if isinstance(tree, list):
        return [a for v in tree for a in _leaves(v)]
    return [tree]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()
