"""The paged engine's contracts (``tests/test_kv_paged.py``) replayed on
the port, against the JAX engine, on the CPU, for transformer, mamba
and hybrid: prefill chunking is a scheduling choice, not semantics; a
request joining mid-decode equals a fresh dense run of its prompt;
concurrent slots each equal the reference's streams; eviction returns
every block, reservation and state slab.  Weights come from the
reference's ``init`` through the bridge; prompts from a seeded numpy
generator.
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
from repro_torch.serving.steps import greedy_sample
from test_torch_dense import _port_cfg

FAMILIES = ("transformer", "mamba", "hybrid")
VOCAB = FAMILY_CFGS["transformer"].vocab_size
_PAIRS = {}


def _pair(family):
    if family not in _PAIRS:
        cfg = FAMILY_CFGS[family]
        jm = jax_build_model(cfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(_port_cfg(cfg), device="cpu")
        _PAIRS[family] = (jm, jp, tm,
                          bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu"))
    return _PAIRS[family]


def _engines(family, **kw):
    jm, jp, tm, tp = _pair(family)
    kw = dict(batch_size=2, capacity=32, block_size=4, **kw)
    return (JaxEngine(jm, jp, **kw),
            ServeEngine(tm, tp, device="cpu", **kw))


def _fresh_dense_tokens(tm, tp, prompt, max_new, capacity=64):
    """Oracle: the prompt served alone, the port's dense prefill + dense
    decode."""
    with torch.inference_mode():
        logits, cache = tm.prefill(tp, torch.as_tensor(prompt)[None],
                                   capacity=capacity,
                                   cache_dtype=torch.float32)
        toks = [int(greedy_sample(logits)[0])]
        pos = len(prompt)
        while len(toks) < max_new:
            tok = torch.tensor([[toks[-1]]], dtype=torch.int32)
            logits, cache = tm.decode_step(tp, cache, tok, pos)
            toks.append(int(greedy_sample(logits)[0]))
            pos += 1
    return toks


@pytest.mark.parametrize("family", FAMILIES)
def test_chunked_prefill_invariant_to_chunk_size(family):
    """The same prompt prefilled in 1/3/16-token chunks gives the same
    tokens, equal to the reference's."""
    prompt = np.arange(1, 11, dtype=np.int32)
    runs = []
    for chunk in (1, 3, 16):
        je, te = _engines(family, max_new_tokens=5, prefill_chunk=chunk)
        assert te.paged
        runs.append(list(te.serve([prompt])[0].tokens))
        if chunk == 3:          # 4 = ceil(10 / 3) mixed steps
            assert runs[-1] == list(je.serve([prompt])[0].tokens)
            assert te.n_prefill_chunks == je.n_prefill_chunks == 4
    assert runs[0] == runs[1] == runs[2], family


@pytest.mark.parametrize("family", FAMILIES)
def test_mid_decode_join_matches_fresh_dense_run(family):
    """A request joining after four decode steps decodes at its true
    positions: its tokens equal a fresh dense run of its prompt alone,
    and both engines join it the same way."""
    _, _, tm, tp = _pair(family)
    rng = np.random.default_rng(3)
    first = rng.integers(1, VOCAB, 6).astype(np.int32)
    late = rng.integers(1, VOCAB, 9).astype(np.int32)
    out = []
    for eng in _engines(family, max_new_tokens=8, prefill_chunk=4):
        eng.submit(first)
        for _ in range(4):
            eng.step()
        eng.submit(late)
        results = []
        while eng.has_work:
            results += eng.step()
        assert eng.n_joins == 1
        out.append({r.request_id: list(r.tokens) for r in results})
    assert out[1] == out[0]
    assert out[1][0] == _fresh_dense_tokens(tm, tp, first, 8), family
    assert out[1][1] == _fresh_dense_tokens(tm, tp, late, 8), family


@pytest.mark.parametrize("family", FAMILIES)
def test_concurrent_slots_each_match_the_reference(family):
    """Five prompts over two slots, chunked: each stream equals the
    reference engine's and a fresh dense run's."""
    _, _, tm, tp = _pair(family)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, VOCAB, n).astype(np.int32)
               for n in (5, 9, 3, 7, 12)]
    je, te = _engines(family, max_new_tokens=6, prefill_chunk=4)
    jr, tr = je.serve(prompts), te.serve(prompts)
    assert [r.request_id for r in tr] == [0, 1, 2, 3, 4]
    for p, a, b in zip(prompts, jr, tr):
        assert list(b.tokens) == list(a.tokens)
        assert list(b.tokens) == _fresh_dense_tokens(tm, tp, p, 6), family
    assert te.n_prefill_chunks == je.n_prefill_chunks
    assert te.n_prefill_chunks > te.n_prefills == 5


@pytest.mark.parametrize("family", FAMILIES)
def test_eviction_frees_all_blocks(family):
    """Eviction returns every resource to its pool: KV blocks,
    reservations and, for recurrent families, state slabs — with the
    reference's counts."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, VOCAB, n).astype(np.int32)
               for n in (11, 4, 6)]
    je, te = _engines(family, max_new_tokens=4, prefill_chunk=4)
    je.serve(prompts)
    te.serve(prompts)
    assert te.n_evictions == je.n_evictions == 3
    assert te.allocator.n_free == te.allocator.num_blocks
    assert te.allocator.n_live == 0 and te._reserved == 0
    assert te.pool_stats()["n_free"] == je.pool_stats()["n_free"]
    if family == "transformer":
        assert te.state_store is None
    else:
        assert te.state_store.n_live == 0
        assert te.state_store.n_free == te.num_state_slots
        assert (te.pool_stats()["n_state_free"]
                == je.pool_stats()["n_state_free"])


def test_allocator_registry_views_and_clear_match_the_reference():
    """``registered_blocks``/``retained_blocks`` and ``clear_registry``
    (the paged restart's registry reset) against the reference's
    allocator under one sequence of operations."""
    from repro.serving.kv_cache import BlockAllocator as JaxAllocator
    from repro_torch.serving.kv_cache import BlockAllocator, ROOT_DIGEST
    views = []
    for cls in (JaxAllocator, BlockAllocator):
        a = cls(8, 4)
        blocks = a.acquire(4)
        for i, b in enumerate(blocks):
            a.register(b, ROOT_DIGEST, (i, i + 1, i + 2, i + 3))
        a.release(blocks[:2])                # registered at refcount 0
        seen = (a.registered_blocks(), a.retained_blocks(), a.n_free)
        a.clear_registry()
        views.append((seen, a.registered_blocks(), a.retained_blocks(),
                      a.n_free, a.n_live, a.n_table))
    assert views[1] == views[0]
    (registered, retained, _), *after = views[1]
    assert registered == set(range(4)) and retained == {0, 1}
    assert after == [set(), set(), 6, 2, 0]
