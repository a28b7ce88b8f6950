"""glm4-9b's layer shape in the port against the JAX reference, on the CPU.

glm4-9b groups 16 query heads on each of its 2 KV heads (G = 16), adds a
bias to q, k and v, and rotates half of each head.  A tiny config keeps
those three (32/2 heads of 16, d 64, 2 layers); weights come from the
reference's ``init`` through the bridge.  The port's greedy streams must
equal the JAX engine's, paged (chunked prefill, K2 and K1 at G = 16; over
an int8 pool, K2q and B3) and dense (B2 and B4).  On the CPU the kernel wrappers run their plain
versions; the tensor-core decode body that serves G = 16 on the card is
held against them in ``tests/test_torch_kernels.py``.
"""
import jax
import numpy as np
import pytest
import torch

from conftest import TINY_SERVE
from repro.models import build_model as jax_build_model
from repro.serving import ServeEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.models import build_model
from repro_torch.models import config as tconfig
from repro_torch.serving import ServeEngine

GLM4_TINY = TINY_SERVE.replace(
    arch_id="tiny-glm4", d_model=64, n_heads=32, n_kv_heads=2, head_dim=16,
    qkv_bias=True, rope_pct=0.5)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params)."""
    jm = jax_build_model(GLM4_TINY)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = tconfig.ModelConfig(**{f: getattr(GLM4_TINY, f)
                                 for f in GLM4_TINY.__dataclass_fields__})
    tm = build_model(cfg, device="cpu")
    return jm, jp, tm, bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, GLM4_TINY.vocab_size, n).astype(np.int32)
            for n in lengths]


@pytest.mark.parametrize("paged", [True, False])
def test_glm4_shaped_streams_match_reference(pair, paged):
    """Three requests on two slots, paged (chunks of 4 over pages of 4) and
    dense: the port's greedy streams equal the JAX engine's, in the mode
    asked for, at G = 16 with QKV bias and half rotary."""
    jm, jp, tm, tp = pair
    assert tm.cfg.n_heads // tm.cfg.n_kv_heads == 16 and tm.cfg.qkv_bias
    prompts = _prompts(21, (9, 13, 5))
    kw = dict(batch_size=2, capacity=24, max_new_tokens=4, paged=paged)
    if paged:
        kw.update(prefill_chunk=4, block_size=4)
    jr = JaxEngine(jm, jp, **kw).serve(prompts)
    te = ServeEngine(tm, tp, device="cpu", **kw)
    tr = te.serve(prompts)
    assert te.paged == paged
    assert [r.status for r in tr] == [r.status for r in jr] == ["ok"] * 3
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_glm4_shaped_int8_streams_match_reference(pair):
    """The same three requests paged over an int8 pool (int8 K/V and
    their f32 row scales; chunks of 4 over pages of 4): the port's greedy
    streams equal the JAX engine's at G = 16 with QKV bias and half
    rotary.  On the CPU B3 and K2q run their plain versions; B3's
    tensor-core entry at G = 16 is held against them on the card."""
    jm, jp, tm, tp = pair
    prompts = _prompts(21, (9, 13, 5))
    kw = dict(batch_size=2, capacity=24, max_new_tokens=4, paged=True,
              prefill_chunk=4, block_size=4, kv_dtype="int8")
    jr = JaxEngine(jm, jp, **kw).serve(prompts)
    te = ServeEngine(tm, tp, device="cpu", **kw)
    tr = te.serve(prompts)
    assert te.paged and te.pool_stats()["kv_dtype"] == "int8"
    assert [r.status for r in tr] == [r.status for r in jr] == ["ok"] * 3
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_glm4_9b_int8_decode_takes_the_tensor_core_body():
    """At glm4-9b's heads (G = 16, head_dim 128) B3 dispatches to the
    tensor-core entry over int8 tiles; its split plan at chip_smoke phase
    21(d)'s pool (4128 keys, B = 8) gives every SM at most one block of
    whole 16-key tiles."""
    cfg = get_config("glm4-9b")
    G, hd = cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim
    entry = dops.quant_decode_entry(G, hd)
    assert entry == "paged_decode_attention_quant_f32_tf32"
    sms = 132                                 # an H100 SXM's
    n_split, split_keys = dops.entry_split_plan(
        entry, 4128, 8 * cfg.n_kv_heads, torch.int8, hd, sms)
    assert 1 < n_split and 8 * cfg.n_kv_heads * n_split <= sms
    assert split_keys % dops.MMA_KEY_TILE == 0 \
        and n_split * split_keys >= 4128


def test_glm4_9b_decode_takes_the_tensor_core_body():
    """At glm4-9b's own shapes (40 layers, d 4096, 32/2 heads of 128, QKV
    bias, half rotary, vocab 151552) the decode dispatch sends K1 and B4
    to the tensor-core entries, bf16 and f32; its split plan at chip_smoke
    phase 21's pool (4128 keys, B = 8) gives every SM at most one block
    of whole tiles."""
    cfg = get_config("glm4-9b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.qkv_bias, cfg.rope_pct,
            cfg.vocab_size) == (40, 4096, 32, 2, 128, True, 0.5, 151552)
    G, hd = cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim
    for prefix in ("paged_decode_attention", "decode_attention"):
        assert dops.decode_entry(prefix, torch.bfloat16, torch.bfloat16, G,
                                 hd) == f"{prefix}_bf16_bf16_mma"
        assert dops.decode_entry(prefix, torch.float32, torch.float32, G,
                                 hd) == f"{prefix}_f32_f32_tf32"
    sms = 132                                 # an H100 SXM's
    n_split, split_keys = dops.entry_split_plan(
        "paged_decode_attention_bf16_bf16_mma", 4128, 8 * cfg.n_kv_heads,
        torch.bfloat16, hd, sms)
    assert 1 < n_split and 8 * cfg.n_kv_heads * n_split <= sms
    assert split_keys % dops.MMA_KEY_TILE == 0 \
        and n_split * split_keys >= 4128
