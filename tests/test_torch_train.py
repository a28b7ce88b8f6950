"""The port's training path against the JAX reference, on the CPU: the
cosine schedule, AdamW on shared gradients, the seeded ``TokenStream``
and three ``Trainer`` steps (the train launcher:
``test_torch_train_launch.py``).

AdamW is compared on the reference's own gradients, bridged: after one
step of Adam the update is about lr * sign(g), so parameters trained by
two frameworks from gradients that differ in their last bits can differ
by 2 lr where a gradient is near zero; fed the same gradients both sides
compute the same f32 arithmetic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import TokenStream as JaxTokenStream
from repro.models import build_model as jax_build_model
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_schedule as jax_cosine
from repro.training import Trainer as JaxTrainer
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.data import TokenStream, synthetic_batches
from repro_torch.models import build_model
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               cosine_schedule)
from repro_torch.tree import tree_leaves
from repro_torch.training import Trainer

torch.backends.cuda.matmul.allow_tf32 = False
F32 = dict(param_dtype="float32", compute_dtype="float32")


@pytest.mark.parametrize("peak_lr,warmup,total", [(1e-3, 10, 100),
                                                  (3e-4, 100, 10_000),
                                                  (1e-3, 1, 3)])
def test_cosine_schedule_matches_reference(peak_lr, warmup, total):
    """Steps 0-120: the reference's f32 arithmetic in its order, within
    one f32 ulp.  XLA's f32 cosine is the C library's ``cosf``, which is
    not correctly rounded; the port rounds the f64 cosine (1 of these
    363 steps differs, by one ulp; torch's own f32 cosine missed 3 of 121
    at the first setting, by up to two ulps of the result)."""
    kw = dict(peak_lr=peak_lr, warmup=warmup, total=total)
    for step in range(121):
        want = np.asarray(jax_cosine(jnp.int32(step), **kw))
        got = cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
        # a host int gives the same value as a device step
        assert cosine_schedule(step, **kw).item() == got.item()


def test_adamw_update_matches_reference_on_shared_gradients():
    """Two updates of the smollm smoke model from the reference's own
    gradients (bridged), one leaf with no gradient (``None`` in the port,
    zeros in the reference: its weight still decays): parameters, both
    moments and the step within 1e-6."""
    jm = jax_build_model(jax_get_config("smollm-360m", smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = jnp.asarray(rng.integers(0, 512, (2, 16)).astype(np.int32))
    jg = jax.grad(jm.loss)(jp, {"tokens": tokens, "labels": tokens})
    jg = dict(jg, final_norm=jax.tree.map(jnp.zeros_like, jg["final_norm"]))
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    tg = bridge.to_torch(jax.tree.map(np.asarray, jg), "cpu")
    tg["final_norm"] = {"scale": None}
    jstate, tstate = jax_adamw_init(jp), adamw_init(tp)
    assert isinstance(tstate, AdamWState) and tstate.step.item() == 0
    for lr in (1e-3, 5e-4):
        jp, jstate = jax_adamw_update(jp, jg, jstate, jnp.float32(lr))
        tp, tstate = adamw_update(tp, tg, tstate, torch.tensor(lr))
        assert tstate.step.item() == int(jstate.step)
        for name, j, t in (("params", jp, tp), ("m", jstate.m, tstate.m),
                           ("v", jstate.v, tstate.v)):
            for a, b in zip(jax.tree.leaves(j), tree_leaves(t)):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           atol=1e-6, rtol=0, err_msg=name)
    decayed = tp["final_norm"]["scale"]
    assert float(decayed.max()) < 1.0      # the ones, decayed


def test_adamw_state_dtype():
    p = {"w": torch.ones(3, dtype=torch.float32)}
    st = adamw_init(p, state_dtype=torch.bfloat16)
    assert st.m["w"].dtype == st.v["w"].dtype == torch.bfloat16
    new, st = adamw_update(p, {"w": torch.ones(3)}, st, 0.1)
    assert new["w"].dtype == torch.float32
    assert st.m["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("seed", [0, 1])
def test_token_stream_matches_reference_bitwise(seed):
    want, got = JaxTokenStream(512, 33, 4, seed=seed), \
        TokenStream(512, 33, 4, seed=seed)
    for _ in range(5):
        w, g = next(want), next(got)
        for k in ("tokens", "labels"):
            assert g[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))
    first = JaxTokenStream(512, 8, 2, seed=seed)
    batches = list(synthetic_batches(512, 8, 2, 3, seed=seed))
    assert len(batches) == 3
    for b in batches:
        w = next(first)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(b[k], np.asarray(w[k]))


def test_trainer_matches_reference_three_steps():
    """Three steps of the smollm smoke model from the reference's initial
    weights and the same batches: loss, lr and grad norm per step within
    1e-4 relative; the history's keys and log line as the reference's."""
    kw = dict(peak_lr=1e-3, warmup=2, total_steps=3)
    jcfg = jax_get_config("smollm-360m", smoke=True).replace(**F32)
    jt = JaxTrainer(jax_build_model(jcfg), seed=0, **kw)
    want = jt.fit(JaxTokenStream(512, 32, 2, seed=0), 3, log_fn=None)
    cfg = get_config("smollm-360m", smoke=True).replace(**F32)
    lines = []
    tt = Trainer(build_model(cfg, device="cpu"), device="cpu",
                 params=jax.tree.map(np.asarray, jt.params), **kw)
    got = tt.fit(TokenStream(512, 32, 2, seed=0), 3, log_every=1,
                 log_fn=lines.append)
    assert len(got) == 3 and len(lines) == 3
    assert lines[0].startswith("step     0 loss=")
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for k in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    assert tt.state.opt.step.item() == 3
