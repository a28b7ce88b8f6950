"""The port's training loss and its gradients against the JAX reference's
``jax.value_and_grad(model.loss)``, on the CPU.

Weights come from the reference's ``init`` through the bridge, tokens,
labels, frames and patches from seeded numpy generators, the smoke
configs in f32.  One step's loss must lie within 1e-5 relative of the
reference's and every gradient leaf within ``1e-4 * max(1, max|g|)`` of
its counterpart (leaves in JAX's flatten order; a leaf the port's loss
never reaches, ``None``, against the reference's zeros): the port's
version of ``test_models_smoke.py::test_train_step_updates_params``.
Here the attention-only decoder configs; DBRX's and jamba's, with the
MoE router's gradient, in ``test_torch_grads_moe.py``, DeepSeek-V3's in
``test_torch_grads_mla.py``, whisper-tiny's in
``test_torch_grads_encdec.py``, xLSTM's in ``test_torch_grads_xlstm.py``
(files of under a minute each, so that ``--dist loadfile`` spreads
them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.tree import tree_leaves
from repro_torch.training.trainer import trainable

torch.backends.cuda.matmul.allow_tf32 = False
B, S = 2, 24        # S > the VLM smoke config's vision_seq (16)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4     # x max(1, max|g|) per leaf: f32 sums in another order


F32 = dict(param_dtype="float32", compute_dtype="float32")


def _batch(cfg, seed):
    """numpy tokens, labels and (encoder-decoder, VLM) extra embeddings."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    n = cfg.enc_seq if cfg.family == "audio" else cfg.vision_seq
    if n:
        batch["extra_embeds"] = (rng.standard_normal((B, n, cfg.d_model))
                                 * 0.02).astype(np.float32)
    return batch


def _reference(arch, batch):
    """(jax params as numpy, loss, grads as numpy leaves)."""
    jm = jax_build_model(jax_get_config(arch, smoke=True).replace(**F32))
    jp = jm.init(jax.random.PRNGKey(0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(jm.loss)(jp, jb)
    return (jax.tree.map(np.asarray, jp), float(loss),
            [np.asarray(g) for g in jax.tree.leaves(grads)])


def _port_grads(model, params, batch):
    """(loss, grads at the params' leaf positions, None where unreached)."""
    params = trainable(params)
    leaves = tree_leaves(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = model.loss(params, tb)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, list(got)


def _assert_grads_close(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g = np.zeros_like(w) if g is None else g.numpy()
        assert g.shape == w.shape, (what, i)
        np.testing.assert_allclose(
            g, w, atol=GRAD_TOL * max(1.0, float(np.abs(w).max())), rtol=0,
            err_msg=f"{what}: gradient leaf {i}")


# the configs tested in test_torch_grads_moe.py, _mla.py, _encdec.py, _xlstm.py
OWN_FILES = ("dbrx-132b", "deepseek-v3-671b", "jamba-v0.1-52b",
             "whisper-tiny", "xlstm-350m")


def check_arch(arch, seed):
    """One step's loss and every gradient leaf against the reference's;
    the leaf order of the port's trees is JAX's flatten order
    (``tree_leaves``).  Returns the port's gradients."""
    cfg = get_config(arch, smoke=True).replace(**F32)
    batch = _batch(cfg, seed)
    jp, jloss, jgrads = _reference(arch, batch)
    model = build_model(cfg, device="cpu")
    params = bridge.to_torch(jp, "cpu")
    loss, grads = _port_grads(model, params, batch)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_RTOL)
    _assert_grads_close(grads, jgrads, arch)
    return jp, grads


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a not in OWN_FILES])
def test_loss_and_grads_match_reference(arch):
    check_arch(arch, len(arch))
