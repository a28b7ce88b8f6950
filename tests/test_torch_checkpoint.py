"""Checkpoints across the two packages, on the CPU: the reference's
``checkpoint/store.py`` layout (``step_%08d/part_<i>.npz`` of
``leaf_<i>`` arrays in JAX's flatten order, plus ``manifest.json``) read
and written by the port.  An f32 checkpoint round-trips bit for bit each
way; a bf16 one written by the reference (raw 2-byte ``|V2`` records)
restores in the port bit for bit, although the reference's own
``restore_checkpoint`` cannot cast those records back (ROADMAP Queue C).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.tree import tree_leaves


def _jax_params(arch, dtype):
    cfg = jax_get_config(arch, smoke=True).replace(param_dtype=dtype,
                                                   compute_dtype=dtype)
    return jax_build_model(cfg).init(jax.random.PRNGKey(0))


def _bits(t):
    t = t.detach()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_same_bits(port_tree, jax_tree):
    want = jax.tree.leaves(jax_tree)
    got = tree_leaves(port_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = bridge.leaf_to_torch(np.asarray(w), "cpu")
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v3-671b"])
def test_jax_f32_checkpoint_restores_in_the_port(tmp_path, arch):
    """Every leaf bit for bit, lists (DeepSeek's prefix layers) and
    nested dicts in JAX's order, across several parts."""
    jp = _jax_params(arch, "float32")
    jax_save(str(tmp_path), 7, jp, max_bytes_per_part=1 << 20)
    like = jax.tree.map(lambda a: torch.zeros(a.shape, dtype=torch.float32),
                        jp)
    assert latest_step(str(tmp_path)) == 7
    _assert_same_bits(restore_checkpoint(str(tmp_path), 7, like), jp)


def test_port_f32_checkpoint_restores_in_the_reference(tmp_path):
    jp = _jax_params("jamba-v0.1-52b", "float32")
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    save_checkpoint(str(tmp_path), 3, tp, max_bytes_per_part=1 << 20)
    jax_save(str(tmp_path / "ref"), 3, jp, max_bytes_per_part=1 << 20)
    manifest, want = (json.loads((d / "step_00000003" /
                                  "manifest.json").read_text())
                      for d in (tmp_path, tmp_path / "ref"))
    assert manifest == want                  # the reference's, key for key
    back = jax_restore(str(tmp_path), 3, jax.tree.map(jnp.zeros_like, jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_jax_bf16_checkpoint_restores_in_the_port(tmp_path):
    """A bf16 model (with its f32 router and mamba leaves) saved by the
    reference: the ``|V2`` records read back as bf16, bit for bit."""
    jp = _jax_params("jamba-v0.1-52b", "bfloat16")
    dtypes = {str(a.dtype) for a in jax.tree.leaves(jp)}
    assert dtypes == {"bfloat16", "float32"}
    jax_save(str(tmp_path), 1, jp)
    with np.load(tmp_path / "step_00000001" / "part_0.npz") as f:
        assert any(f[k].dtype == np.dtype("V2") for k in f.files)
    like = bridge.to_torch(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                                        jp), "cpu")
    _assert_same_bits(restore_checkpoint(str(tmp_path), 1, like), jp)


def test_port_bf16_checkpoint_round_trips(tmp_path):
    """The port writes bf16 leaves as the reference does (``|V2``) and
    reads them back bit for bit; a leaf count or shape that does not fit
    the target raises."""
    tree = {"b": [torch.randn(3, 5).to(torch.bfloat16), torch.randn(2)],
            "a": torch.arange(6, dtype=torch.int32).reshape(2, 3)}
    save_checkpoint(str(tmp_path), 12, tree)
    save_checkpoint(str(tmp_path), 4, tree)
    assert latest_step(str(tmp_path)) == 12
    assert latest_step(str(tmp_path / "none")) is None
    with np.load(tmp_path / "step_00000012" / "part_0.npz") as f:
        assert f["leaf_1"].dtype == np.dtype("V2")       # "a" sorts first
    back = restore_checkpoint(str(tmp_path), 12, tree)
    for g, w in zip(tree_leaves(back), tree_leaves(tree)):
        assert g.dtype == w.dtype and torch.equal(_bits(g), _bits(w))
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path), 12, {"a": tree["a"]})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), 12, dict(tree, a=torch.zeros(3)))
    with pytest.raises(ValueError, match="structure"):
        restore_checkpoint(str(tmp_path), 12, {"a": tree["b"][1],
                                               "c": tree["b"]})
