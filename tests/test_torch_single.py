"""The port's ``"<arch>:smoke"`` model loaders, ``SingleShot`` and the
torch backend of ``TensorFilter``, on the CPU.

The port's weights come from torch generators, not ``jax.random``, so a
loader is held against the port's own ``apply`` on the same
``init(seed=0)`` (which ``test_torch_forward.py`` holds against the
reference), drawn on the CPU whatever the loader's device: equal bit for
bit, since both run the same ops on the same inputs.  A bf16 output leaves the torch backend as f32 numpy, exactly
(numpy has no bf16).
"""
import numpy as np
import pytest
import torch

from repro_torch import registry
from repro_torch.configs import get_config
from repro_torch.core.elements.filter import TensorFilter
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import build_model
from repro_torch.single import SingleShot

torch.backends.cuda.matmul.allow_tf32 = False


def _tokens(cfg, seed, B=2, S=20):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v3-671b",
                                  "qwen2-vl-72b"])
def test_smoke_loader_equals_port_apply(arch):
    """``get_model("<arch>:smoke", "cpu")`` against ``apply`` of the smoke
    config on ``init(seed=0)``, through the registry and through
    ``TensorFilter``/``SingleShot`` with the torch backend (numpy in and
    out); qwen2-vl with patch embeddings."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, device="cpu")
    params = model.init(seed=0)
    tokens = _tokens(cfg, 3)
    extra = []
    if cfg.vision_seq:
        extra = [(np.random.default_rng(4).standard_normal(
            (2, cfg.vision_seq, cfg.d_model)) * 0.02).astype(np.float32)]
    want, want_aux = model.apply(params, torch.from_numpy(tokens),
                                 *map(torch.from_numpy, extra))
    fn = registry.get_model(f"{arch}:smoke", "cpu")
    assert registry.get_model(f"{arch}:smoke", "cpu") is fn
    got, aux = fn(torch.from_numpy(tokens), *map(torch.from_numpy, extra))
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
    single = SingleShot(model=f"{arch}:smoke", framework="torch",
                        device="cpu")
    logits, aux_np = single.invoke(tokens, *extra)
    assert isinstance(logits, np.ndarray) and logits.dtype == np.float32
    np.testing.assert_array_equal(logits, want.numpy())
    assert float(aux_np) == want_aux.item()
    assert single.n_invocations == 1 and single.mean_latency_s > 0
    filt = TensorFilter("f", model=f"{arch}:smoke", framework="torch",
                        device="cpu")
    np.testing.assert_array_equal(filt.invoke((tokens, *extra))[0],
                                  want.numpy())


def test_registry_devices_and_unknown_names():
    """A loaded model is cached per (name, device); without a GPU a smoke
    loader needs its device named; unknown names raise."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            registry.get_model("glm4-9b:smoke")
    with pytest.raises(ValueError, match="unknown model"):
        registry.get_model("no-such-arch:smoke", "cpu")
    with pytest.raises(ValueError, match="unknown model"):
        registry.get_model("no-such-model")
    assert registry.get_model("identity")(3) == 3


def test_singleshot_fn_backends_and_refusals():
    single = SingleShot(fn=lambda a, b: (a + b, a * b))
    s, p = single.invoke(np.ones(3), np.full(3, 2.0))
    np.testing.assert_array_equal(s, np.full(3, 3.0))
    np.testing.assert_array_equal(p, np.full(3, 2.0))
    assert single.n_invocations == 1
    tsingle = SingleShot(fn=lambda x: x.sum(dim=0), framework="torch",
                         device="cpu")
    out = tsingle.invoke(np.arange(6, dtype=np.float32).reshape(2, 3))
    np.testing.assert_array_equal(out, np.array([3, 5, 7], np.float32))
    assert SingleShot(model="identity").invoke(np.ones(2)).shape == (2,)
    with pytest.raises(ValueError, match="framework 'jax'"):
        SingleShot(fn=lambda x: x, framework="jax")
    # mesh= and the shardings run on the torch-sharded backend, which
    # gives jit's result over two CPU ranks (the rows split evenly, as
    # jit requires): the unsharded one
    mesh = make_serving_mesh(model=2, devices=["cpu", "cpu"])
    x = np.arange(30, dtype=np.float32).reshape(6, 5)
    sharded = SingleShot(fn=lambda t: t.sum(dim=1), framework="torch-sharded",
                         mesh=mesh, in_shardings=("model", None),
                         out_shardings=("model",))
    np.testing.assert_array_equal(sharded.invoke(x), x.sum(axis=1))
    for kw in ({"mesh": mesh}, {"in_shardings": ("model",)},
               {"out_shardings": ("model",)}):
        with pytest.raises(ValueError, match="torch-sharded"):
            SingleShot(fn=lambda x: x, **kw)


def test_bf16_output_leaves_torch_backend_as_exact_f32():
    """A bf16 tensor comes back as f32 numpy holding the same values."""
    x = (torch.randn(5, 7, generator=torch.Generator().manual_seed(0))
         * 100).to(torch.bfloat16)
    single = SingleShot(fn=lambda t: (t.to(torch.bfloat16), t.to(
        torch.bfloat16)[0]), framework="torch", device="cpu")
    full, row = single.invoke(x.float().numpy())
    assert full.dtype == row.dtype == np.float32
    np.testing.assert_array_equal(full, x.float().numpy())
    assert torch.equal(torch.from_numpy(full).to(torch.bfloat16), x)
    np.testing.assert_array_equal(row, x[0].float().numpy())
