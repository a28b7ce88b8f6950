"""``TransformerLM(remat=True)`` (``launch.train --remat``) against no
``remat``, on the CPU in f32: the same loss and gradients.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.transformer import TransformerLM
from repro_torch.tree import tree_map
from test_torch_grads import F32, _batch, _port_grads


@pytest.mark.parametrize("arch", ["smollm-360m", "xlstm-350m",
                                  "deepseek-v3-671b"])
def test_remat_gives_the_same_gradients(arch):
    """``TransformerLM(remat=True)`` checkpoints each period: the
    recomputed forward is the same computation, so the loss and every
    gradient are equal bit for bit."""
    cfg = get_config(arch, smoke=True).replace(**F32)
    batch = {k: v[:, :12] for k, v in _batch(cfg, 9).items()}
    params = build_model(cfg, device="cpu").init(seed=0)
    out = []
    for remat in (False, True):
        model = TransformerLM(cfg, device="cpu", remat=remat)
        out.append(_port_grads(model, tree_map(torch.clone, params), batch))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(g0, g1))
