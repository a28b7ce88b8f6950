"""The port's training loss and gradients against the JAX reference's
``jax.value_and_grad(model.loss)`` on the smoke configs of DBRX (the
softmax router) and jamba (mamba + attention + MoE), on the CPU, with
``test_torch_grads.py``'s tolerances; and the MoE router's gradient when
the top-k's values carry none, as the gating kernel's do on the card.
DeepSeek-V3's is in ``test_torch_grads_mla.py``.
"""
import jax
import pytest

from repro_torch.models import moe as TM
from test_torch_grads import check_arch


@pytest.mark.parametrize("arch", ["dbrx-132b", "jamba-v0.1-52b"])
def test_loss_and_grads_match_reference(arch):
    check_arch(arch, len(arch))


def test_router_gets_its_gradient_when_the_top_k_values_carry_none(
        monkeypatch):
    """On the card the gating kernel's top-k values have no gradient;
    ``route`` takes its weights from the router's probabilities at the
    kernel's indices, so the router still gets the reference's gradient
    (dbrx: the softmax router)."""
    plain = TM.gating_ops.gating_topk

    def detached(scores, k):
        vals, idx = plain(scores, k)
        return vals.detach(), idx

    monkeypatch.setattr(TM.gating_ops, "gating_topk", detached)
    jp, grads = check_arch("dbrx-132b", 3)
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    routers = [i for i, (path, _) in enumerate(leaves)
               if "router" in jax.tree_util.keystr(path)]
    assert routers
    for i in routers:
        assert grads[i] is not None and float(grads[i].abs().max()) > 0
