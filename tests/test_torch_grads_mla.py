"""The port's training loss and gradients against the JAX reference's
``jax.value_and_grad(model.loss)`` on DeepSeek-V3's smoke config (MLA,
the ``sigmoid_bias`` router, the MTP head), on the CPU, with
``test_torch_grads.py``'s tolerances: a file of its own, as the
reference's gradient alone takes about half a minute to compile.
"""
import pytest

from test_torch_grads import check_arch


@pytest.mark.parametrize("arch", ["deepseek-v3-671b"])
def test_loss_and_grads_match_reference(arch):
    check_arch(arch, len(arch))
