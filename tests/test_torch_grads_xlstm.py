"""The port's training loss and gradients against the JAX reference's
``jax.value_and_grad(model.loss)`` on xlstm-350m's smoke config (mLSTM
and sLSTM blocks from zero state), on the CPU, with
``test_torch_grads.py``'s tolerances.
"""
import pytest

from test_torch_grads import check_arch


@pytest.mark.parametrize("arch", ["xlstm-350m"])
def test_loss_and_grads_match_reference(arch):
    check_arch(arch, len(arch))
