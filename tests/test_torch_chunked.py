"""``chunked_attention`` (the reference's blockwise attention) against
the JAX reference's, values and gradients, on the CPU in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.models import attention as TA
from test_torch_grads import B


def _qkv(seed, S_, T, H, KV, hd, hv):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S_, H, hd), (B, T, KV, hd), (B, T, KV, hv),
                      (B, S_, H, hv))]


@pytest.mark.parametrize("S_,T,H,KV,hv,causal,window,chunk,scale", [
    (40, 40, 4, 2, 16, True, 0, 16, None),    # GQA, S no multiple of chunk
    (64, 64, 8, 2, 16, True, 0, 16, None),    # G = 4 over 4 x 4 chunks
    (40, 40, 4, 4, 16, True, 12, 16, None),   # a sliding window
    (50, 50, 4, 1, 16, True, 7, 16, None),    # a window, one KV head
    (33, 33, 4, 2, 16, False, 0, 8, None),    # bidirectional
    (20, 45, 4, 2, 16, False, 0, 16, None),   # S < T, no mask (cross)
    (24, 24, 4, 4, 8, True, 0, 16, 0.2),      # V narrower, a given scale
    (16, 16, 2, 1, 16, True, 0, 64, None)])   # one chunk
def test_chunked_attention_matches_reference(S_, T, H, KV, hv, causal,
                                             window, chunk, scale):
    """Values and (q, k, v) gradients of a random cotangent."""
    q, k, v, dout = _qkv(S_ + T + H + window, S_, T, H, KV, 16, hv)
    kw = dict(causal=causal, chunk=chunk, sliding_window=window,
              scale=scale)

    def jf(q_, k_, v_):
        out = JA.chunked_attention(q_, k_, v_, **kw)
        return jnp.sum(out * dout), out

    (_, jout), jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = TA.chunked_attention(*leaves, **kw)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=0)
    for g, w in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)
