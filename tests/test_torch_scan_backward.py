"""The unmasked selective scan's gradient (B5's backward, B5') on the
CPU: ``selective_scan_backward_plain`` against ``torch.autograd`` of
``selective_scan_plain`` and against ``jax.vjp`` of the reference's
chunked, rematerialized ``repro.models.mamba.selective_scan``, all seven
gradients with cotangents on both y and h_last; then the differentiable
entry ``selective_scan(..., t_valid=None)`` (``_SelectiveScan``) as the
jamba stack calls it.  Inputs from numpy seeds in f32; every gradient
within 1e-5 of its largest magnitude (f32 sums in another order).  The
kernel itself is held to the plain version on the card
(``tests/test_torch_kernels.py -k scan_backward``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as JM
from repro_torch.kernels.ssm_scan import ops as sops

RTOL = 1e-5         # x the gradient's largest magnitude
NAMES = ("d_dt", "d_xs", "d_Bc", "d_Cc", "dA", "dD", "dh0")
# (B, S, di, N, h0 non-zero): S a multiple of the 8-step chunk and not,
# B = 1, N < 16 (the kernel's 1- and 2-lane channels), a carried state
CASES = [(2, 32, 24, 16, False), (2, 37, 24, 16, True), (1, 21, 16, 8, True),
         (3, 19, 12, 3, True), (2, 5, 8, 1, False)]


def _case(seed, B, S, di, N, carried):
    """Scan inputs as a Mamba layer makes them (dt > 0 from a softplus,
    A < 0) and cotangents for y and h_last, as numpy f32."""
    rng = np.random.default_rng(seed)
    f = np.float32
    ins = dict(
        dt=np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(f),
        xs=rng.standard_normal((B, S, di)).astype(f),
        Bc=rng.standard_normal((B, S, N)).astype(f),
        Cc=rng.standard_normal((B, S, N)).astype(f),
        A=-np.exp(rng.standard_normal((di, N)) * 0.5).astype(f),
        D=rng.standard_normal((di,)).astype(f),
        h0=(rng.standard_normal((B, di, N)) if carried
            else np.zeros((B, di, N))).astype(f))
    cot = (rng.standard_normal((B, S, di)).astype(f),
           rng.standard_normal((B, di, N)).astype(f))
    return ins, cot


def _torch(ins):
    return [torch.from_numpy(ins[k]) for k in
            ("dt", "xs", "Bc", "Cc", "A", "D", "h0")]


def _close(got, want, what):
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= RTOL * scale, (what, name, err / scale)


@pytest.mark.parametrize("B,S,di,N,carried", CASES)
def test_backward_plain_matches_torch_autograd(B, S, di, N, carried):
    ins, (dy, dh) = _case(S + N, B, S, di, N, carried)
    leaves = [t.clone().requires_grad_() for t in _torch(ins)]
    y, h_last = sops.selective_scan_plain(*leaves, None)
    want = torch.autograd.grad((y, h_last), leaves,
                               (torch.from_numpy(dy), torch.from_numpy(dh)))
    got = sops.selective_scan_backward_plain(
        *_torch(ins), torch.from_numpy(dy), torch.from_numpy(dh))
    _close([g.numpy() for g in got], [w.numpy() for w in want], "autograd")


@pytest.mark.parametrize("B,S,di,N,carried", CASES)
def test_backward_plain_matches_jax_vjp_of_the_chunked_remat_scan(
        B, S, di, N, carried):
    """The reference's training scan: chunks of 4 steps under
    ``jax.checkpoint`` (S = 37, 21, 19, 5 leave a ragged last chunk)."""
    ins, (dy, dh) = _case(S + N, B, S, di, N, carried)

    def scan(dt, xs, Bc, Cc, A, D, h0):
        return JM.selective_scan(dt, Bc, Cc, xs, A, D, h0, chunk_size=4,
                                 remat=True)
    args = [jnp.asarray(ins[k]) for k in
            ("dt", "xs", "Bc", "Cc", "A", "D", "h0")]
    _, vjp = jax.vjp(scan, *args)
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    got = sops.selective_scan_backward_plain(
        *_torch(ins), torch.from_numpy(dy), torch.from_numpy(dh))
    _close([g.numpy() for g in got], want, "jax.vjp")


def test_backward_plain_without_dh_last_is_a_zero_cotangent():
    ins, (dy, dh) = _case(3, 2, 19, 8, 4, True)
    dy = torch.from_numpy(dy)
    got = sops.selective_scan_backward_plain(*_torch(ins), dy, None)
    want = sops.selective_scan_backward_plain(
        *_torch(ins), dy, torch.zeros(dh.shape))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_function_takes_split_views_and_matches_the_plain_gradient():
    """The entry the jamba stack calls: Bc/Cc as split views (row stride
    dt_rank + 2N), the gradients those of the plain backward, d_Bc/d_Cc
    contiguous (B, S, N) and each gradient in its input's type; the
    views' projection gets them through the split."""
    ins, (dy, dh) = _case(7, 2, 23, 16, 8, True)
    dt, xs, Bc, Cc, A, D, h0 = _torch(ins)
    proj = torch.cat([torch.zeros((2, 23, 5)), Bc, Cc], -1).requires_grad_()
    bv, cv = torch.split(proj, [5, 8, 8], dim=-1)[1:]
    assert sops.bc_row_stride(bv) == 21
    leaves = [t.clone().requires_grad_() for t in (dt, xs, A, D, h0)]
    y, h_last = sops.selective_scan(leaves[0], leaves[1], bv, cv,
                                    *leaves[2:])
    want_y, want_h = sops.selective_scan_plain(dt, xs, Bc, Cc, A, D, h0, None)
    assert torch.equal(y, want_y) and torch.equal(h_last, want_h)
    got = torch.autograd.grad((y, h_last), leaves[:2] + [proj] + leaves[2:],
                              (torch.from_numpy(dy), torch.from_numpy(dh)))
    want = sops.selective_scan_backward_plain(
        dt, xs, Bc, Cc, A, D, h0, torch.from_numpy(dy), torch.from_numpy(dh))
    for g, w in zip(got[:2] + got[3:], want[:2] + want[4:]):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    assert torch.equal(got[2][..., :5], torch.zeros((2, 23, 5)))
    assert torch.equal(got[2][..., 5:13], want[2])
    assert torch.equal(got[2][..., 13:], want[3])


def test_function_gives_bf16_inputs_bf16_gradients():
    ins, (dy, _) = _case(9, 2, 17, 16, 16, False)
    leaves = [t.to(torch.bfloat16).requires_grad_() for t in _torch(ins)[:4]]
    A, D, h0 = (t.requires_grad_() for t in _torch(ins)[4:])
    y, h_last = sops.selective_scan(*leaves, A, D, h0)
    assert y.dtype == h_last.dtype == torch.float32
    # only y gets a cotangent: h_last's gradient comes back as None
    got = torch.autograd.grad(y, leaves + [A, D, h0], torch.from_numpy(dy))
    assert [g.dtype for g in got] == [torch.bfloat16] * 4 + [torch.float32] * 3
    assert [g.shape for g in got] == [t.shape for t in leaves + [A, D, h0]]
    with torch.no_grad():
        want = sops.selective_scan_backward_plain(
            *leaves, A, D, h0, torch.from_numpy(dy), None)
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(g.dtype))


def test_masked_scan_under_autograd_raises():
    """Only the unmasked scan is differentiable: a t_valid tensor under
    autograd raises (deciding that it is full would read the device);
    without grad the masked scan runs as before."""
    ins, _ = _case(11, 2, 6, 8, 4, True)
    dt, xs, Bc, Cc, A, D, h0 = _torch(ins)
    t_valid = torch.tensor([6, 3], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="unmasked"):
        sops.selective_scan(dt.requires_grad_(), xs, Bc, Cc, A, D, h0,
                            t_valid)
    with torch.no_grad():
        y, h = sops.selective_scan(dt, xs, Bc, Cc, A, D, h0, t_valid)
    wy, wh = sops.selective_scan_plain(dt.detach(), xs, Bc, Cc, A, D, h0,
                                       t_valid)
    assert torch.equal(y, wy) and torch.equal(h, wh)


@pytest.mark.parametrize("N,di,n_grp", [
    (4, 96, 1), (4, 8192, 8), (8, 96, 1), (8, 8192, 16), (16, 96, 1),
    (16, 8192, 32)])
def test_backward_workspace_is_one_partial_a_cluster(N, di, n_grp):
    """B5''s d_Bc/d_Cc partials: 128, 64 or 32 channels a block as N <=
    4, 8, 16, ``BACKWARD_CLUSTER`` blocks a cluster, one partial a
    cluster (the grid padded to whole clusters); at jamba's training
    shape 16.8 MB, 8x below a partial a block."""
    assert sops.BACKWARD_CLUSTER == 8
    assert sops.backward_workspace_shape(8, 512, di, N) == (2, 8, 512,
                                                            n_grp, N)
    if (N, di) == (16, 8192):
        blocks = 2 * 8 * 512 * (di // 32) * N * 4
        assert 4 * 2 * 8 * 512 * n_grp * N == blocks // 8 == 16_777_216


def _fake_library(chunk=8, cluster=8, steps=8):
    """A stand-in for the two built libraries' layout entries, reporting
    the given chunk, cluster and checkpoint spacing and computing the
    clusters along di as the kernel does."""
    import types

    def layout(di, N, out):
        ch = 128 // (1 if N <= 4 else 2 if N <= 8 else 4)
        out[0], out[1], out[2], out[3] = chunk, cluster, ch, 4
        out[4] = -(-(-(-di // ch)) // cluster)
        return 0
    return types.SimpleNamespace(selective_scan_backward_layout=layout,
                                 selective_scan_ckpt_steps=lambda: steps)


@pytest.mark.parametrize("kw", [{}, {"chunk": 16}, {"cluster": 4},
                                 {"steps": 16}])
def test_loading_checks_the_libraries_layout(kw):
    """ops.py holds each library's copy of the checkpoint spacing and of
    B5''s chunk and cluster to its own when the library loads: a kernel
    built with other values raises there, before any launch could index
    a workspace of another size."""
    lib = _fake_library(**kw)
    if not kw:
        sops._check_ckpt_steps(lib)
        sops._check_backward_layout(lib)
        return
    check = sops._check_ckpt_steps if "steps" in kw \
        else sops._check_backward_layout
    with pytest.raises(RuntimeError, match="expects"):
        check(lib)
