"""The port's selective scan (B5) and Mamba block against the JAX
reference.

On the CPU the scan wrapper runs its plain PyTorch version, which must
equal the reference's Pallas kernel (interpret mode) and its jnp scan,
and the served step ``mamba_slab_step`` the reference's
``mamba_paged_step`` and ``mamba_decode``, within 1e-5 in f32.  The kernel-vs-plain cases need
a CUDA device and skip without one; on a card, run this file with
``JAX_PLATFORMS=cpu`` and ``--noconftest`` (the JAX comparisons then
skip where JAX is missing).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssm_scan import ops as sops
from repro_torch.models import mamba as TMB
from repro_torch.models.config import ModelConfig, SSMConfig

ATOL = 1e-5
CFG = ModelConfig(arch_id="tiny-mamba", family="hybrid", n_layers=1,
                  d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                  vocab_size=64, ssm=SSMConfig(d_state=8, d_conv=4, expand=2),
                  attn_layer_period=1, attn_layer_offset=1)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's scan kernel (interpret mode), oracle and Mamba
    block, plus the tiny block's weights as numpy."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ssm_scan import ops as jops
    from repro.kernels.ssm_scan import ref as jref
    from repro.models import mamba as jm
    from repro.models.config import ModelConfig as JCfg
    from repro.models.config import SSMConfig as JSSM
    jcfg = JCfg(**{f: getattr(CFG, f) for f in
                   ("arch_id", "family", "n_layers", "d_model", "n_heads",
                    "n_kv_heads", "d_ff", "vocab_size", "attn_layer_period",
                    "attn_layer_offset")},
                ssm=JSSM(d_state=8, d_conv=4, expand=2))
    params = jax.tree.map(np.asarray,
                          jm.mamba_params(jax.random.PRNGKey(3), jcfg,
                                          jnp.float32))
    return SimpleNamespace(jnp=jnp, ops=jops, ref=jref, mamba=jm, cfg=jcfg,
                           params=params)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scan_case(seed, B, S, di, N):
    """Scan inputs as a Mamba layer makes them: dt > 0 (softplus), A < 0."""
    rng = np.random.default_rng(seed)
    return dict(
        dt=np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(np.float32),
        xs=rng.standard_normal((B, S, di)).astype(np.float32),
        Bc=rng.standard_normal((B, S, N)).astype(np.float32),
        Cc=rng.standard_normal((B, S, N)).astype(np.float32),
        A=-np.exp(rng.standard_normal((di, N)) * 0.5).astype(np.float32),
        D=rng.standard_normal((di,)).astype(np.float32),
        h0=rng.standard_normal((B, di, N)).astype(np.float32),
        t_valid=rng.integers(0, S + 1, B).astype(np.int32))


def _t(a, device="cpu", dtype=None):
    t = torch.from_numpy(np.array(a)).to(device)
    return t.to(dtype) if dtype is not None else t


@pytest.mark.parametrize("B,S,di,N,chunk_t", [(2, 13, 16, 8, 8),
                                              (3, 7, 24, 16, 4)])
def test_plain_scan_matches_pallas_cold_start(ref, B, S, di, N, chunk_t):
    """h0 = 0, every position valid: the TPU kernel's own contract, with
    S not a multiple of its time chunk (and di of its d block)."""
    c = _scan_case(B * S, B, S, di, N)
    y, h = sops.selective_scan(
        _t(c["dt"]), _t(c["xs"]), _t(c["Bc"]), _t(c["Cc"]), _t(c["A"]),
        _t(c["D"]), torch.zeros(B, di, N),
        torch.full((B,), S, dtype=torch.int32))
    jnp = ref.jnp
    jy, jh = ref.ops.selective_scan(
        jnp.asarray(c["dt"]), jnp.asarray(c["Bc"]), jnp.asarray(c["Cc"]),
        jnp.asarray(c["xs"]), jnp.asarray(c["A"]), jnp.asarray(c["D"]),
        block_d=16, chunk_t=chunk_t, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    # the model-level plain scan is the same function
    my, mh = TMB.selective_scan(_t(c["dt"]), _t(c["Bc"]), _t(c["Cc"]),
                                _t(c["xs"]), _t(c["A"]), _t(c["D"]))
    np.testing.assert_allclose(my.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(mh.numpy(), np.asarray(jh), atol=ATOL, rtol=0)


def test_plain_scan_with_carried_state_matches_oracle(ref):
    """A carried state h0 and every position valid: the reference's
    sequential oracle with ``h0``."""
    c = _scan_case(5, 3, 6, 16, 8)
    B, S = 3, 6
    y, h = sops.selective_scan(
        _t(c["dt"]), _t(c["xs"]), _t(c["Bc"]), _t(c["Cc"]), _t(c["A"]),
        _t(c["D"]), _t(c["h0"]), torch.full((B,), S, dtype=torch.int32))
    jnp = ref.jnp
    jy, jh = ref.ref.selective_scan_ref(
        jnp.asarray(c["dt"]), jnp.asarray(c["Bc"]), jnp.asarray(c["Cc"]),
        jnp.asarray(c["xs"]), jnp.asarray(c["A"]), jnp.asarray(c["D"]),
        h0=jnp.asarray(c["h0"]))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL, rtol=0)


@pytest.mark.parametrize("T", [1, 5])
def test_mamba_paged_step_matches_reference(ref, T):
    """The served step (``mamba_slab_step`` over a slab pool, rows
    addressed as the paged engine addresses them) against the
    reference's ``mamba_paged_step``: carried conv and SSM state, rows
    on permuted slabs, t_valid mixing 0, partial and full rows, the idle
    row writing only the dump slab: outputs of the valid positions, the
    next conv window and the SSM state all within 1e-5."""
    rng = np.random.default_rng(T)
    B, dc, di, N = 4, 4, CFG.d_inner, CFG.ssm.d_state
    x = rng.standard_normal((B, T, CFG.d_model)).astype(np.float32)
    conv = rng.standard_normal((B, dc - 1, di)).astype(np.float32)
    ssm = rng.standard_normal((B, di, N)).astype(np.float32)
    t_valid = np.array([0, T, max(T - 2, 1), 1], np.int32)
    jnp = ref.jnp
    jy, (jconv, jssm) = ref.mamba.mamba_paged_step(
        {k: jnp.asarray(v) for k, v in ref.params.items()}, ref.cfg,
        jnp.asarray(x), jnp.asarray(conv), jnp.asarray(ssm),
        jnp.asarray(t_valid))
    slots = torch.tensor([4, 0, 3, 1])
    dump = B + 1                                   # slab 2 is unowned
    pool = _t(rng.standard_normal((B + 2, di, N)).astype(np.float32))
    pool[slots] = _t(ssm)
    before = pool.clone()
    write = torch.where(_t(t_valid) > 0, slots, dump)
    tp = {k: _t(v) for k, v in ref.params.items()}
    ty, tconv = TMB.mamba_slab_step(tp, CFG, _t(x), _t(conv), pool, slots,
                                    write, _t(t_valid))
    np.testing.assert_allclose(tconv.numpy(), np.asarray(jconv), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(pool[slots].numpy(), np.asarray(jssm),
                               atol=ATOL, rtol=0)
    assert torch.equal(pool[4], before[4])         # the idle row's slab
    assert torch.equal(pool[2], before[2])         # unowned
    for b in range(B):
        n = t_valid[b]
        np.testing.assert_allclose(ty[b, :n].numpy(), np.asarray(jy)[b, :n],
                                   atol=ATOL, rtol=0)


def test_mamba_decode_and_params_match_reference(ref):
    """The dense decode's step (``mamba_slab_step``, row b on slab b,
    one token) against the reference's ``mamba_decode``."""
    rng = np.random.default_rng(9)
    B, di, N = 2, CFG.d_inner, CFG.ssm.d_state
    x = rng.standard_normal((B, 1, CFG.d_model)).astype(np.float32)
    conv = rng.standard_normal((B, 3, di)).astype(np.float32)
    ssm = rng.standard_normal((B, di, N)).astype(np.float32)
    jnp = ref.jnp
    jy, (jc, js) = ref.mamba.mamba_decode(
        {k: jnp.asarray(v) for k, v in ref.params.items()}, ref.cfg,
        jnp.asarray(x), jnp.asarray(conv), jnp.asarray(ssm))
    ts = _t(ssm)
    ty, tc = TMB.mamba_slab_step({k: _t(v) for k, v in ref.params.items()},
                                 CFG, _t(x), _t(conv), ts, None, None,
                                 torch.ones((B,), dtype=torch.int32))
    for a, b in ((ty, jy), (tc, jc), (ts, js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)
    # the port's init builds the same leaves; A_log and D stay f32 in bf16
    own = TMB.mamba_params(torch.Generator().manual_seed(0), CFG,
                           torch.bfloat16)
    assert set(own) == set(ref.params)
    for k, v in own.items():
        assert tuple(v.shape) == ref.params[k].shape, k
        assert v.dtype == (torch.float32 if k in ("A_log", "D")
                           else torch.bfloat16), k
    np.testing.assert_allclose(own["A_log"].numpy(), ref.params["A_log"],
                               atol=1e-6, rtol=0)


def test_scan_wrapper_rejects_unsupported_operands():
    c = {k: _t(v) for k, v in _scan_case(0, 2, 3, 8, 4).items()}
    args = [c[k] for k in ("dt", "xs", "Bc", "Cc", "A", "D", "h0", "t_valid")]
    sops.check_scan_operands(*args)                         # the valid call

    def bad(i, v):
        a = list(args)
        a[i] = v
        return a
    with pytest.raises(TypeError):
        sops.check_scan_operands(*bad(1, args[1].double()))
    with pytest.raises(TypeError):
        sops.check_scan_operands(*bad(6, args[6].bfloat16()))
    with pytest.raises(TypeError):
        sops.check_scan_operands(*bad(7, args[7].long()))
    with pytest.raises(ValueError, match="contiguous"):
        sops.check_scan_operands(*bad(0, args[0].transpose(0, 1)))
    with pytest.raises(ValueError, match="h0"):
        sops.check_scan_operands(*bad(6, args[6][:1].contiguous()))
    big = torch.zeros(2, 3, 17)
    with pytest.raises(ValueError, match="d_state"):
        sops.check_scan_operands(args[0], args[1], big, big,
                                 torch.zeros(8, 17), args[5],
                                 torch.zeros(2, 8, 17), args[7])


def _split_bc(Bc, Cc, dtr=5):
    """Bc, Cc as the served path hands them over: ``torch.split`` views of
    one (B, T, dtr + 2N) projection output."""
    B, T, N = Bc.shape
    proj = torch.cat([torch.zeros((B, T, dtr), dtype=Bc.dtype,
                                  device=Bc.device), Bc, Cc], dim=-1)
    _, b, c = torch.split(proj, [dtr, N, N], dim=-1)
    return b, c


def test_scan_operands_take_split_views_by_row_stride():
    """Bc/Cc need no copy when they are split views of the x_proj output:
    the check returns their common row stride; a view without one (a
    strided last axis, a transposed tensor, two strides) is refused."""
    c = {k: _t(v) for k, v in _scan_case(1, 3, 4, 8, 6).items()}
    Bv, Cv = _split_bc(c["Bc"], c["Cc"])
    assert not Bv.is_contiguous()
    args = [c["dt"], c["xs"], Bv, Cv, c["A"], c["D"], c["h0"], c["t_valid"]]
    assert sops.check_scan_operands(*args) == 5 + 2 * 6
    contiguous = [c[k] for k in ("dt", "xs", "Bc", "Cc", "A", "D", "h0",
                                 "t_valid")]
    assert sops.check_scan_operands(*contiguous) == 6
    # T = 1 (decode): the row stride is the batch stride
    one = {k: (v[:, :1] if k in ("dt", "xs", "Bc", "Cc") else v)
           for k, v in c.items()}
    B1, C1 = _split_bc(one["Bc"].contiguous(), one["Cc"].contiguous())
    assert sops.check_scan_operands(
        one["dt"].contiguous(), one["xs"].contiguous(), B1, C1, c["A"],
        c["D"], c["h0"], c["t_valid"]) == 17
    wide = torch.zeros(3, 4, 12)
    bad = [wide[..., ::2],                                  # stride 2 in n
           torch.zeros(4, 3, 6).transpose(0, 1),            # batch inside time
           torch.zeros(3, 4, 7)[..., :6]]                   # ok alone ...
    for i, v in enumerate(bad):
        a = list(args)
        a[2] = v
        a[3] = v if i < 2 else Cv                           # ... two strides
        with pytest.raises(ValueError, match="row stride"):
            sops.check_scan_operands(*a)


def _slab_case(seed, B=5, T=3, di=16, N=8, slots=4):
    """A serving step's slab operands: ``slots`` slabs plus the dump row,
    B rows: row 0 fresh (starts this step), rows 1-2 live, row 3 idle
    with a stale slot equal to row 1's, row 4 idle on an unowned slot
    (rows 3 and 4 both write the dump)."""
    c = {k: _t(v) for k, v in _scan_case(seed, B, T, di, N).items()}
    rng = np.random.default_rng(seed + 1)
    pool = _t(rng.standard_normal((slots + 1, di, N)).astype(np.float32))
    state_slots = torch.tensor([0, 2, 1, 2, 3], dtype=torch.int32)
    lengths = torch.tensor([0, 7, 4, 9, 2], dtype=torch.int32)
    c["t_valid"] = torch.tensor([T, T, 1, 0, 0], dtype=torch.int32)
    return c, pool, state_slots, lengths


def test_slab_plain_equals_gather_where_scan_scatter_bitwise():
    """The slab entry's plain version is, bit for bit, the serving step's
    old sequence: gather the rows' slabs, zero fresh rows, scan, then
    ``index_copy_`` the last states to the slots of rows that advanced
    and to the dump row for idle ones."""
    from repro_torch.models.transformer import _slab_rows
    c, pool, state_slots, lengths = _slab_case(3)
    dump = pool.shape[0] - 1
    ops_in = [c[k] for k in ("dt", "xs", "Bc", "Cc", "A", "D")]
    # the old sequence
    old_pool = pool.clone()
    rows = state_slots.clamp(0, dump - 1).long()
    fresh = (lengths == 0)[:, None, None]
    h0 = torch.where(fresh, 0, old_pool[rows])
    want_y, h_last = sops.selective_scan_plain(*ops_in, h0, c["t_valid"])
    idx = torch.where(c["t_valid"] > 0, state_slots, dump).long()
    old_pool.index_copy_(0, idx, h_last)
    # the slab entry, through the step's row addressing
    _, fresh2, read, write = _slab_rows(lengths, c["t_valid"], state_slots,
                                        dump)
    assert torch.equal(fresh2, fresh)
    assert read.tolist() == [-1, 2, 1, 2, 3]
    assert write.tolist() == [0, 2, 1, dump, dump]
    new_pool = pool.clone()
    y = sops.selective_scan_slab(*ops_in, new_pool, read, write,
                                 c["t_valid"])
    assert torch.equal(y, want_y)
    assert torch.equal(new_pool, old_pool)
    assert torch.equal(new_pool[3], pool[3])    # idle row's slab untouched
    # identity rows (the dense engine's decode): the in-place copy_
    ident = pool[:5].clone()
    y = sops.selective_scan_slab(*ops_in, ident, None, None, c["t_valid"])
    want_y, want_h = sops.selective_scan_plain(*ops_in, pool[:5],
                                               c["t_valid"])
    assert torch.equal(y, want_y) and torch.equal(ident, want_h)


def test_slab_wrapper_rejects_unsupported_operands():
    c, pool, state_slots, lengths = _slab_case(4)
    ops_in = [c[k] for k in ("dt", "xs", "Bc", "Cc", "A", "D")]
    rows = torch.tensor([0, 1, 2, 3, 4])
    sops.check_slab_operands(*ops_in, pool, rows, rows, c["t_valid"])
    sops.check_slab_operands(*ops_in, pool, None, None, c["t_valid"])
    with pytest.raises(ValueError, match="read_rows"):
        sops.check_slab_operands(*ops_in, pool, rows.int(), rows,
                                 c["t_valid"])
    with pytest.raises(ValueError, match="write_rows"):
        sops.check_slab_operands(*ops_in, pool, rows, rows[:3],
                                 c["t_valid"])
    with pytest.raises(ValueError, match="slabs"):
        sops.check_slab_operands(*ops_in, pool[:4], None, rows,
                                 c["t_valid"])
    with pytest.raises(TypeError, match="pool"):
        sops.check_slab_operands(*ops_in, pool.double(), rows, rows,
                                 c["t_valid"])
    with pytest.raises(ValueError, match="pool"):
        sops.check_slab_operands(*ops_in, pool[:, :, :4].contiguous(), rows,
                                 rows, c["t_valid"])


# -- on the card: the kernel against its plain version ------------------------

# f32: the kernel's expf and its fused multiply-adds against torch's exp
# and separate products, and its sequential N-sum against einsum's:
# values here are O(10), so f32 rounding stays well under 1e-4.
_TOL = 1e-4


@pytest.mark.parametrize("B,T,di,N", [
    (3, 1, 200, 8), (2, 37, 256, 16), (8, 32, 8192, 16), (1, 512, 8192, 16),
    (8, 512, 1024, 16), (2, 37, 256, 1), (2, 37, 256, 3), (3, 5, 203, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernel_matches_plain(cuda, B, T, di, N, dtype):
    """Every state-quad layout (N = 1 and 3: one lane a channel with pad
    values; 8: two; 16: four), 16-byte and element-wise staging (di 203
    and the 3 + 2N-wide projection rows are not whole 16-byte chunks),
    one and several staged tiles, Bc/Cc as split views of one projection
    (the served layout) and, for the first shape, contiguous."""
    c = _scan_case(B + T, B, T, di, N)
    c["t_valid"][0] = 0
    c["t_valid"][-1] = T
    Bc, Cc = _split_bc(_t(c["Bc"], cuda, dtype), _t(c["Cc"], cuda, dtype),
                       dtr=256 if N == 16 else 3)
    args = (_t(c["dt"], cuda, dtype), _t(c["xs"], cuda, dtype), Bc, Cc,
            _t(c["A"], cuda), _t(c["D"], cuda), _t(c["h0"], cuda),
            _t(c["t_valid"], cuda))
    cases = [args]
    if (B, T, di) == (3, 1, 200):
        cases.append(args[:2] + (Bc.contiguous(), Cc.contiguous()) + args[4:])
    for a in cases:
        n0 = sops.KERNEL.launches
        y, h = sops.selective_scan(*a)
        wy, wh = sops.selective_scan_plain(*a)
        torch.cuda.synchronize()
        assert sops.KERNEL.launches == n0 + 1
        assert y.dtype == h.dtype == torch.float32
        assert (y - wy).abs().max().item() <= _TOL
        assert (h - wh).abs().max().item() <= _TOL
        if B > 1:                                   # t_valid = 0: untouched
            assert torch.equal(h[0], a[6][0])


@pytest.mark.parametrize("T,dtype", [(1, torch.bfloat16), (3, torch.float32),
                                     (32, torch.bfloat16)])
def test_slab_kernel_matches_plain(cuda, T, dtype):
    """The slab entry in place on the card against its plain version: a
    fresh row, live rows, an idle row whose stale slot is a live row's
    slab and another on an unowned slab, both writing the dump.  Live
    rows' y and slabs within the tolerance; the unowned and the spare
    slab bit-identical (the dump and idle rows' y are not defined)."""
    c, pool, state_slots, lengths = _slab_case(5, T=T, di=512, N=16,
                                               slots=6)
    from repro_torch.models.transformer import _slab_rows
    _, _, read, write = _slab_rows(lengths, c["t_valid"], state_slots,
                                   pool.shape[0] - 1)
    Bc, Cc = _split_bc(c["Bc"].to(cuda, dtype), c["Cc"].to(cuda, dtype),
                       dtr=256)
    args = (c["dt"].to(cuda, dtype), c["xs"].to(cuda, dtype), Bc, Cc,
            c["A"].to(cuda), c["D"].to(cuda))
    rest = (read.to(cuda), write.to(cuda), c["t_valid"].to(cuda))
    got_pool, want_pool = pool.to(cuda), pool.to(cuda)
    entry = f"selective_scan_slab_{sops._NAMES[dtype]}"
    n0 = sops.KERNEL.entry_launches[entry]
    y = sops.selective_scan_slab(*args, got_pool, *rest)
    wy = sops.selective_scan_slab_plain(*args, want_pool, *rest)
    torch.cuda.synchronize()
    assert sops.KERNEL.entry_launches[entry] == n0 + 1
    live = [0, 1, 2]
    assert (y[live] - wy[live]).abs().max().item() <= _TOL
    written = sorted({int(write[b]) for b in live})
    assert (got_pool[written] - want_pool[written]).abs().max().item() <= _TOL
    for untouched in (3, 4, 5):                     # not written by anyone
        assert torch.equal(got_pool[untouched], pool[untouched].to(cuda))
