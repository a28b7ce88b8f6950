"""The fused tensor_transform (B7's plain version and the fused
``TensorTransform``) against the JAX reference, on the CPU.

The port computes ``cast(clip(f32(x) * scale + bias, lo, hi))`` as JAX's
program states it: the product and the sum round separately, the clip
keeps NaN, integer casts saturate.  It equals the reference's oracle
(``fused_transform_ref``, run op by op) bit for bit.  The reference's
Pallas kernel in interpret mode is jitted, and XLA on the CPU contracts
``x * scale + bias`` into one fused multiply-add: its f32 outputs differ
from the oracle's in the last bit, and the reference's own test holds
them to 1e-6 (``tests/test_kernels.py::test_transform_kernel``).  The
port is held to the same 1e-6 against it, and to exactness wherever the
arithmetic is exact in f32 (every integer-cast case below).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.elements.transform import TensorTransform as JaxTransform
from repro.kernels.transform import ops as jops
from repro.kernels.transform.ref import fused_transform_ref
from repro_torch.core import parse_pipeline
from repro_torch.core.elements.transform import TensorTransform
from repro_torch.core.stream import Buffer
from repro_torch.kernels.transform import ops as tops

ATOL_INTERPRET = 1e-6     # the reference's kernel-vs-oracle tolerance
OUT_DTYPES = ["float32", "float16", "bfloat16", "uint8", "int8", "uint16",
              "int16", "int32", "uint32", "bool"]
E4_CHAIN = "typecast:float32,divide:255.0,subtract:0.5,clamp:-0.5:0.5"


def _np(t: torch.Tensor) -> np.ndarray:
    """A port result as numpy, bf16 widened to f32 for comparison."""
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a) -> np.ndarray:
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _port(x, out_dtype, **kw):
    return tops.fused_transform(torch.from_numpy(x),
                                out_dtype=getattr(torch, out_dtype), **kw)


# the shapes and dtypes of tests/test_kernels.py::test_transform_kernel
@pytest.mark.parametrize("shape", [(5,), (7, 13), (3, 33, 5), (2, 8, 128)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_plain_matches_reference_kernel_and_oracle(shape, dtype):
    rng = np.random.default_rng(len(shape))
    x = (rng.random(shape) * 200).astype(dtype)
    kw = dict(scale=1 / 255.0, bias=-0.4, lo=-0.3, hi=0.3)
    got = _port(x, "float32", **kw).numpy()
    kernel = np.asarray(jops.fused_transform(x, out_dtype=jnp.float32, **kw))
    oracle = np.asarray(fused_transform_ref(jnp.asarray(x), 1 / 255.0, -0.4,
                                            -0.3, 0.3, jnp.float32))
    np.testing.assert_allclose(got, kernel, atol=ATOL_INTERPRET, rtol=0)
    np.testing.assert_array_equal(got, oracle)
    # the difference to the kernel is exactly XLA's contraction: the
    # kernel equals one rounding of x * scale + bias (exact in f64 here)
    s, b = np.float32(1 / 255.0), np.float32(-0.4)
    fma = np.clip((x.astype(np.float64) * s + b).astype(np.float32),
                  np.float32(-0.3), np.float32(0.3))
    np.testing.assert_array_equal(kernel, fma)


@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_plain_matches_oracle_for_every_output_type(dtype, out_dtype):
    """Bitwise equal to the op-by-op oracle for each stream type out."""
    rng = np.random.default_rng(3)
    x = (rng.random((6, 37)) * 250).astype(dtype)
    for scale, bias, lo, hi in ((1.37, -3.5, -1e10, 1e10),
                                (1 / 255.0, -0.5, -0.5, 0.5),
                                (-2.0, 7.25, -np.inf, np.inf)):
        got = _np(_port(x, out_dtype, scale=scale, bias=bias, lo=lo, hi=hi))
        want = _jnp(fused_transform_ref(jnp.asarray(x), scale, bias, lo, hi,
                                        jnp.dtype(out_dtype)))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("out_dtype", ["uint8", "int8", "uint16", "int16",
                                       "int32", "uint32", "bool"])
def test_integer_casts_saturate_like_jax(out_dtype):
    """Out of range, NaN and +-inf: JAX truncates toward zero, clamps to
    the type's range and sends NaN to 0 (torch's own ``.to`` wraps:
    [-3.7, 300.5, nan, inf] -> uint8 [253, 44, 0, 0])."""
    x = np.array([-3.7, 300.5, np.nan, np.inf, -np.inf, 3e9, -3e9, 2.5,
                  -0.5, 127.9, -128.9, 65535.5], np.float32)
    want = np.asarray(jnp.asarray(x).astype(out_dtype))
    got = _port(x, out_dtype).numpy()
    np.testing.assert_array_equal(got, want)
    kernel = np.asarray(jops.fused_transform(x, out_dtype=jnp.dtype(out_dtype)))
    np.testing.assert_array_equal(got, kernel)


def test_clip_keeps_nan_and_lo_above_hi_gives_hi():
    x = np.array([np.nan, -np.inf, np.inf, 0.2, 3.0], np.float32)
    for out_dtype in ("float32", "float16", "bfloat16"):
        for lo, hi in ((-0.5, 0.5), (0.5, -0.5)):
            got = _np(_port(x, out_dtype, lo=lo, hi=hi))
            want = _jnp(jops.fused_transform(x, lo=lo, hi=hi,
                                             out_dtype=jnp.dtype(out_dtype)))
            np.testing.assert_array_equal(got, want)
    assert np.isnan(_port(x, "float32", lo=-0.5, hi=0.5)[0].item())


def test_64_bit_types_and_other_devices_are_refused():
    x = torch.zeros(4, dtype=torch.float32)
    for dt in (torch.float64, torch.int64):
        with pytest.raises(TypeError, match="64-bit"):
            tops.fused_transform(x, out_dtype=dt)
        with pytest.raises(TypeError, match="64-bit"):
            tops.fused_transform(x.to(dt))
    with pytest.raises(ValueError, match="no kernel"):
        tops.fused_transform(x.to("meta"))


# -- the fused element --------------------------------------------------------

def _run(element, arr):
    return np.asarray(element.transform(element.sinkpad, Buffer(arr)).data)


@pytest.mark.parametrize("chain,dtype,exact", [
    (E4_CHAIN, np.uint8, False),
    ("typecast:float32,multiply:2.0,add:1.0", np.uint8, True),
    ("typecast:uint8,multiply:2.0,add:1.0", np.float32, True),
    ("typecast:int8,subtract:3.0,clamp:-100:100", np.float32, True),
    ("add:-20.0", np.uint8, True),
    ("typecast:bool,subtract:1.0", np.float32, True),
    ("typecast:float16,divide:4.0", np.int32, True),
    ("typecast:bfloat16,divide:4.0", np.uint8, True)])
def test_fused_element_matches_reference_element(chain, dtype, exact):
    """The reference's fused element (its kernel in interpret mode) and
    the port's (plain path on the CPU): exact where the chain's
    arithmetic is exact in f32, else within 1e-6 (the FMA above).  The
    inputs carry out-of-range values and, for floats, NaN and +-inf."""
    rng = np.random.default_rng(11)
    arr = (rng.random((4, 9, 3)) * 400 - 100).astype(dtype)
    if dtype == np.float32:
        arr[0, :3, 0] = [np.nan, np.inf, -np.inf]
    ref = _run(JaxTransform("t", chain, backend="fused"), arr)
    got = _run(TensorTransform("t", chain, backend="fused", device="cpu"),
               arr)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=ATOL_INTERPRET, rtol=0)


@pytest.mark.parametrize("chain", ["typecast:float32,normalize",
                                   "transpose:1:0:2,add:1.0"])
def test_unfoldable_chain_raises(chain):
    with pytest.raises(ValueError, match="foldable"):
        JaxTransform("t", chain, backend="fused")
    with pytest.raises(ValueError, match="foldable"):
        TensorTransform("t", chain, backend="fused", device="cpu")


def test_fused_element_defaults_to_cuda():
    if torch.cuda.is_available():
        assert TensorTransform("t", E4_CHAIN,
                               backend="fused").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TensorTransform("t", E4_CHAIN, backend="fused")
    assert TensorTransform("t", E4_CHAIN).device is None   # numpy backend


def test_parsed_pipeline_runs_the_fused_element():
    """The e4 chain through the port's parser and registry, frames of
    224x224x3, against the numpy chain within 1e-6 and the op-by-op
    oracle exactly."""
    pipe = parse_pipeline(
        "videotestsrc num_buffers=3 ! tensor_converter ! tensor_transform "
        f"option={E4_CHAIN} backend=fused device=cpu ! "
        "tensor_sink name=out keep=true")
    pipe.start()
    try:
        assert pipe["out"].eos_seen.wait(timeout=60)
        pipe.check_bus()
    finally:
        pipe.stop()
    from repro_torch.core.elements.sources import VideoTestSrc
    from repro_torch.core.elements.transform import (apply_chain_numpy,
                                                     parse_chain)
    src = VideoTestSrc("s")
    outs = [np.asarray(b.data) for b in pipe["out"].buffers]
    assert len(outs) == 3
    for i, out in enumerate(outs):
        frame = src.create(i).data
        assert out.shape == (224, 224, 3) and out.dtype == np.float32
        np.testing.assert_allclose(
            out, apply_chain_numpy(frame, parse_chain(E4_CHAIN)), atol=1e-6,
            rtol=0)
        np.testing.assert_array_equal(out, np.asarray(fused_transform_ref(
            jnp.asarray(frame), 1 / 255.0, -0.5, -0.5, 0.5, jnp.float32)))
