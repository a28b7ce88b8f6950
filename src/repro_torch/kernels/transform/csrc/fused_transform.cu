// Fused tensor_transform for Hopper (sm_90a): y = cast(clip(f32(x) *
// scale + bias, lo, hi)) over a flat tensor, in one pass.
//
// Replaces src/repro/kernels/transform/kernel.py::fused_transform_2d
// (body _transform_kernel), the TPU kernel behind
// TensorTransform(backend="fused"): a tensor_transform chain such as
// "typecast:float32,divide:255,subtract:0.5,clamp:-0.5:0.5" folded into
// one affine op.  Same function, elementwise over any shape: the TPU op
// padded the flat tensor to (8, 128) tiles, which this kernel does not
// need (a grid-stride loop over the n elements, no padding).  The plain
// version is kernels/transform/ops.py::fused_transform_plain.
//
// Exactness against the reference, element by element:
//   * x * scale and + bias round separately (__fmul_rn / __fadd_rn):
//     nvcc would contract them into one FMA, which rounds once and moves
//     integer outputs across .5 boundaries;
//   * the clip is max(y, lo) then min(., hi) by comparison, so a NaN
//     passes through as jnp.clip lets it (fminf/fmaxf would drop it);
//   * casts to integer types saturate as JAX's do: NaN -> 0, truncation
//     toward zero, then the type's range (a C cast of an out-of-range
//     float is undefined); to bool, y != 0; to f16/bf16, round to nearest
//     even.
//
// What bounds it on the card: bytes — each input element read once and
// each output element written once (at (64, 224, 224, 3) uint8 -> f32,
// 9.6 MB + 38.5 MB, ~0.0144 ms at 3.35 TB/s), against ~4 operations per
// element.  One thread per element per grid-stride step; neighbouring
// threads touch neighbouring elements, so a warp's loads and stores
// coalesce.  Later work: 16-byte vector loads and stores per thread.
//
// Types (the stream's, core/stream.py): bool, uint8, int8, uint16, int16,
// uint32, int32, float16, bfloat16, float32 in and out, by code 0..9.
// The 64-bit types are refused by the wrapper.

#include <cuda_fp16.h>

#include "../../csrc/common.cuh"

namespace {

template <typename T> __device__ __forceinline__ float load_f32(T x) {
  return (float)x;  // integers round to nearest, as JAX's convert does
}
template <> __device__ __forceinline__ float load_f32<bool>(bool x) {
  return x ? 1.f : 0.f;
}
template <> __device__ __forceinline__ float load_f32<__half>(__half x) {
  return __half2float(x);
}
template <>
__device__ __forceinline__ float load_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// range of an integer output type, exact in double
template <typename T> struct IntRange;
template <> struct IntRange<uint8_t> {
  static constexpr double lo = 0.0, hi = 255.0;
};
template <> struct IntRange<int8_t> {
  static constexpr double lo = -128.0, hi = 127.0;
};
template <> struct IntRange<uint16_t> {
  static constexpr double lo = 0.0, hi = 65535.0;
};
template <> struct IntRange<int16_t> {
  static constexpr double lo = -32768.0, hi = 32767.0;
};
template <> struct IntRange<uint32_t> {
  static constexpr double lo = 0.0, hi = 4294967295.0;
};
template <> struct IntRange<int32_t> {
  static constexpr double lo = -2147483648.0, hi = 2147483647.0;
};

template <typename T> __device__ __forceinline__ T store_as(float y) {
  constexpr double lo = IntRange<T>::lo, hi = IntRange<T>::hi;
  if (y != y) return (T)0;  // NaN
  const double t = trunc((double)y);
  return (T)(t < lo ? lo : (t > hi ? hi : t));
}
template <> __device__ __forceinline__ bool store_as<bool>(float y) {
  return y != 0.f;  // NaN -> true
}
template <> __device__ __forceinline__ __half store_as<__half>(float y) {
  return __float2half_rn(y);
}
template <>
__device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float y) {
  return __float2bfloat16_rn(y);
}
template <> __device__ __forceinline__ float store_as<float>(float y) {
  return y;
}

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks of 256 per SM

template <typename Ti, typename To>
__global__ void __launch_bounds__(kThreads)
fused_transform_kernel(const Ti* __restrict__ x, To* __restrict__ out,
                       long long n, float scale, float bias, float lo,
                       float hi) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    float y = __fadd_rn(__fmul_rn(load_f32<Ti>(x[i]), scale), bias);
    y = y < lo ? lo : y;  // jnp.clip: maximum, then minimum; NaN stays
    y = y > hi ? hi : y;
    out[i] = store_as<To>(y);
  }
}

template <typename Ti, typename To>
int launch(const void* x, void* out, long long n, float scale, float bias,
           float lo, float hi, void* stream) {
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  fused_transform_kernel<Ti, To><<<blocks, kThreads, 0,
                                   (cudaStream_t)stream>>>(
      (const Ti*)x, (To*)out, n, scale, bias, lo, hi);
  return (int)cudaGetLastError();
}

// the output type by code, for one input type
template <typename Ti>
int launch_out(int out_code, const void* x, void* out, long long n,
               float scale, float bias, float lo, float hi, void* stream) {
#define OUT_CASE(CODE, T) \
  case CODE: return launch<Ti, T>(x, out, n, scale, bias, lo, hi, stream);
  switch (out_code) {
    OUT_CASE(0, bool)
    OUT_CASE(1, uint8_t)
    OUT_CASE(2, int8_t)
    OUT_CASE(3, uint16_t)
    OUT_CASE(4, int16_t)
    OUT_CASE(5, uint32_t)
    OUT_CASE(6, int32_t)
    OUT_CASE(7, __half)
    OUT_CASE(8, __nv_bfloat16)
    OUT_CASE(9, float)
  }
#undef OUT_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (n elements of the type with code in_code) -> out (n elements of the
// type with code out_code); returns cudaGetLastError() after the launch.
extern "C" int fused_transform(int in_code, int out_code, const void* x,
                               void* out, long long n, float scale,
                               float bias, float lo, float hi,
                               void* stream) {
#define IN_CASE(CODE, T)                                                   \
  case CODE:                                                               \
    return launch_out<T>(out_code, x, out, n, scale, bias, lo, hi, stream);
  switch (in_code) {
    IN_CASE(0, bool)
    IN_CASE(1, uint8_t)
    IN_CASE(2, int8_t)
    IN_CASE(3, uint16_t)
    IN_CASE(4, int16_t)
    IN_CASE(5, uint32_t)
    IN_CASE(6, int32_t)
    IN_CASE(7, __half)
    IN_CASE(8, __nv_bfloat16)
    IN_CASE(9, float)
  }
#undef IN_CASE
  return (int)cudaErrorInvalidValue;
}
