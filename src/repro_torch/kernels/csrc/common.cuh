// Helpers shared by the hand-written kernels (each kernel library is one
// translation unit that includes this header once).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kern {

constexpr float kNeg = -1e30f;  // the reference's masked score

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T's precision, returned as f32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// the type q . k is produced in: bf16 only when both operands are bf16
template <typename A, typename B> struct Promote { using type = float; };
template <> struct Promote<__nv_bfloat16, __nv_bfloat16> {
  using type = __nv_bfloat16;
};

// The type a K/V element computes in, and the attention output's type:
// the pool's own for f32/bf16 pools, f32 for int8 pools (dequantized).
template <typename T> struct Compute { using type = T; };
template <> struct Compute<int8_t> { using type = float; };

// One 16-byte chunk of a K/V row (4 f32, 8 bf16 or 16 int8 values),
// widened to f32.  Rows start at multiples of hd elements and the
// wrappers require hd % 8 == 0 (hd % 16 == 0 for int8), so every chunk
// is 16-byte aligned.
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* src, float* dst) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* src,
                                              float* dst) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};

template <> struct Chunk<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void load(const int8_t* src, float* dst) {
    const int4 v = *reinterpret_cast<const int4*>(src);
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[i] = (float)b[i];
  }
};

// Dequantization of the K/V rows a tile loads.  f32/bf16 pools carry
// none.  int8 pools carry one f32 scale per (block row, KV head) for K
// and one for V, at the same index as the row's slab in (nb, bs, KV):
// a row is widened to f32 and multiplied by its scale (rounded once, as
// the reference's `k.astype(f32) * ks[:, None]`) before the dot.
struct NoScales {
  static constexpr bool kQuant = false;
  __device__ float k(size_t) const { return 1.f; }
  __device__ float v(size_t) const { return 1.f; }
};
struct RowScales {
  const float* ks;  // (nb, bs, KV)
  const float* vs;
  static constexpr bool kQuant = true;
  __device__ float k(size_t i) const { return ks[i]; }
  __device__ float v(size_t i) const { return vs[i]; }
};

// Asynchronous global -> shared copies (cp.async, sm_80+).  A copy whose
// predicate is false reads nothing and zero-fills its destination.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes, bypassing L1
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
// 4 bytes (a row scale)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special-function unit; a result below 2^-126 flushes to 0
// (a probability that small is lost beside the row's largest, which is
// 1).  2^0 is exactly 1.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Page-table addressing of the serving engine's pools (nb, bs, KV, hd):
// the index of the (KV, hd) slab that holds logical position pos of a
// sequence whose pages are pt[0..].
__device__ __forceinline__ size_t paged_row(const int* pt, int bs, int pos) {
  return (size_t)pt[pos / bs] * bs + pos % bs;
}

}  // namespace kern

// Every C entry returns cudaGetLastError(); the binding turns a non-zero
// code into this message.
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
