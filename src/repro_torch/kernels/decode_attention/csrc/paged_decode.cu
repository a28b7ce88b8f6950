// Paged decode attention for Hopper (sm_90a): one query token per
// (slot, head) attends over the slot's KV pages through its page table.
//
// Replaces src/repro/kernels/decode_attention/kernel.py::
// paged_decode_attention (body _paged_decode_kernel), the TPU kernel for
// the T = 1 steps of the paged serving engine.  Same function: keys at
// logical positions kpos < lengths[b] of slot b, read from physical row
// page_table[b][kpos / bs] * bs + kpos % bs of the shared pool; query
// head h reads KV head h / G; softmax with an online (m, l, acc) in f32.
//
// What bounds it on the card: bytes.  Every valid key costs one K row and
// one V row of hd elements, against 2 * G * hd multiply-adds for the G
// query heads of its KV head: a few operations per byte, far below the
// H100's ~295 bf16 operations per byte of device memory.  The design
// answers that in two ways:
//   * one thread block per (slot, KV head) computes all G query heads of
//     that KV head, so each K/V row leaves device memory once per group
//     (the TPU grid walked the pages once per query head);
//   * the pool is read in the engine's own (nb, bs, KV, hd) layout, row by
//     row through the page table, with no per-call transpose of the whole
//     pool (the TPU op transposed it to (nb, KV, bs, hd) on every call).
// Keys stream through shared memory in tiles of kKeyTile rows, loaded 16
// bytes per thread with every load of a tile in flight at once (one block
// per SM leaves few warps to hide memory latency); scores, the softmax
// update and the P.V product run on CUDA cores in f32.
// Later work: split the key range across blocks when slots x KV heads
// leave SMs idle, and overlap the next tile's loads (cp.async / TMA).
//
// Rounding follows the reference: q is scaled in its own type, and the
// probabilities are rounded to the K/V type before the P.V product
// (probs.astype(v.dtype) in repro/models/attention.py::paged_attention).
// The output has the K/V type, as the reference's einsum does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeyTile = 64;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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

// One 16-byte chunk of a K/V row (4 f32 or 8 bf16 values), widened to
// f32.  Rows start at multiples of hd elements and the wrapper requires
// hd % 8 == 0, so every chunk is 16-byte aligned.
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

size_t smem_bytes(int G, int hd) {
  // q, acc: G*hd; K tile: kKeyTile*(hd+1); V tile: kKeyTile*hd;
  // probabilities: G*kKeyTile; m, l, correction: 3*G
  return sizeof(float) * (size_t)(2 * G * hd + kKeyTile * (hd + 1) +
                                  kKeyTile * hd + G * kKeyTile + 3 * G);
}

template <typename Tq, typename Tkv>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const Tq* __restrict__ q,          // (B, H, hd)
                    const Tkv* __restrict__ k_pool,    // (nb, bs, KV, hd)
                    const Tkv* __restrict__ v_pool,    // (nb, bs, KV, hd)
                    const int* __restrict__ page_table,  // (B, P)
                    const int* __restrict__ lengths,     // (B,) valid keys
                    Tkv* __restrict__ out,               // (B, H, hd)
                    int H, int KV, int hd, int bs, int P, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, tid = threadIdx.x;
  const int G = H / KV;
  const int ld = hd + 1;  // padded K row stride: lanes hit distinct banks
  float* q_s = smem;
  float* acc = q_s + G * hd;
  float* k_s = acc + G * hd;
  float* v_s = k_s + kKeyTile * ld;
  float* p_s = v_s + kKeyTile * hd;
  float* m_s = p_s + G * kKeyTile;
  float* l_s = m_s + G;
  float* c_s = l_s + G;

  // keys past the page table do not exist (the reference's gather view
  // ends at P * bs); unallocated entries are never dereferenced
  const int n_keys = min(lengths[b], P * bs);
  const int* pt = page_table + (size_t)b * P;
  const size_t q_base = ((size_t)b * H + (size_t)kvh * G) * hd;

  for (int i = tid; i < G * hd; i += kThreads) {
    q_s[i] = round_to<Tq>(to_f32(q[q_base + i]) * scale);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNeg;
    l_s[g] = 0.f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < n_keys; k0 += kKeyTile) {
    const int nk = min(kKeyTile, n_keys - k0);
    // 16-byte loads, all of a thread's chunks issued before they are used
    constexpr int N = Chunk<Tkv>::N;
    const int cpr = hd / N;  // chunks per row
#pragma unroll 4
    for (int i = tid; i < nk * cpr; i += kThreads) {
      const int j = i / cpr, d = (i - j * cpr) * N;
      const int pos = k0 + j;
      const size_t row = ((size_t)pt[pos / bs] * bs + pos % bs) * KV + kvh;
      float kf[N], vf[N];
      Chunk<Tkv>::load(k_pool + row * hd + d, kf);
      Chunk<Tkv>::load(v_pool + row * hd + d, vf);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        k_s[j * ld + d + e] = kf[e];
        v_s[j * hd + d + e] = vf[e];
      }
    }
    __syncthreads();

    for (int i = tid; i < G * kKeyTile; i += kThreads) {
      const int g = i / kKeyTile, j = i - g * kKeyTile;
      float s = kNeg;
      if (j < nk) {
        const float* qr = q_s + g * hd;
        const float* kr = k_s + j * ld;
        s = 0.f;
        for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
      }
      p_s[i] = s;
    }
    __syncthreads();

    const int warp = tid / 32, lane = tid % 32;
    for (int g = warp; g < G; g += kWarps) {
      float* sr = p_s + g * kKeyTile;
      float mx = kNeg;
      for (int j = lane; j < kKeyTile; j += 32) mx = fmaxf(mx, sr[j]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_s[g], mx);
      float sum = 0.f;
      for (int j = lane; j < kKeyTile; j += 32) {
        const float p = expf(sr[j] - m_new);  // masked keys: exp(-1e30) = 0
        sum += p;
        sr[j] = round_to<Tkv>(p);
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_s[g] - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd, d = i - g * hd;
      const float* pr = p_s + g * kKeyTile;
      float a = acc[i] * c_s[g];
      for (int j = 0; j < nk; ++j) a = fmaf(pr[j], v_s[j * hd + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd;
    out[q_base + i] = from_f32<Tkv>(acc[i] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename Tq, typename Tkv>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_table, const void* lengths, void* out, int B,
           int H, int KV, int hd, int bs, int P, float scale, void* stream) {
  const size_t smem = smem_bytes(H / KV, hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<Tq, Tkv>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_decode_kernel<Tq, Tkv>
      <<<dim3(B, KV), kThreads, smem, (cudaStream_t)stream>>>(
          (const Tq*)q, (const Tkv*)k_pool, (const Tkv*)v_pool,
          (const int*)page_table, (const int*)lengths, (Tkv*)out, H, KV, hd,
          bs, P, scale);
  return (int)cudaGetLastError();
}

}  // namespace

#define PAGED_DECODE_ENTRY(NAME, TQ, TKV)                                    \
  extern "C" int NAME(const void* q, const void* k_pool, const void* v_pool, \
                      const void* page_table, const void* lengths,           \
                      void* out, int B, int H, int KV, int hd, int bs,       \
                      int P, float scale, void* stream) {                    \
    return launch<TQ, TKV>(q, k_pool, v_pool, page_table, lengths, out, B,   \
                           H, KV, hd, bs, P, scale, stream);                 \
  }

PAGED_DECODE_ENTRY(paged_decode_attention_f32_f32, float, float)
PAGED_DECODE_ENTRY(paged_decode_attention_f32_bf16, float, __nv_bfloat16)
PAGED_DECODE_ENTRY(paged_decode_attention_bf16_bf16, __nv_bfloat16,
                   __nv_bfloat16)

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
