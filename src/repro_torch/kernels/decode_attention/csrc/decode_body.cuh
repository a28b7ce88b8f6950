// One-token attention over a row's K/V for Hopper (sm_90a): the body
// shared by paged_decode.cu (K1, keys through a page table),
// paged_decode_quant.cu (B3, the same over int8 pools) and
// dense_decode.cu (B4, keys in a contiguous cache).  They differ only in
// a row policy, a struct with
//   int n_keys(int b) const;           // keys of batch row b (0..n-1)
//   size_t row(int b, int pos) const;  // (KV, hd) slab holding key pos
//   static constexpr bool kRoundScores;  // round q.k to the promoted
//                                        // q/K type, as the reference's
//                                        // dense path does
// and in a scales policy (common.cuh: NoScales, or RowScales for int8
// pools, whose rows are dequantized as a tile is loaded).
// Query head h reads KV head h / G; softmax with an online (m, l, acc) in
// f32, the reference's -1e30 masking and a max(l, 1e-30) denominator.
//
// What bounds it on the card: bytes.  Every valid key costs one K row and
// one V row of hd elements, against 2 * G * hd multiply-adds for the G
// query heads of its KV head: a few operations per byte, far below the
// H100's ~295 bf16 operations per byte of device memory.  The design
// answers that in two ways:
//   * one thread block per (row, KV head) computes all G query heads of
//     that KV head, so each K/V row leaves device memory once per group
//     (the TPU grid walked the keys once per query head);
//   * K/V are read in the caller's (..., KV, hd) layout, row by row, with
//     no per-call transpose (the TPU ops moved the head axis every call).
// Keys stream through shared memory in tiles of kKeyTile rows, loaded 16
// bytes per thread with every load of a tile in flight at once (one block
// per SM leaves few warps to hide memory latency); scores, the softmax
// update and the P.V product run on CUDA cores in f32.  B * KV blocks
// leave most SMs idle at small batch.
// Later work: split the key range across blocks with a combine pass, and
// overlap the next tile's loads (cp.async / TMA).
//
// Rounding follows the reference: q * scale in q's type, (with
// kRoundScores) scores in the promoted q/K type, the probabilities
// rounded to the K/V type before the P.V product, the output in the K/V
// type (f32 for int8 pools, which compute in f32).

#pragma once

#include "../../csrc/common.cuh"

namespace kern {
namespace decode {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeyTile = 64;

inline size_t smem_bytes(int G, int hd) {
  // q, acc: G*hd; K tile: kKeyTile*(hd+1); V tile: kKeyTile*hd;
  // probabilities: G*kKeyTile; m, l, correction: 3*G
  return sizeof(float) * (size_t)(2 * G * hd + kKeyTile * (hd + 1) +
                                  kKeyTile * hd + G * kKeyTile + 3 * G);
}

// The paged row policy (K1, B3): keys at logical positions
// kpos < lengths[b] of slot b, read through its page table.
struct PagedRows {
  const int* page_table;  // (B, P)
  const int* lengths;     // (B,) valid keys
  int bs, P;
  static constexpr bool kRoundScores = false;
  // keys past the page table do not exist (the reference's gather view
  // ends at P * bs); unallocated entries are never dereferenced
  __device__ int n_keys(int b) const { return min(lengths[b], P * bs); }
  __device__ size_t row(int b, int pos) const {
    return paged_row(page_table + (size_t)b * P, bs, pos);
  }
};

template <typename Tq, typename Tkv, typename Rows, typename Scales>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const Tq* __restrict__ q,    // (B, H, hd)
              const Tkv* __restrict__ k,   // slabs of (KV, hd), see Rows
              const Tkv* __restrict__ v,
              typename Compute<Tkv>::type* __restrict__ out,  // (B, H, hd)
              Rows rows, Scales scales, int H, int KV, int hd, float scale) {
  using Tv = typename Compute<Tkv>::type;
  using Ts = typename Promote<Tq, Tv>::type;
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

  const int n_keys = rows.n_keys(b);
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
      const size_t slab = rows.row(b, k0 + j) * KV + kvh;
      const size_t off = slab * hd + d;
      float kf[N], vf[N];
      Chunk<Tkv>::load(k + off, kf);
      Chunk<Tkv>::load(v + off, vf);
      if constexpr (Scales::kQuant) {
        const float sk = scales.k(slab), sv = scales.v(slab);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          kf[e] = __fmul_rn(kf[e], sk);
          vf[e] = __fmul_rn(vf[e], sv);
        }
      }
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
        if (Rows::kRoundScores) s = round_to<Ts>(s);
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
        const float p = expf(sr[j] - m_new);  // keys past nk: exp(-1e30) = 0
        sum += p;
        sr[j] = round_to<Tv>(p);
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
    out[q_base + i] = from_f32<Tv>(acc[i] / fmaxf(l_s[g], 1e-30f));
  }
}

// Launch one block per (row, KV head); returns cudaGetLastError().
template <typename Tq, typename Tkv, typename Rows,
          typename Scales = NoScales>
int launch(const void* q, const void* k, const void* v, void* out, Rows rows,
           int B, int H, int KV, int hd, float scale, void* stream,
           Scales scales = Scales()) {
  using Tv = typename Compute<Tkv>::type;
  const size_t smem = smem_bytes(H / KV, hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<Tq, Tkv, Rows, Scales>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_kernel<Tq, Tkv, Rows, Scales>
      <<<dim3(B, KV), kThreads, smem, (cudaStream_t)stream>>>(
          (const Tq*)q, (const Tkv*)k, (const Tkv*)v, (Tv*)out, rows, scales,
          H, KV, hd, scale);
  return (int)cudaGetLastError();
}

}  // namespace decode
}  // namespace kern
