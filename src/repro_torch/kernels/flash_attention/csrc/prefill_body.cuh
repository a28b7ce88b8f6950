// Blockwise attention of a chunk of query tokens over a row's K/V for
// Hopper (sm_90a): the body shared by paged_prefill.cu (K2, keys through
// a page table), paged_prefill_quant.cu (K2q, the same over int8 pools)
// and flash_prefill.cu (B2's contiguous entry).  They differ only in a
// row policy, a struct with
//   int q_pos0(int b) const;           // position of row b's query 0
//   int n_keys(int b) const;           // keys row b holds (0..n-1)
//   size_t row(int b, int pos) const;  // (KV, hd) slab holding key pos
//   static constexpr bool kRoundScores;  // round q.k to the promoted
//                                        // q/K type, as the reference's
//                                        // dense path does
// in a scales policy (common.cuh: NoScales, or RowScales for int8 pools,
// whose rows are dequantized as a tile is loaded) and in the query tile
// kQTile.  Query t of row b sits at position
// q_pos0(b) + t and sees key kpos iff kpos < n_keys(b), kpos <= its
// position (causal) and kpos > its position - window (window > 0).  Key
// padding never enters the softmax: the loop stops at n_keys.  Query
// head h reads KV head h / G.  Blockwise online softmax in f32 with
// -1e30 masking and a max(l, 1e-30) denominator, as in _flash_kernel.
//
// Design: one thread block per (row, KV head, tile of kQTile query
// tokens) holds all G query heads of those tokens (kQTile * G rows of the
// score matrix), so a K/V tile read into shared memory serves every query
// head of the group; G need not be a power of two (smollm: 3).  K/V rows
// stream through shared memory kKeyTile at a time, 16 bytes per load, in
// the caller's (..., KV, hd) layout (the TPU op moved the head axis in
// front of the sequence on every call).  The block visits only the key
// range its rows can see — [first row's window start, last row's
// position] — so key tiles that the causal or window mask removes
// entirely are never loaded (the TPU grid visits and masks them).
// Scores, the softmax update and P.V run on CUDA cores in f32, bound by
// shared-memory traffic in the score and P.V loops.  This body serves
// head_dims other than 64 and 128 only (f32, bf16 and int8 pools); at
// those, bf16 runs on the tensor cores (prefill_mma.cuh) and f32 q (over
// f32, bf16 or int8 pools) in split TF32 (prefill_tf32.cuh).
//
// Rounding follows the reference: q * scale in q's type, (with
// kRoundScores) scores in the promoted q/K type before the f32 softmax,
// the probabilities rounded to the K/V type before the P.V product, the
// output in the K/V type (f32 for int8 pools, which compute in f32).

#pragma once

#include "../../csrc/common.cuh"

namespace kern {
namespace prefill {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeyTile = 32;  // keys per shared-memory tile (one per lane)

inline size_t smem_bytes(int q_tile, int G, int hd) {
  const int R = q_tile * G;  // score-matrix rows per block
  // q, acc: R*hd; K tile: kKeyTile*(hd+1); V tile: kKeyTile*hd;
  // probabilities: R*kKeyTile; m, l, correction: 3*R; key ranges: 2*R ints
  return sizeof(float) * (size_t)(2 * R * hd + kKeyTile * (hd + 1) +
                                  kKeyTile * hd + R * kKeyTile + 5 * R);
}

// The paged row policy (K2, K2q): query t of slot b at position
// lengths[b] + t, keys read through the slot's page table.
struct PagedRows {
  const int* page_table;  // (B, P)
  const int* lengths;     // (B,) tokens cached before this chunk
  int bs, P;
  static constexpr bool kRoundScores = false;
  __device__ int q_pos0(int b) const { return lengths[b]; }
  // keys past the page table do not exist (the reference's gather view
  // ends at P * bs)
  __device__ int n_keys(int) const { return P * bs; }
  __device__ size_t row(int b, int pos) const {
    return paged_row(page_table + (size_t)b * P, bs, pos);
  }
};

template <typename Tq, typename Tkv, typename Rows, typename Scales,
          int kQTile>
__global__ void __launch_bounds__(kThreads)
prefill_kernel(const Tq* __restrict__ q,    // (B, S, H, hd)
               const Tkv* __restrict__ k,   // slabs of (KV, hd), see Rows
               const Tkv* __restrict__ v,
               typename Compute<Tkv>::type* __restrict__ out,  // (B,S,H,hd)
               Rows rows, Scales scales, int S, int H, int KV, int hd,
               int causal, int window, float scale) {
  using Tv = typename Compute<Tkv>::type;
  using Ts = typename Promote<Tq, Tv>::type;
  extern __shared__ float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, t0 = blockIdx.z * kQTile;
  const int tid = threadIdx.x;
  const int G = H / KV, R = kQTile * G;
  const int ld = hd + 1;  // padded K row stride: lanes hit distinct banks
  float* q_s = smem;
  float* acc = q_s + R * hd;
  float* k_s = acc + R * hd;
  float* v_s = k_s + kKeyTile * ld;
  float* p_s = v_s + kKeyTile * hd;
  float* m_s = p_s + R * kKeyTile;
  float* l_s = m_s + R;
  float* c_s = l_s + R;
  int* lo_s = (int*)(c_s + R);
  int* hi_s = lo_s + R;

  const int n_tok = min(kQTile, S - t0);
  const int pos0 = rows.q_pos0(b) + t0;  // position of this tile's query 0
  const int n_keys = rows.n_keys(b);
  // row r = tq * G + g is query token t0 + tq of head kvh * G + g; it sees
  // keys lo_s[r] .. hi_s[r] (an empty range for padding rows past S)
  for (int r = tid; r < R; r += kThreads) {
    const int tq = r / G, pos = pos0 + tq;
    lo_s[r] = window > 0 ? max(0, pos - window + 1) : 0;
    hi_s[r] = tq >= n_tok ? -1 : (causal ? min(pos, n_keys - 1) : n_keys - 1);
    m_s[r] = kNeg;
    l_s[r] = 0.f;
  }
  const size_t q_row = (size_t)H * hd;  // elements per token of q / out
  for (int i = tid; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const int tq = r / G, g = r - tq * G;
    float x = 0.f;
    if (tq < n_tok)
      x = round_to<Tq>(
          to_f32(q[((size_t)b * S + t0 + tq) * q_row +
                   ((size_t)kvh * G + g) * hd + d]) * scale);
    q_s[i] = x;
    acc[i] = 0.f;
  }

  // keys any row of this block can see: from the first row's window
  // start to the last row's position (whole tiles outside are skipped)
  const int last = pos0 + n_tok - 1;
  const int k_lo = window > 0 ? max(0, pos0 - window + 1) : 0;
  const int k_hi = causal ? min(last, n_keys - 1) : n_keys - 1;
  const int warp = tid / 32, lane = tid % 32;
  __syncthreads();

  for (int k0 = k_lo; k0 <= k_hi; k0 += kKeyTile) {
    const int nk = min(kKeyTile, k_hi + 1 - k0);
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

    for (int i = tid; i < R * kKeyTile; i += kThreads) {
      const int r = i / kKeyTile, j = i - r * kKeyTile;
      const int kpos = k0 + j;
      float s = kNeg;
      if (j < nk && kpos >= lo_s[r] && kpos <= hi_s[r]) {
        const float* qr = q_s + r * hd;
        const float* kr = k_s + j * ld;
        s = 0.f;
        for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
        if (Rows::kRoundScores) s = round_to<Ts>(s);
      }
      p_s[i] = s;
    }
    __syncthreads();

    for (int r = warp; r < R; r += kWarps) {
      float* sr = p_s + r * kKeyTile;
      float mx = sr[lane];
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_s[r], mx);
      // a masked key adds exp(-1e30 - m_new) = 0 once the row has seen a
      // visible key; before that its terms are cleared by the correction
      // exp(-1e30 - m) = 0 that the first visible key brings
      const float p = expf(sr[lane] - m_new);
      sr[lane] = round_to<Tv>(p);
      float sum = p;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_s[r] - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    for (int i = tid; i < R * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      const float* pr = p_s + r * kKeyTile;
      float a = acc[i] * c_s[r];
      for (int j = 0; j < nk; ++j) a = fmaf(pr[j], v_s[j * hd + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const int tq = r / G, g = r - tq * G;
    if (tq < n_tok)
      out[((size_t)b * S + t0 + tq) * q_row + ((size_t)kvh * G + g) * hd +
          d] = from_f32<Tv>(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

// Launch one block per (row, KV head, kQTile query tokens); returns
// cudaGetLastError().
template <typename Tq, typename Tkv, int kQTile, typename Rows,
          typename Scales = NoScales>
int launch(const void* q, const void* k, const void* v, void* out, Rows rows,
           int B, int S, int H, int KV, int hd, int causal, int window,
           float scale, void* stream, Scales scales = Scales()) {
  using Tv = typename Compute<Tkv>::type;
  const size_t smem = smem_bytes(kQTile, H / KV, hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        prefill_kernel<Tq, Tkv, Rows, Scales, kQTile>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B, KV, (S + kQTile - 1) / kQTile);
  prefill_kernel<Tq, Tkv, Rows, Scales, kQTile>
      <<<grid, kThreads, smem, (cudaStream_t)stream>>>(
          (const Tq*)q, (const Tkv*)k, (const Tkv*)v, (Tv*)out, rows, scales,
          S, H, KV, hd, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace prefill
}  // namespace kern
