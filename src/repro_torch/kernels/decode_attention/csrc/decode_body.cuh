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
// pools).  Query head h reads KV head h / G; softmax with an online
// (m, l, acc) in f32, the reference's -1e30 masking and a max(l, 1e-30)
// denominator.
//
// What bounds it on the card: bytes.  Every valid key costs one K row and
// one V row of hd elements, against 2 * G * hd multiply-adds for the G
// query heads of its KV head: a few operations per byte, far below the
// H100's ~295 bf16 operations per byte of device memory.  At the served
// shapes (~300-550 keys a row, B = 8) the bytes take ~1-2 us, so what
// sets the time is how many loads are in flight and how long each block's
// chain of dependent steps is.  The design:
//   * one thread block per (row, KV head, split of the key range) holds
//     all G query heads of that KV head, so each K/V row leaves device
//     memory once per group; the split spreads a row's keys over
//     n_split blocks (the host picks split_keys and n_split from shapes
//     alone: ops.py's split_plan), so B * KV * n_split blocks load at once
//     instead of B * KV walking their keys one tile after another;
//   * K/V tiles of kKeyTile = 32 keys move with cp.async into a ring of
//     kStages stages in their own type (f32, bf16, int8), read in the
//     caller's (..., KV, hd) layout; the first tiles are in flight before
//     q is staged;
//   * one lane per key: a warp computes its row's 32 scores (16-byte
//     reads of the padded key-major tile, conflict-free per quarter
//     warp), their max, exps and sum in registers, with no block barrier
//     between scores and softmax; P.V reads the probabilities back from
//     shared memory (two barriers a tile);
//   * int8 row scales are folded in, never a dequantized tile: the score
//     of a key is multiplied by its K scale after q.k_int8, its
//     probability by its V scale before P.V;
//   * a split writes its (m, l, acc) to a workspace in f32; the last block
//     of a (row, KV head) to finish, told by an atomic counter per pair
//     (reset to 0 by that block), combines the n_split partials in split
//     order, so the result is the same bits from run to run, in the same
//     launch (no second kernel, no host work).  A split past the row's
//     keys writes an empty partial (m = -1e30, l = 0).  With one split
//     the block writes the output itself.
//
// Rounding follows the reference: q * scale in q's type, (with
// kRoundScores) scores in the promoted q/K type, the probabilities
// rounded to the K/V type before the P.V product (relative to the
// split's running max), the output in the K/V type (f32 for int8 pools,
// which compute in f32).  A row with no keys outputs 0, as before the
// split.

#pragma once

#include "../../csrc/common.cuh"

namespace kern {
namespace decode {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeyTile = 32;  // keys per tile: one per lane
constexpr int kStages = 3;

// bytes of one ring stage: K and V tiles (rows of hd values and a 16-byte
// pad), then the tile's K and V row scales for int8 pools
__host__ __device__ inline int stage_bytes(int hd, int elt, bool quant) {
  return 2 * kKeyTile * (hd * elt + 16) + (quant ? 2 * kKeyTile * 4 : 0);
}

inline size_t smem_bytes(int G, int hd, int elt, bool quant) {
  // the ring; q, acc: G*hd; probabilities: G*kKeyTile; m, l, correction:
  // 3*G; the last-block flag
  return (size_t)kStages * stage_bytes(hd, elt, quant) +
         sizeof(float) * (size_t)(2 * G * hd + G * kKeyTile + 3 * G) +
         sizeof(int);
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
              Rows rows, Scales scales, int H, int KV, int hd, float scale,
              int split_keys,
              float* __restrict__ ws,  // (B*KV, n_split, G*(hd+2)) partials
              int* __restrict__ counters) {  // (B*KV,) zero between calls
  using Tv = typename Compute<Tkv>::type;
  using Ts = typename Promote<Tq, Tv>::type;
  constexpr int N = Chunk<Tkv>::N;  // values per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = H / KV;
  const int ld = hd * (int)sizeof(Tkv) + 16;  // shared row stride, bytes
  const int tile_bytes = kKeyTile * ld;
  const int stage = stage_bytes(hd, (int)sizeof(Tkv), Scales::kQuant);
  float* q_s = reinterpret_cast<float*>(smem + kStages * stage);
  float* acc = q_s + G * hd;
  float* p_s = acc + G * hd;
  float* m_s = p_s + G * kKeyTile;
  float* l_s = m_s + G;
  float* c_s = l_s + G;
  int* last_s = reinterpret_cast<int*>(c_s + G);

  const int n_keys = rows.n_keys(b);
  const int k_begin = split * split_keys;
  const int k_end = min(n_keys, k_begin + split_keys);
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kKeyTile - 1) / kKeyTile : 0;
  const int cpr = hd * (int)sizeof(Tkv) / 16;  // chunks per row

  auto load_tile = [&](int tile, int st) {
    const int k0 = k_begin + tile * kKeyTile;
    unsigned char* ks = smem + st * stage;
    unsigned char* vs = ks + tile_bytes;
    for (int i = tid; i < kKeyTile * cpr; i += kThreads) {
      const int j = i / cpr, c = i - j * cpr;
      const bool in = k0 + j < k_end;
      const size_t off = in ? (rows.row(b, k0 + j) * KV + kvh) * hd + c * N
                            : 0;
      cp_async16(smem_addr(ks + j * ld + c * 16), k + off, in);
      cp_async16(smem_addr(vs + j * ld + c * 16), v + off, in);
    }
    if constexpr (Scales::kQuant) {
      // threads 0..31 the K scales of the tile's keys, 32..63 the V ones
      if (tid < 2 * kKeyTile) {
        const int j = tid % kKeyTile;
        const bool in = k0 + j < k_end;
        const size_t slab = in ? rows.row(b, k0 + j) * KV + kvh : 0;
        cp_async4(smem_addr(vs + tile_bytes + 4 * tid),
                  (tid < kKeyTile ? scales.ks : scales.vs) + slab, in);
      }
    }
  };

  // the first tiles load while q is staged
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }
  const size_t q_base = ((size_t)b * H + (size_t)kvh * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    q_s[i] = round_to<Tq>(to_f32(q[q_base + i]) * scale);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNeg;
    l_s[g] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile it
    __syncthreads();  // everyone's; the stage refilled next, p_s, acc free
    if (it + kStages - 1 < n_tiles)
      load_tile(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    const unsigned char* ks = smem + (it % kStages) * stage;
    const unsigned char* vs = ks + tile_bytes;
    const float* k_scale = reinterpret_cast<const float*>(vs + tile_bytes);
    const float* v_scale = k_scale + kKeyTile;
    const int nk = min(kKeyTile, k_end - (k_begin + it * kKeyTile));

    // scores and softmax: warp w takes rows w, w + kWarps, ...; lane j
    // key j of the tile.  Only this warp touches its rows' m, l, c
    for (int g = warp; g < G; g += kWarps) {
      float s = kNeg;
      if (lane < nk) {
        const Tkv* kr = reinterpret_cast<const Tkv*>(ks + lane * ld);
        const float* qr = q_s + g * hd;
        s = 0.f;
        for (int d = 0; d < hd; d += N) {
          float kf[N];
          Chunk<Tkv>::load(kr + d, kf);
#pragma unroll
          for (int e = 0; e < N; ++e) s = fmaf(qr[d + e], kf[e], s);
        }
        if constexpr (Scales::kQuant) s = s * k_scale[lane];
        if (Rows::kRoundScores) s = round_to<Ts>(s);
      }
      float mx = s;
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      // keys past nk: exp(-1e30 - m_new) = 0 (every tile has a key)
      const float p = expf(s - m_new);
      float sum = p;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      float pv = round_to<Tv>(p);
      if constexpr (Scales::kQuant) pv = pv * v_scale[lane];
      p_s[g * kKeyTile + lane] = pv;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
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
      for (int j = 0; j < nk; ++j)
        a = fmaf(pr[j], to_f32(reinterpret_cast<const Tkv*>(vs + j * ld)[d]),
                 a);
      acc[i] = a;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // acc, m_s, l_s final (and q_s, m_s set: no tiles)

  if (n_split == 1) {
    for (int i = tid; i < G * hd; i += kThreads)
      out[q_base + i] = from_f32<Tv>(acc[i] / fmaxf(l_s[i / hd], 1e-30f));
    return;
  }

  // this split's partial: m[G], l[G], acc[G*hd]
  const size_t pair = (size_t)b * KV + kvh;
  const int rec = G * (hd + 2);
  float* part = ws + (pair * n_split + split) * rec;
  for (int g = tid; g < G; g += kThreads) {
    part[g] = m_s[g];
    part[G + g] = l_s[g];
  }
  for (int i = tid; i < G * hd; i += kThreads) part[2 * G + i] = acc[i];
  __threadfence();  // the partial is visible before the count says so
  __syncthreads();
  if (tid == 0) *last_s = atomicAdd(counters + pair, 1) == n_split - 1;
  __syncthreads();
  if (!*last_s) return;
  __threadfence();

  // the last block: out = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30),
  // w_s = exp(m_s - max_s m_s), summed in split order
  const float* first = ws + pair * n_split * rec;
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd;
    float mmax = kNeg;
    for (int s = 0; s < n_split; ++s)
      mmax = fmaxf(mmax, __ldcg(first + s * rec + g));
    float o = 0.f, den = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* ps = first + s * rec;
      const float w = expf(__ldcg(ps + g) - mmax);
      den = fmaf(w, __ldcg(ps + G + g), den);
      o = fmaf(w, __ldcg(ps + 2 * G + i), o);
    }
    out[q_base + i] = from_f32<Tv>(o / fmaxf(den, 1e-30f));
  }
  if (tid == 0) counters[pair] = 0;  // ready for the next call
}

// Launch (B, KV, n_split) blocks, split_keys keys a split (a multiple of
// kKeyTile); ws holds B*KV*n_split*G*(hd+2) floats and counters B*KV
// zeroed ints when n_split > 1.  Returns cudaGetLastError().
template <typename Tq, typename Tkv, typename Rows,
          typename Scales = NoScales>
int launch(const void* q, const void* k, const void* v, void* out, Rows rows,
           int B, int H, int KV, int hd, float scale, int split_keys,
           int n_split, void* ws, void* counters, void* stream,
           Scales scales = Scales()) {
  using Tv = typename Compute<Tkv>::type;
  if (split_keys < kKeyTile || split_keys % kKeyTile || n_split < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      smem_bytes(H / KV, hd, (int)sizeof(Tkv), Scales::kQuant);
  auto kernel = decode_kernel<Tq, Tkv, Rows, Scales>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(B, KV, n_split), kThreads, smem, (cudaStream_t)stream>>>(
      (const Tq*)q, (const Tkv*)k, (const Tkv*)v, (Tv*)out, rows, scales, H,
      KV, hd, scale, split_keys, (float*)ws, (int*)counters);
  return (int)cudaGetLastError();
}

}  // namespace decode
}  // namespace kern
