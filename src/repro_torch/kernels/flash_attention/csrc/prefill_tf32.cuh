// Blockwise attention of a chunk of query tokens over a row's K/V on
// Hopper's tensor cores in split TF32 (sm_90a): the f32 body of
// flash_prefill.cu (B2's contiguous entry), paged_prefill.cu (K2, f32 q
// over f32 or bf16 pools) and paged_prefill_quant.cu (K2q, f32 q over
// int8 pools with per-row f32 scales) at head_dim 64 and 128.  It takes
// the same row policy (q_pos0, n_keys, row, kRoundScores) and scales
// policy (NoScales, RowScales) as prefill_body.cuh and computes the same
// function: query t of row b sits at position q_pos0(b) + t and sees key
// kpos iff kpos < n_keys(b), kpos <= its position (causal) and kpos > its
// position - window (window > 0); query head h reads KV head h / G.
//
// Replaces, with prefill_body.cuh and prefill_mma.cuh,
// src/repro/kernels/flash_attention/kernel.py::flash_attention (body
// _flash_kernel).
//
// Design (prefill_mma.cuh's walk, TF32 products):
// - Packed GQA rows r = t * G + g, 64 to a block of 4 warps (16 a warp),
//   grid (B, KV, ceil(S * G / 64)), heaviest row blocks first; a block
//   visits only the key range its rows see; the masking branch runs only
//   in tiles a warp's rows do not all see whole; the masked-row rule of
//   prefill_mma.cuh (a row that has seen only masked keys takes p = 1
//   until its first visible key's correction clears it; keys past the
//   block's range are zero-filled).
// - Split TF32.  Each product is mma.sync.m16n8k8 tf32 with f32
//   accumulators; an f32 operand a is split a = hi + lo, hi = tf32(a),
//   lo = tf32(a - hi), and a product is Alo.Bhi + Ahi.Blo + Ahi.Bhi
//   (the dropped Alo.Blo is ~2^-22 of it): f32 accuracy, where one TF32
//   product (~2^-11) misses the 1e-5 tolerance.  bf16 and int8 values are
//   exact in TF32 and need no lo part: Q.K over a bf16 or int8 tile is
//   two products, P.V over bf16 one (P rounded to bf16 first, as the
//   reference rounds it).
// - Fragments in registers.  q * scale is read once into A fragments
//   (f32, split per tile).  The score accumulator of an 8-key group (keys
//   2c and 2c + 1 in thread column c) is the A fragment of P.V with the
//   group's keys taken in the order 0, 2, 4, 6, 1, 3, 5, 7, and V's B
//   fragments are read in that order: no shuffle, no shared round trip.
//   K and V fragments are read from their key-major tiles; rows carry a
//   16-byte pad, so the 8 rows x 4 columns a fragment load touches fall
//   in 32 distinct banks for f32, and in distinct words for bf16 / int8.
// - Asynchronous copies.  K/V tiles of kKeyTile = 32 keys move with
//   cp.async.cg in their own type (f32, bf16, int8: the int8 ring is a
//   quarter of the f32 bytes) into a ring of kStages stages, the next
//   tiles loading while the current one is multiplied.
// - int8 row scales are folded in, never a dequantized tile: each score
//   column is multiplied by its K row's scale after Q.K_int8, each
//   probability by its V row's scale before it is split for P.V.  This
//   rounds at other points than the reference's dequantize-then-dot
//   (one product per score and per probability, against one per
//   element); both stay within f32's 1e-5 of each other.
//
// What bounds it on the card: at B2 contiguous's S = 512 the operations
// (3 TF32 products per f32 product, ~6 GFLOP of tensor-core work at
// smollm heads) and the splitting and softmax between them on the CUDA
// cores; K2 at T = 32 is latency, as in prefill_mma.cuh.
//
// Rounding follows the reference, as in prefill_body.cuh: q * scale in
// f32; scores in f32 (the promoted q/K type is f32 for every entry of
// this body, so kRoundScores rounds nothing); probabilities rounded to
// the K/V type before P.V (bf16 pools) while the sum l takes them
// unrounded; -1e30 masking; the output acc / max(l, 1e-30) in the K/V
// type (f32 for int8 pools).  exp is 2^(x log2 e - m log2 e) on
// ex2.approx.ftz, as in prefill_mma.cuh.

#pragma once

#include <climits>
#include <type_traits>

#include "../../csrc/common.cuh"

namespace kern {
namespace prefill_tf32 {

constexpr int kKeyTile = 32;           // keys per K/V tile
constexpr int kWarps = 4;              // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;     // score rows per block, 16 a warp
constexpr float kLog2e = 1.4426950408889634f;

// x rounded to TF32 (10 explicit mantissa bits, to nearest), as f32 bits
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~2^-22 |x|, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a (16x8, row) . b (8x8, col), TF32 in, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// bytes of one ring stage: K and V tiles (rows of hd values and a 16-byte
// pad), then the tile's K and V row scales for int8 pools
template <typename Tkv, bool kQuant, int kHd>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * kKeyTile * (kHd * (int)sizeof(Tkv) + 16) +
         (kQuant ? 2 * kKeyTile * 4 : 0);
}

// q * scale stays in shared memory at head_dim 128 (64 rows x 132 f32,
// 33 KB) and is read a fragment at a time: in registers its 64 values a
// thread, with the output's 64, push the body past 255 registers into
// spills.  At head_dim 64 the 32 values a thread stay in registers.
template <int kHd>
__host__ __device__ constexpr bool q_in_smem() {
  return kHd > 64;
}

template <typename Tkv, bool kQuant, int kHd, int kStages>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)kStages * stage_bytes<Tkv, kQuant, kHd>() +
         (q_in_smem<kHd>() ? sizeof(float) * kRows * (kHd + 4) : 0);
}

// The register cap asked of the compiler, as blocks a SM: at head_dim 128
// at most 168 registers a thread (it would take 255; shared memory allows
// two blocks a SM either way), which measured faster
// (prefill_ablations.py, min1 / min3); at head_dim 64 no cap (~220
// registers, two blocks a SM), where 168 spills and measured slower.
template <int kHd>
struct Occupancy {
  static constexpr int kMinBlocks = kHd > 64 ? 3 : 1;
};

template <typename Tkv, typename Rows, typename Scales, int kHd, int kStages>
__global__ void __launch_bounds__(kThreads, Occupancy<kHd>::kMinBlocks)
prefill_tf32_kernel(const float* __restrict__ q,  // (B, S, H, hd)
                    const Tkv* __restrict__ k,    // slabs of (KV, hd)
                    const Tkv* __restrict__ v,
                    typename Compute<Tkv>::type* __restrict__ out,
                    Rows rows, Scales scales, int S, int H, int KV,
                    int causal, int window, float scale) {
  using Tv = typename Compute<Tkv>::type;
  // f32 K/V need a lo part; bf16 and int8 values are exact in TF32.  P
  // needs one unless it is rounded to bf16 (bf16 pools)
  constexpr bool kSplitKv = std::is_same<Tkv, float>::value;
  constexpr bool kSplitP = !std::is_same<Tkv, __nv_bfloat16>::value;
  constexpr int kLd = kHd * (int)sizeof(Tkv) + 16;  // shared row, bytes
  constexpr int kLdE = kLd / (int)sizeof(Tkv);      // the same, elements
  constexpr int kChunks = kHd * (int)sizeof(Tkv) / 16;
  constexpr int kTileBytes = kKeyTile * kLd;
  constexpr int kStage = stage_bytes<Tkv, Scales::kQuant, kHd>();
  constexpr int kLoads = kKeyTile * kChunks / kThreads;
  static_assert(kHd % 8 == 0 && kStages >= 2, "bad tile");
  static_assert(kLoads * kThreads == kKeyTile * kChunks, "uneven loads");
  extern __shared__ __align__(16) unsigned char smem_raw[];

  // row blocks in reverse: under a causal mask the last rows see the most
  // keys, and their blocks start first
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tc = lane % 4;  // fragment row group, column
  const int G = H / KV;
  const int pos0 = rows.q_pos0(b), n_keys = rows.n_keys(b);
  const size_t q_row = (size_t)H * kHd;  // elements per token of q / out

  // the keys any row of this block sees
  const int t_first = r0 / G;
  const int t_last = min((r0 + kRows - 1) / G, S - 1);
  const int k_lo = window > 0 ? max(0, pos0 + t_first - window + 1) : 0;
  const int k_hi = causal ? min(pos0 + t_last, n_keys - 1) : n_keys - 1;
  const int n_tiles = k_hi >= k_lo ? (k_hi - k_lo) / kKeyTile + 1 : 0;

  auto load_tile = [&](int tile, int stage) {
    const int k0 = k_lo + tile * kKeyTile;
    unsigned char* ks = smem_raw + stage * kStage;
    unsigned char* vs = ks + kTileBytes;
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int i = tid + it * kThreads;
      const int j = i / kChunks, c = i - j * kChunks;
      const bool in = k0 + j <= k_hi;
      const size_t off = in ? (rows.row(b, k0 + j) * KV + kvh) * kHd +
                                  c * (16 / sizeof(Tkv))
                            : 0;
      cp_async16(smem_addr(ks + j * kLd + c * 16), k + off, in);
      cp_async16(smem_addr(vs + j * kLd + c * 16), v + off, in);
    }
    if constexpr (Scales::kQuant) {
      // threads 0..31 the K scales of the tile's keys, 32..63 the V ones
      if (tid < 2 * kKeyTile) {
        const int j = tid % kKeyTile;
        const bool in = k0 + j <= k_hi;
        const size_t slab = in ? rows.row(b, k0 + j) * KV + kvh : 0;
        cp_async4(smem_addr(vs + kTileBytes + 4 * tid),
                  (tid < kKeyTile ? scales.ks : scales.vs) + slab, in);
      }
    }
  };

  // this thread's two rows: gr and gr + 8 of the warp's 16.  Rows past
  // S * G see everything (their output is dropped) and do not narrow the
  // warp's fully visible key range [warp_lo, warp_hi]
  int lo[2], hi[2];
  const float* q_ptr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rg = r0 + warp * 16 + gr + 8 * h;
    const int t = rg / G, pos = pos0 + t;
    lo[h] = t < S && window > 0 ? max(0, pos - window + 1) : 0;
    hi[h] = t >= S ? INT_MAX : causal ? min(pos, n_keys - 1) : n_keys - 1;
    q_ptr[h] = t < S ? q + ((size_t)b * S + t) * q_row +
                           ((size_t)kvh * G + rg - t * G) * kHd
                     : nullptr;
  }
  const int warp_lo = __reduce_max_sync(0xffffffffu, max(lo[0], lo[1]));
  const int warp_hi = __reduce_min_sync(0xffffffffu, min(hi[0], hi[1]));
  const bool warp_active = (r0 + warp * 16) / G < S;

  // the first tiles load while q is read
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }

  // A fragments of q * scale (f32): element e of step kk is row
  // gr + 8 * (e % 2), column kk * 8 + tc + 4 * (e / 2); in registers, or
  // (q_in_smem) staged in shared memory at row stride hd + 4 (the 8 rows
  // x 4 columns of a fragment read fall in 32 distinct banks)
  constexpr bool kQShared = q_in_smem<kHd>();
  constexpr int kQLd = kHd + 4;
  float* q_s = reinterpret_cast<float*>(smem_raw + kStages * kStage);
  float qf[kQShared ? 1 : kHd / 8][4];
  if constexpr (kQShared) {
    for (int i = tid; i < kRows * kHd / 4; i += kThreads) {
      const int r = i / (kHd / 4), c = (i - r * (kHd / 4)) * 4;
      const int rg = r0 + r, t = rg / G;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < S)
        x = *reinterpret_cast<const float4*>(
            q + ((size_t)b * S + t) * q_row +
            ((size_t)kvh * G + rg - t * G) * kHd + c);
      *reinterpret_cast<float4*>(q_s + r * kQLd + c) =
          make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale),
                      __fmul_rn(x.z, scale), __fmul_rn(x.w, scale));
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < kHd / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* p = q_ptr[e % 2];
        qf[kk][e] = p ? __fmul_rn(p[kk * 8 + tc + 4 * (e / 2)], scale) : 0.f;
      }
  }
  const float* q_frag = q_s + (warp * 16 + gr) * kQLd + tc;

  float o[kHd / 8][4];  // output accumulators: hd columns in 8-wide tiles
#pragma unroll
  for (int n = 0; n < kHd / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // per row: running max m, m * log2 e, running sum l
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float ml[2] = {__fmul_rn(kNeg, kLog2e), __fmul_rn(kNeg, kLog2e)};

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile it
    __syncthreads();  // everyone's; and the stage refilled next is free
    if (it + kStages - 1 < n_tiles)
      load_tile(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    if (!warp_active) continue;
    const unsigned char* stage = smem_raw + (it % kStages) * kStage;
    const Tkv* ks = reinterpret_cast<const Tkv*>(stage);
    const Tkv* vs = reinterpret_cast<const Tkv*>(stage + kTileBytes);
    const float* k_scale =
        reinterpret_cast<const float*>(stage + 2 * kTileBytes);
    const float* v_scale = k_scale + kKeyTile;
    const int k0 = k_lo + it * kKeyTile;

    // S = Q K^T: 16 rows x 32 keys in 4 accumulator tiles of 8 keys;
    // accumulator (n, e) is row gr + 8 * (e / 2), key k0 + n * 8 + 2 * tc
    // + e % 2.  The small products go first
    float s[kKeyTile / 8][4];
#pragma unroll
    for (int n = 0; n < kKeyTile / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHd / 8; ++kk) {
      uint32_t qh[4], ql[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x;
        if constexpr (kQShared)
          x = q_frag[8 * (e % 2) * kQLd + kk * 8 + 4 * (e / 2)];
        else
          x = qf[kk][e];
        split_tf32(x, qh[e], ql[e]);
      }
#pragma unroll
      for (int n = 0; n < kKeyTile / 8; ++n) {
        // B fragment: key n * 8 + gr, hd kk * 8 + tc and + 4
        const Tkv* kr = ks + (n * 8 + gr) * kLdE + kk * 8 + tc;
        const float kb0 = to_f32(kr[0]), kb1 = to_f32(kr[4]);
        if constexpr (kSplitKv) {
          uint32_t kh0, kl0, kh1, kl1;
          split_tf32(kb0, kh0, kl0);
          split_tf32(kb1, kh1, kl1);
          mma_tf32(s[n], ql, kh0, kh1);
          mma_tf32(s[n], qh, kl0, kl1);
          mma_tf32(s[n], qh, kh0, kh1);
        } else {
          mma_tf32(s[n], ql, __float_as_uint(kb0), __float_as_uint(kb1));
          mma_tf32(s[n], qh, __float_as_uint(kb0), __float_as_uint(kb1));
        }
      }
    }
    if constexpr (Scales::kQuant) {
#pragma unroll
      for (int n = 0; n < kKeyTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = s[n][e] * k_scale[n * 8 + 2 * tc + e % 2];
    }

    if (k0 < warp_lo || k0 + kKeyTile - 1 > warp_hi) {
      // key k0 + c + 2 * tc, c = n * 8 + e % 2, is masked for a row iff
      // c < lo - k0 - 2 * tc or c > hi - k0 - 2 * tc
      int c_lo[2], c_hi[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        c_lo[h] = lo[h] - k0 - 2 * tc;
        c_hi[h] = hi[h] == INT_MAX ? INT_MAX : hi[h] - k0 - 2 * tc;
      }
#pragma unroll
      for (int n = 0; n < kKeyTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + e % 2;
          if (c < c_lo[e / 2] || c > c_hi[e / 2]) s[n][e] = kNeg;
        }
    }

    // online softmax in f32, one row pair per thread quad (as in
    // prefill_mma.cuh: each product of the exp2 fold rounded on its own)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kKeyTile / 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mxl = __fmul_rn(mx[h], kLog2e);
      corr[h] = exp2_ftz(ml[h] - mxl);
      m[h] = mx[h];
      ml[h] = mxl;
    }
    // P as A fragments: for key group n, a0/a1 are rows gr/gr + 8 at key
    // 2 * tc, a2/a3 the same rows at key 2 * tc + 1 (the group's keys in
    // the order 0, 2, 4, 6, 1, 3, 5, 7); rounded to the K/V type, times
    // the V row scale for int8 pools
    float pf[kKeyTile / 8][4];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kKeyTile / 8; ++n) {
      const float p0 = exp2_ftz(__fmul_rn(s[n][0], kLog2e) - ml[0]);
      const float p1 = exp2_ftz(__fmul_rn(s[n][1], kLog2e) - ml[0]);
      const float p2 = exp2_ftz(__fmul_rn(s[n][2], kLog2e) - ml[1]);
      const float p3 = exp2_ftz(__fmul_rn(s[n][3], kLog2e) - ml[1]);
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      pf[n][0] = round_to<Tv>(p0);
      pf[n][1] = round_to<Tv>(p2);
      pf[n][2] = round_to<Tv>(p1);
      pf[n][3] = round_to<Tv>(p3);
      if constexpr (Scales::kQuant) {
        const float sv0 = v_scale[n * 8 + 2 * tc];
        const float sv1 = v_scale[n * 8 + 2 * tc + 1];
        pf[n][0] = pf[n][0] * sv0;
        pf[n][1] = pf[n][1] * sv0;
        pf[n][2] = pf[n][2] * sv1;
        pf[n][3] = pf[n][3] * sv1;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * corr[h] + sum[h];
    }
    // (once the running max settles, most tiles change no row's max)
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < kHd / 8; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
    }

    // O += P V: B fragments at keys kk * 8 + 2 * tc (b0) and + 1 (b1),
    // hd column n * 8 + gr
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 8; ++kk) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kSplitP)
          split_tf32(pf[kk][e], ph[e], pl[e]);
        else
          ph[e] = __float_as_uint(pf[kk][e]);
      }
#pragma unroll
      for (int n = 0; n < kHd / 8; ++n) {
        const Tkv* vr = vs + (kk * 8 + 2 * tc) * kLdE + n * 8 + gr;
        const float vb0 = to_f32(vr[0]), vb1 = to_f32(vr[kLdE]);
        if constexpr (kSplitKv) {
          uint32_t vh0, vl0, vh1, vl1;
          split_tf32(vb0, vh0, vl0);
          split_tf32(vb1, vh1, vl1);
          mma_tf32(o[n], pl, vh0, vh1);
          mma_tf32(o[n], ph, vl0, vl1);
          mma_tf32(o[n], ph, vh0, vh1);
        } else if constexpr (kSplitP) {
          mma_tf32(o[n], pl, __float_as_uint(vb0), __float_as_uint(vb1));
          mma_tf32(o[n], ph, __float_as_uint(vb0), __float_as_uint(vb1));
        } else {
          mma_tf32(o[n], ph, __float_as_uint(vb0), __float_as_uint(vb1));
        }
      }
    }
  }

  // epilogue: normalize and store each row's pairs straight from the
  // accumulators (accumulator (n, e): column n * 8 + 2 * tc + e % 2)
  cp_async_wait<0>();
  if (!warp_active) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!q_ptr[h]) continue;
    const int rg = r0 + warp * 16 + gr + 8 * h, t = rg / G;
    Tv* orow = out + ((size_t)b * S + t) * q_row +
               ((size_t)kvh * G + rg - t * G) * kHd + 2 * tc;
    const float den = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < kHd / 8; ++n)
      store_pair(orow + n * 8, o[n][2 * h] / den, o[n][2 * h + 1] / den);
  }
}

template <typename Tkv, typename Rows, typename Scales, int kHd, int kStages>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              Rows rows, int B, int S, int H, int KV, int causal, int window,
              float scale, void* stream, Scales scales) {
  using Tv = typename Compute<Tkv>::type;
  constexpr size_t smem = smem_bytes<Tkv, Scales::kQuant, kHd, kStages>();
  auto kernel = prefill_tf32_kernel<Tkv, Rows, Scales, kHd, kStages>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B, KV, (S * (H / KV) + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const Tkv*)k, (const Tkv*)v, (Tv*)out, rows, scales,
      S, H, KV, causal, window, scale);
  return (int)cudaGetLastError();
}

// f32 q over f32, bf16 or int8 (with RowScales) K/V; head_dim 64 (a ring
// of 3 stages: 51 KB of shared memory for f32 tiles) or 128 (2 stages,
// 66 KB, and q's 33 KB); any other head_dim is refused
// (cudaErrorInvalidValue), the wrappers never send one.
template <typename Tkv, typename Rows, typename Scales = NoScales>
int launch(const void* q, const void* k, const void* v, void* out, Rows rows,
           int B, int S, int H, int KV, int hd, int causal, int window,
           float scale, void* stream, Scales scales = Scales()) {
  if (hd == 64)
    return launch_hd<Tkv, Rows, Scales, 64, 3>(q, k, v, out, rows, B, S, H,
                                               KV, causal, window, scale,
                                               stream, scales);
  if (hd == 128)
    return launch_hd<Tkv, Rows, Scales, 128, 2>(q, k, v, out, rows, B, S, H,
                                                KV, causal, window, scale,
                                                stream, scales);
  return (int)cudaErrorInvalidValue;
}

}  // namespace prefill_tf32
}  // namespace kern
