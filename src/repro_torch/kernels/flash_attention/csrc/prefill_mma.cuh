// Blockwise attention of a chunk of query tokens over a row's K/V on
// Hopper's tensor cores (sm_90a): the bf16 body of paged_prefill.cu (K2)
// and flash_prefill.cu (B2's contiguous entry) at head_dim 64 and 128.
// It takes the same row policy as prefill_body.cuh (q_pos0, n_keys, row,
// kRoundScores), so the paged and contiguous entries plug in unchanged,
// and computes the same function: query t of row b sits at position
// q_pos0(b) + t and sees key kpos iff kpos < n_keys(b), kpos <= its
// position (causal) and kpos > its position - window (window > 0); query
// head h reads KV head h / G.  The f32 entries, K2q and bf16 at any other
// head_dim stay on prefill_body.cuh.
//
// Replaces, with prefill_body.cuh, src/repro/kernels/flash_attention/
// kernel.py::flash_attention (body _flash_kernel).
//
// Design (FlashAttention-2 on mma.sync):
// - Packed GQA rows.  Row r = t * G + g of a (row b, KV head) is query
//   token t of head kvh * G + g.  A block of 4 warps takes 64 consecutive
//   rows, all G heads of the tokens they hold, so each K/V tile it loads
//   serves every query head of the group.  Grid (B, KV, ceil(S * G / 64)),
//   row blocks walked from the last (under a causal mask the last rows
//   see the most keys, so the longest blocks start first).  K2 at
//   smollm-360m's heads (G = 3, T = 32: 96 rows per slot and KV head) runs
//   2 blocks per pair, 80 blocks at B = 8 on the 132 SMs, at jamba's
//   (G = 4) 128; B2
//   contiguous at B = 8, S = 512 runs 960 (smollm) and 2048 (jamba)
//   blocks, 3 (hd 64) or 2 (hd 128) per SM by registers.
// - Tensor cores.  Each warp owns 16 score rows.  S = Q.K^T and
//   O += P.V are mma.sync.m16n8k16 bf16 products with f32 accumulators.
//   Q (times the scale, rounded to bf16) is staged once through shared
//   memory and held in registers as A fragments (ldmatrix); K fragments
//   come by ldmatrix, V fragments by ldmatrix.trans.  P is the score accumulator repacked to bf16 in
//   registers (the m16n8 accumulator layout is the m16k16 A layout): no
//   shared-memory round trip.  The running max, sum and correction stay in
//   registers, one row pair per thread, reduced over the thread quad that
//   shares a row with __shfl_xor_sync.
// - Asynchronous copies.  K/V tiles of kKeyTile = 64 keys move with
//   cp.async.cg, 16 bytes a thread, into a ring of kStages stages, so the
//   next tiles load while the current one is multiplied; the first tiles
//   are in flight before q is staged.  They stay bf16.  Shared rows carry
//   a 16-byte pad (stride hd + 8), so the 8 rows an ldmatrix reads start
//   in 8 distinct bank quads: no bank conflicts at 128-byte (hd 64) and
//   256-byte (hd 128) rows.  Keys past the block's range are zero-filled
//   (src-size 0), so a masked key's V row is 0.
// - Paged addresses.  Each 16-byte chunk's source comes from the row
//   policy (paged_row through the page table for K2): a 64-key tile is
//   four 16-row pages, each row at stride KV * hd of the (nb, bs, KV, hd)
//   pool, read in place.
// - Skipped tiles.  A block visits only [first row's window start, last
//   row's position]; key tiles outside are never loaded.  A warp takes
//   the masking branch only in tiles its rows do not all see whole (the
//   diagonal, window edges and the ragged end).
//
// What bounds it on the card (H100; chip_smoke.py phase 3 and
// prefill_ablations.py): K2 at T = 32 is latency: ~0.3 GFLOP over ~4 MB
// of K/V, and the longest slot's block walks ~10 key tiles one after the
// other.  B2 contiguous at S = 512 is the math, not the bytes: the per-
// tile softmax between the two products (rounding, masking, exp, max and
// sum of every score) keeps the tensor cores waiting, and the math alone
// takes nearly the kernel's time while the copies overlap it.  Only
// wgmma reaches the card's full tensor-core rate.
//
// Rounding follows the reference, as in prefill_body.cuh: q * scale
// rounded to bf16; scores accumulated in f32 and, with kRoundScores,
// rounded to bf16 before the f32 softmax (-1e30 masking; a row's masked
// keys before its first visible one are cleared by the correction
// exp(-1e30 - m) = 0 that key brings); probabilities rounded to bf16 for
// the P.V product while the sum l takes them unrounded; the output
// acc / max(l, 1e-30) rounded to bf16.  exp(x - m) is computed as
// 2^(x log2 e - m log2 e) with each product rounded on its own and
// ex2.approx.ftz (about 2 ulp of f32, far below a bf16 ulp).
//
// Later work: wgmma and TMA.  wgmma needs 64-row warpgroup tiles and a
// swizzled shared-memory B operand; TMA needs a tensor map per pool and a
// box per page.  Both are the next step for this body, now that its
// numbers show the mma.sync loop, not the copies, setting B2's time; with
// them, warp specialization (a producer warp, consumer warpgroups).  A
// split of long key ranges over blocks (with a combine pass) likewise.

#pragma once

#include <climits>

#include "../../csrc/common.cuh"

namespace kern {
namespace prefill_mma {

using bf16 = __nv_bfloat16;

constexpr int kKeyTile = 64;  // keys per K/V tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !pred
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// both values rounded to bf16 (one pack instruction for the pair)
__device__ __forceinline__ void round_pair(float& a, float& b) {
  const uint32_t p = pack_bf16(a, b);
  a = __uint_as_float(p << 16);
  b = __uint_as_float(p & 0xffff0000u);
}

// 2^x on the special-function unit; a result below 2^-126 flushes to 0
// (a probability that small is lost beside the row's largest, which is
// 1).  2^0 is exactly 1.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int kHd, int kStages>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * 2 * kStages * kKeyTile * (kHd + 8);
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;              // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;     // score rows per block, 16 a warp

template <typename Rows, int kHd, int kStages>
__global__ void __launch_bounds__(kThreads)
prefill_mma_kernel(const bf16* __restrict__ q,  // (B, S, H, hd)
                   const bf16* __restrict__ k,  // slabs of (KV, hd), see Rows
                   const bf16* __restrict__ v,
                   bf16* __restrict__ out,      // (B, S, H, hd)
                   Rows rows, int S, int H, int KV, int causal, int window,
                   float scale) {
  constexpr int kLd = kHd + 8;        // shared row stride: 16-byte pad
  constexpr int kChunks = kHd / 8;    // 16-byte chunks per row
  constexpr int kTile = kKeyTile * kLd;
  constexpr int kLoads = kKeyTile * kChunks / kThreads;
  constexpr int kQLoads = kRows * kChunks / kThreads;
  static_assert(kHd % 16 == 0 && kStages >= 2, "bad tile");
  static_assert(kLoads * kThreads == kKeyTile * kChunks &&
                    kQLoads * kThreads == kRows * kChunks,
                "uneven loads");
  static_assert(kRows <= 2 * kKeyTile, "q must fit one ring stage");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // stage s: K, then V

  // row blocks in reverse: under a causal mask the last rows see the most
  // keys, and their blocks start first
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = H / KV;
  const int pos0 = rows.q_pos0(b), n_keys = rows.n_keys(b);
  const size_t q_row = (size_t)H * kHd;  // elements per token of q / out

  // the keys any row of this block sees: from the first row's window
  // start to the last row's position
  const int t_first = r0 / G;
  const int t_last = min((r0 + kRows - 1) / G, S - 1);
  const int k_lo = window > 0 ? max(0, pos0 + t_first - window + 1) : 0;
  const int k_hi = causal ? min(pos0 + t_last, n_keys - 1) : n_keys - 1;
  const int n_tiles = k_hi >= k_lo ? (k_hi - k_lo) / kKeyTile + 1 : 0;

  auto load_tile = [&](int tile, int stage) {
    const int k0 = k_lo + tile * kKeyTile;
    bf16* ks = ring + 2 * stage * kTile;
    bf16* vs = ks + kTile;
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int i = tid + it * kThreads;
      const int j = i / kChunks, c = i - j * kChunks;
      const bool in = k0 + j <= k_hi;
      const size_t off =
          in ? (rows.row(b, k0 + j) * KV + kvh) * kHd + c * 8 : 0;
      cp_async16(smem_addr(ks + j * kLd + c * 8), k + off, in);
      cp_async16(smem_addr(vs + j * kLd + c * 8), v + off, in);
    }
  };

  // this thread's two rows: quad row lane / 4 of the warp's 16 and the
  // one 8 below it.  Rows past S * G see everything (their output is
  // dropped) and do not narrow the warp's fully visible key range
  // [warp_lo, warp_hi].
  int lo[2], hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = (r0 + warp * 16 + lane / 4 + 8 * h) / G;
    const int pos = pos0 + t;
    lo[h] = t < S && window > 0 ? max(0, pos - window + 1) : 0;
    hi[h] = t >= S ? INT_MAX : causal ? min(pos, n_keys - 1) : n_keys - 1;
  }
  const int warp_lo = __reduce_max_sync(0xffffffffu, max(lo[0], lo[1]));
  const int warp_hi = __reduce_min_sync(0xffffffffu, min(hi[0], hi[1]));
  const bool warp_active = (r0 + warp * 16) / G < S;

  // the first tiles load while q is staged
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }

  // q * scale, rounded to bf16, in the last stage until the first tile
  // lands there (rows past S * G are zero); all loads in flight at once
  bf16* q_s = ring + 2 * (kStages - 1) * kTile;
  uint4 raw[kQLoads];
#pragma unroll
  for (int it = 0; it < kQLoads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kChunks, c = i - r * kChunks;
    const int rg = r0 + r, t = rg / G, g = rg - t * G;
    raw[it] = t < S ? *reinterpret_cast<const uint4*>(
                          q + ((size_t)b * S + t) * q_row +
                          ((size_t)kvh * G + g) * kHd + c * 8)
                    : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int it = 0; it < kQLoads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kChunks, c = i - r * kChunks;
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[it]);
    uint4 packed;
    uint32_t* o = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      o[e] = pack_bf16(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(q_s + r * kLd + c * 8) = packed;
  }
  __syncthreads();  // q_s written

  uint32_t qf[kHd / 16][4];  // A fragments of this warp's 16 rows of q
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk)
    ldmatrix_x4(smem_addr(q_s + (warp * 16 + lane % 16) * kLd + kk * 16 +
                          (lane / 16) * 8),
                qf[kk]);

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
    const bf16* ks = ring + 2 * (it % kStages) * kTile;
    const bf16* vs = ks + kTile;
    const int k0 = k_lo + it * kKeyTile;

    // S = Q K^T: 16 rows x 64 keys in 8 accumulator tiles of 8 keys
    float s[kKeyTile / 8][4];
#pragma unroll
    for (int n = 0; n < kKeyTile / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int np = 0; np < kKeyTile / 16; ++np) {
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk) {
        uint32_t kb[4];  // keys np*16 + 0..7 and + 8..15, hd kk*16 + 0..15
        ldmatrix_x4(smem_addr(ks + (np * 16 + lane % 8 + (lane / 16) * 8) * kLd +
                              kk * 16 + (lane / 8 % 2) * 8),
                    kb);
        mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // accumulator (n, e) is row lane / 4 + 8 * (e / 2) of the warp's 16,
    // key k0 + n * 8 + 2 * (lane % 4) + e % 2
    if constexpr (Rows::kRoundScores) {
#pragma unroll
      for (int n = 0; n < kKeyTile / 8; ++n) {
        round_pair(s[n][0], s[n][1]);
        round_pair(s[n][2], s[n][3]);
      }
    }
    if (k0 < warp_lo || k0 + kKeyTile - 1 > warp_hi) {
      // key k0 + c + 2 * (lane % 4), c = n * 8 + e % 2, is masked for a
      // row iff c < lo - k0 - 2 * (lane % 4) or c > hi - k0 - 2 * (lane % 4)
      int c_lo[2], c_hi[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        c_lo[h] = lo[h] - k0 - 2 * (lane % 4);
        c_hi[h] = hi[h] == INT_MAX ? INT_MAX : hi[h] - k0 - 2 * (lane % 4);
      }
#pragma unroll
      for (int n = 0; n < kKeyTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + e % 2;
          if (c < c_lo[e / 2] || c > c_hi[e / 2]) s[n][e] = kNeg;
        }
    }

    // online softmax in f32, one row pair per thread quad.  exp(x - m) is
    // 2^(x log2 e - m log2 e), each product rounded on its own (no fused
    // multiply-add), so a row that has seen only masked keys (x = m =
    // -1e30) still gets exactly 1, as expf gives
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
    uint32_t pf[kKeyTile / 16][4];  // P in bf16 as A fragments
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kKeyTile / 8; ++n) {
      const float p0 = exp2_ftz(__fmul_rn(s[n][0], kLog2e) - ml[0]);
      const float p1 = exp2_ftz(__fmul_rn(s[n][1], kLog2e) - ml[0]);
      const float p2 = exp2_ftz(__fmul_rn(s[n][2], kLog2e) - ml[1]);
      const float p3 = exp2_ftz(__fmul_rn(s[n][3], kLog2e) - ml[1]);
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      // key step kk = n / 2 takes score tiles 2kk (a0, a1), 2kk+1 (a2, a3)
      pf[n / 2][(n % 2) * 2] = pack_bf16(p0, p1);
      pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
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

    // O += P V: V fragments transposed out of the key-major tile
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kHd / 16; ++np) {
        uint32_t vb[4];  // keys kk*16 + 0..15, hd np*16 + 0..7 and + 8..15
        ldmatrix_x4_trans(
            smem_addr(vs + (kk * 16 + lane % 8 + (lane / 8 % 2) * 8) * kLd +
                      np * 16 + (lane / 16) * 8),
            vb);
        mma_bf16(o[2 * np], pf[kk], vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], pf[kk], vb[2], vb[3]);
      }
    }
  }

  // epilogue: normalize, stage this warp's 16 rows in shared memory (the
  // ring is idle now), store 16 bytes a lane
  cp_async_wait<0>();
  __syncthreads();
  if (!warp_active) return;
  bf16* o_s = ring + warp * 16 * kLd;
  const float den0 = fmaxf(l[0], 1e-30f), den1 = fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int n = 0; n < kHd / 8; ++n) {
    bf16* p = o_s + (lane / 4) * kLd + n * 8 + 2 * (lane % 4);
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(o[n][0] / den0, o[n][1] / den0);
    *reinterpret_cast<uint32_t*>(p + 8 * kLd) =
        pack_bf16(o[n][2] / den1, o[n][3] / den1);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = i - r * kChunks;
    const int rg = r0 + warp * 16 + r, t = rg / G, g = rg - t * G;
    if (t < S)
      *reinterpret_cast<uint4*>(out + ((size_t)b * S + t) * q_row +
                                ((size_t)kvh * G + g) * kHd + c * 8) =
          *reinterpret_cast<const uint4*>(o_s + r * kLd + c * 8);
  }
}

template <typename Rows, int kHd, int kStages>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              Rows rows, int B, int S, int H, int KV, int causal, int window,
              float scale, void* stream) {
  constexpr size_t smem = smem_bytes<kHd, kStages>();
  auto kernel = prefill_mma_kernel<Rows, kHd, kStages>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B, KV, (S * (H / KV) + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, rows, S, H,
      KV, causal, window, scale);
  return (int)cudaGetLastError();
}

// bf16 q, K, V and output; head_dim 64 (a ring of 3 stages, 54 KB of
// shared memory) or 128 (2 stages, 68 KB); any other head_dim is refused
// (cudaErrorInvalidValue), the wrappers never send one.  Deeper rings,
// 8-warp blocks and 32 rows a warp measured no faster at the served
// shapes (PERF.md §6).
template <typename Rows>
int launch(const void* q, const void* k, const void* v, void* out, Rows rows,
           int B, int S, int H, int KV, int hd, int causal, int window,
           float scale, void* stream) {
  if (hd == 64)
    return launch_hd<Rows, 64, 3>(q, k, v, out, rows, B, S, H, KV, causal,
                                  window, scale, stream);
  if (hd == 128)
    return launch_hd<Rows, 128, 2>(q, k, v, out, rows, B, S, H, KV, causal,
                                   window, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace prefill_mma
}  // namespace kern
