// B2's backward on Hopper's tensor cores (sm_90a): the bf16 body of
// flash_backward.cu's *_mma entries, at head_dim 64, 128 and 192 (GQA, V
// as wide) and at DeepSeek-V3's MLA operands (q/k 192 = 128 + 64 with the
// rope key shared by every head, V 128).  FlashAttention-2's backward,
// built from prefill_mma.cuh's pieces: mma.sync.m16n8k16 bf16 products
// with f32 accumulators, ldmatrix fragments and a cp.async ring of tiles
// whose shared rows carry a 16-byte pad.
//
// It computes what flash_attention/ops.py::flash_attention_backward_plain
// computes, under B2's masks (causal, window, kpos < T; without the
// causal mask S may exceed T), from the forward's row logsumexp lse,
// which the *_lse forward entries store (prefill_mma.cuh's kLse), so no
// pass recomputes it.  Four kernels on the caller's stream, in the order
// delta, dk/dv, rope, dq (dq last, so that MLA's rope partials may live in
// dq's storage):
//   delta  rowsum(dout * out) in f32, one row per 8 or 16 lanes: bound by
//          its bytes.
//   dq     one block per 16 packed GQA rows a warp and KV head (4 warps;
//          8 at MLA and at 192, as those forwards), rows packed as the
//          forward packs them (row r = t * G + g is token t of head
//          kvh * G + g), so each K/V tile it loads serves the group's G
//          heads.  Over the visible 64-key tiles (a K/V ring):
//          S = Q K^T rounded to bf16 as the forward rounds it, P =
//          exp(S - lse), dP = dO V^T, dS = P (dP - delta), dQ += dS K;
//          P and dS are the accumulators repacked in registers as bf16 A
//          fragments (the m16n8 accumulator layout is the m16k16 A
//          layout), K comes by ldmatrix.trans.
//   dk/dv  one block per KV head (MLA: group of kMlaHeads heads) and
//          16 keys a warp (4 warps: 64 keys; 8 at MLA: 128), its K and V
//          rows staged once (MLA: per head).  The block walks its heads
//          and the 64-query tiles that see its keys, Q, dO, lse and delta
//          streaming through the ring: S^T = K Q^T, so P^T and dS^T land
//          in the A layout; dV += P^T dO; dP^T = V dO^T; dK += dS^T Q.
//          At 192/192 (dkdv_halves: 2) a pair of warps shares 16 keys,
//          each accumulating half of dK's and dV's columns (8 warps: 64
//          keys): FlashAttention-2's layout for wide heads.  Each warp of
//          the pair computes S^T and dP^T for half of the 64 queries
//          (the full head-dim depth), writes its P^T and dS^T in bf16 to
//          a shared exchange (64 keys x 64 queries each), and after a
//          barrier of the pair both read the whole 16 x 64 tiles as A
//          fragments for dV += P^T dO and dK += dS^T Q on their columns.
//   rope   MLA only: the rope key's gradient, each block's sum over its
//          heads (accumulated in shared memory at every step, an f32
//          partial a key and head group) summed over the groups in a
//          fixed order.
// No atomics on any output: every element is written by one thread of
// one block, so two launches give the same bits.
//
// Rounding: q * scale rounded to bf16 and the scores rounded to bf16, as
// the forward; P and dS rounded to bf16 as operands of the products;
// accumulators in f32; each gradient rounded to bf16 once (dq after its
// scale).  exp(s - lse) is 2^(s log2 e - lse log2 e) on ex2.approx.ftz,
// as the forward's exponent.
//
// Registers: a warp's accumulators are 16 rows of dq (kHd / 2 f32 a
// thread), or of dK and dV ((kHd + kVd) / 2; at MLA's 192 and 128 the
// rope columns of dK go to shared memory every step, 128 remain; at
// 192/192 a warp holds half the columns, 96); the Q,
// dO, K and V fragments are reread from shared memory at each step (no
// fragment is held across a tile), the score tile is 32 f32 and P and
// dS 16 packed registers.  chip_smoke.py phase 2 logs ptxas's registers
// and spills per instantiation.
//
// What bounds it on the card: 2.5 times the forward's operations (the
// five S x T products a head against the forward's two) at the bf16
// tensor-core rate, against reading q, k, v, out, dout and writing dq,
// dk and dv once; at smollm-360m's training shape (B = 8, S = 512, 15/5
// heads of 64) bytes, ~0.013 ms, the operations ~0.010.  On mma.sync
// the math between the products (masking, the exponent, the repacking)
// keeps the tensor cores waiting, as in the forward; wgmma with TMA is
// the next step.

#pragma once

#include <climits>

#include "prefill_mma.cuh"

namespace kern {
namespace bwd_mma {

using bf16 = __nv_bfloat16;
using prefill_mma::kKeyTile;
using prefill_mma::kLog2e;
using prefill_mma::ldmatrix_x4;
using prefill_mma::ldmatrix_x4_trans;
using prefill_mma::mma_bf16;
using prefill_mma::pack_bf16;
using prefill_mma::round_pair;

// the key tiles dq walks and the query tiles dk/dv walks: 64 rows
constexpr int kTile = kKeyTile;
// heads a dk/dv block walks at MLA's operands; the rope key's gradient is
// summed over them in the block, then over the ceil(H / kMlaHeads) groups
constexpr int kMlaHeads = 8;

// the dk/dv warps that share a warp's 16 keys, each accumulating its
// share of dK's and dV's columns: 2 where a warp's (kHd + kVd) / 2 f32
// would not fit its registers beside the tiles (GQA at 192/192; MLA puts
// its rope columns in shared memory instead)
template <int kHd, int kVd, int kRope>
__host__ __device__ constexpr int dkdv_halves() {
  return kRope == 0 && kHd + kVd > 256 ? 2 : 1;
}

// The operands.  GQA (kRope == 0): k (B, T, KV, kHd), v (B, T, KV, kVd).
// MLA (kRope > 0, KV == H): k the nope keys (B, T, H, kHd - kRope), rope
// the rope keys (B, T, kRope), one a token for every head, v (B, T, H,
// kVd).  q (B, S, H, kHd), dout (B, S, H, kVd); lse and delta (B, H, S).
template <int kHd, int kVd, int kRope>
struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* rope;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* delta;
  int S, T, H, KV, causal, window;
  float scale;

  // the 16-byte chunk c of key pos's K row (KV head kvh, batch row b)
  __device__ const bf16* k_chunk(int b, int pos, int kvh, int c) const {
    constexpr int kNope = kHd - kRope, kNopeChunks = kNope / 8;
    const size_t row = (size_t)b * T + pos;
    if (kRope == 0 || c < kNopeChunks)
      return k + (row * KV + kvh) * kNope + c * 8;
    return rope + row * kRope + (c - kNopeChunks) * 8;
  }
  __device__ const bf16* v_chunk(int b, int pos, int kvh, int c) const {
    return v + (((size_t)b * T + pos) * KV + kvh) * kVd + c * 8;
  }
};

// -- warp fragments --------------------------------------------------------

// A fragment: rows r0 .. r0 + 15, columns c0 .. c0 + 15 of a row-major tile
__device__ __forceinline__ void frag_a(const bf16* t, int ld, int r0, int c0,
                                       uint32_t (&a)[4]) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(smem_addr(t + (r0 + lane % 16) * ld + c0 + (lane / 16) * 8), a);
}
// B fragments of the n-tiles n0 .. n0 + 7 (b[0], b[1]) and n0 + 8 .. n0 +
// 15 (b[2], b[3]) at depth k0 .. k0 + 15, from a tile Y[n][k] (the
// product takes Y^T)
__device__ __forceinline__ void frag_b_rows(const bf16* t, int ld, int n0,
                                            int k0, uint32_t (&b)[4]) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(smem_addr(t + (n0 + lane % 8 + (lane / 16) * 8) * ld + k0 +
                        (lane / 8 % 2) * 8),
              b);
}
// the same from a tile Y[k][n] (the product takes Y), by ldmatrix.trans
__device__ __forceinline__ void frag_b_cols(const bf16* t, int ld, int k0,
                                            int n0, uint32_t (&b)[4]) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4_trans(smem_addr(t + (k0 + lane % 8 + (lane / 8 % 2) * 8) * ld +
                              n0 + (lane / 16) * 8),
                    b);
}

// c (16 x kN) = A . Y^T: A the rows a_r0 .. a_r0 + 15 of a, Y the kN rows
// of y, both kDepth columns deep.  Accumulator (n, e) is row lane / 4 +
// 8 * (e / 2), column n * 8 + 2 * (lane % 4) + e % 2.
template <int kDepth, int kN = 64>
__device__ __forceinline__ void mm_rows(float (&c)[kN / 8][4], const bf16* a,
                                        int lda, int a_r0, const bf16* y,
                                        int ldy) {
#pragma unroll
  for (int n = 0; n < kN / 8; ++n)
    c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kDepth / 16; ++kk) {
    uint32_t af[4];
    frag_a(a, lda, a_r0, kk * 16, af);
#pragma unroll
    for (int np = 0; np < kN / 16; ++np) {
      uint32_t yb[4];
      frag_b_rows(y, ldy, np * 16, kk * 16, yb);
      mma_bf16(c[2 * np], af, yb[0], yb[1]);
      mma_bf16(c[2 * np + 1], af, yb[2], yb[3]);
    }
  }
}

// c (16 x kN) += A . Y: A (16 x 64) in registers as packed A fragments, Y
// the 64 rows of y, kN columns wide
template <int kN>
__device__ __forceinline__ void mm_cols(float (*c)[4], const uint32_t (&a)[4][4],
                                        const bf16* y, int ldy) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < kN / 16; ++np) {
      uint32_t yb[4];
      frag_b_cols(y, ldy, kk * 16, np * 16, yb);
      mma_bf16(c[2 * np], a[kk], yb[0], yb[1]);
      mma_bf16(c[2 * np + 1], a[kk], yb[2], yb[3]);
    }
}

// a 16 x 64 accumulator rounded to bf16 as A fragments of depth 64: key
// step kk takes accumulator tiles 2kk (a0, a1) and 2kk + 1 (a2, a3)
__device__ __forceinline__ void to_a(const float (&x)[8][4],
                                     uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}
// accumulator element (n, e) as to_a packed it, back in f32 (exact)
__device__ __forceinline__ float a_elem(const uint32_t (&a)[4][4], int n,
                                        int e) {
  const uint32_t w = a[n / 2][(n % 2) * 2 + e / 2];
  return __uint_as_float(e % 2 ? w & 0xffff0000u : w << 16);
}

// A warp's 16 x kN f32 accumulator times mul, rounded to bf16, staged in
// 16 rows of s (stride ld, rows no other warp reads) and stored 16 bytes a
// lane: row r to dst(r), unless that is null
template <int kN, typename Dst>
__device__ __forceinline__ void store_acc(const float (*acc)[4], float mul,
                                          bf16* s, int ld, Dst dst) {
  const int lane = threadIdx.x % 32;
  constexpr int kChunks = kN / 8;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < kN / 8; ++n) {
    bf16* p = s + (lane / 4) * ld + n * 8 + 2 * (lane % 4);
    *reinterpret_cast<uint32_t*>(p) =
        pack_bf16(acc[n][0] * mul, acc[n][1] * mul);
    *reinterpret_cast<uint32_t*>(p + 8 * ld) =
        pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = i - r * kChunks;
    bf16* d = dst(r);
    if (d)
      *reinterpret_cast<uint4*>(d + c * 8) =
          *reinterpret_cast<const uint4*>(s + r * ld + c * 8);
  }
  __syncwarp();
}

// -- delta = rowsum(dout * out) ---------------------------------------------

// lanes a row of kVd: one 16-byte chunk a lane where a warp holds whole
// rows (64: 8 lanes, 128: 16), else 8 lanes of kVd / 64 chunks (192: 3)
template <int kVd>
__host__ __device__ constexpr int delta_lanes() {
  return 32 % (kVd / 8) == 0 ? kVd / 8 : 8;
}

template <int kVd>
__global__ void __launch_bounds__(256)
delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
             float* __restrict__ delta, int B, int S, int H) {
  constexpr int kLanes = delta_lanes<kVd>();
  constexpr int kPer = kVd / 8 / kLanes;  // chunks a lane
  static_assert(32 % kLanes == 0 && kPer * kLanes * 8 == kVd,
                "a row's lanes share a warp");
  const size_t row = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  const int c = threadIdx.x % kLanes;
  const size_t n_rows = (size_t)B * S * H;
  float sum = 0.f;
  if (row < n_rows) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const size_t at = row * kVd + (c + i * kLanes) * 8;
      const uint4 o = *reinterpret_cast<const uint4*>(out + at);
      const uint4 d = *reinterpret_cast<const uint4*>(dout + at);
      const __nv_bfloat162* oh = reinterpret_cast<const __nv_bfloat162*>(&o);
      const __nv_bfloat162* dh = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 of = __bfloat1622float2(oh[e]);
        const float2 df = __bfloat1622float2(dh[e]);
        sum = fmaf(of.x, df.x, sum);
        sum = fmaf(of.y, df.y, sum);
      }
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (c == 0 && row < n_rows) {
    const int h = row % H;
    const size_t bt = row / H;
    delta[((bt / S) * H + h) * S + bt % S] = sum;
  }
}

// -- dq ---------------------------------------------------------------------

// kWarps warps a block, 16 rows each (kRows = kWarps * 16 rows)
template <int kHd, int kVd, int kRope, int kStages, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
dq_kernel(Args<kHd, kVd, kRope> p, bf16* __restrict__ dq) {
  constexpr int kThreads = kWarps * 32, kRows = kWarps * 16;
  constexpr int kLd = kHd + 8, kLdV = kVd + 8;  // 16-byte row pad
  constexpr int kChunks = kHd / 8, kVChunks = kVd / 8;
  constexpr int kStage = kTile * (kLd + kLdV);  // K, then V
  constexpr int kLoads = kTile * kChunks / kThreads;      // a K tile
  constexpr int kVLoads = kTile * kVChunks / kThreads;    // a V tile
  constexpr int kQLoads = kRows * kChunks / kThreads;     // q rows
  constexpr int kOLoads = kRows * kVChunks / kThreads;    // dout rows
  static_assert(kLoads * kThreads == kTile * kChunks &&
                    kVLoads * kThreads == kTile * kVChunks && kStages >= 2,
                "uneven loads");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // q * scale
  bf16* do_s = q_s + kRows * kLd;                 // dout
  bf16* ring = do_s + kRows * kLdV;

  // row blocks in reverse: under a causal mask the last rows see the most
  // keys, and their blocks start first
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int S = p.S, T = p.T, H = p.H, G = H / p.KV;
  const int causal = p.causal, window = p.window;

  // the keys any row of this block sees
  const int t_first = r0 / G, t_last = min((r0 + kRows - 1) / G, S - 1);
  const int k_lo = window > 0 ? max(0, t_first - window + 1) : 0;
  const int k_hi = causal ? min(t_last, T - 1) : T - 1;
  const int n_tiles = k_hi >= k_lo ? (k_hi - k_lo) / kKeyTile + 1 : 0;

  auto load_tile = [&](int tile, int stage) {
    const int k0 = k_lo + tile * kKeyTile;
    bf16* ks = ring + stage * kStage;
    bf16* vs = ks + kTile * kLd;
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int i = tid + it * kThreads;
      const int j = i / kChunks, c = i - j * kChunks;
      const bool in = k0 + j <= k_hi;
      cp_async16(smem_addr(ks + j * kLd + c * 8),
                 p.k_chunk(b, in ? k0 + j : 0, kvh, c), in);
    }
#pragma unroll
    for (int it = 0; it < kVLoads; ++it) {
      const int i = tid + it * kThreads;
      const int j = i / kVChunks, c = i - j * kVChunks;
      const bool in = k0 + j <= k_hi;
      cp_async16(smem_addr(vs + j * kLdV + c * 8),
                 p.v_chunk(b, in ? k0 + j : 0, kvh, c), in);
    }
  };

  // the block's dout rows travel with the first tile (rows past S * G
  // are zero)
#pragma unroll
  for (int it = 0; it < kOLoads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kVChunks, c = i - r * kVChunks;
    const int rg = r0 + r, t = rg / G, g = rg - t * G;
    const bool in = t < S;
    cp_async16(smem_addr(do_s + r * kLdV + c * 8),
               p.dout + (((size_t)b * S + (in ? t : 0)) * H + kvh * G + g) *
                            kVd + c * 8,
               in);
  }
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }

  // q * scale, rounded to bf16 as the forward rounds it
  uint4 raw[kQLoads];
#pragma unroll
  for (int it = 0; it < kQLoads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kChunks, c = i - r * kChunks;
    const int rg = r0 + r, t = rg / G, g = rg - t * G;
    raw[it] = t < S ? *reinterpret_cast<const uint4*>(
                          p.q + ((size_t)b * S + t) * H * kHd +
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
      o[e] = pack_bf16(f.x * p.scale, f.y * p.scale);
    }
    *reinterpret_cast<uint4*>(q_s + r * kLd + c * 8) = packed;
  }

  // this thread's two rows (lane / 4 and 8 below it): the keys each sees
  // [lo, hi], lse in log2 units and delta.  Rows past S * G take lse =
  // +inf (P = 0) and see everything.
  int lo[2], hi[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rg = r0 + warp * 16 + lane / 4 + 8 * h;
    const int t = rg / G, g = rg - t * G;
    lo[h] = t < S && window > 0 ? max(0, t - window + 1) : 0;
    hi[h] = t >= S ? INT_MAX : causal ? min(t, T - 1) : T - 1;
    const size_t at = ((size_t)b * H + kvh * G + g) * S + t;
    lse2[h] = t < S ? __fmul_rn(p.lse[at], kLog2e) : INFINITY;
    dl[h] = t < S ? p.delta[at] : 0.f;
  }
  const int warp_lo = __reduce_max_sync(0xffffffffu, max(lo[0], lo[1]));
  const int warp_hi = __reduce_min_sync(0xffffffffu, min(hi[0], hi[1]));
  const bool warp_active = (r0 + warp * 16) / G < S;
  // the last key any valid row of this warp sees: later tiles are masked
  int top = -1;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if ((r0 + warp * 16 + lane / 4 + 8 * h) / G < S) top = max(top, hi[h]);
  const int warp_top = __reduce_max_sync(0xffffffffu, top);

  float acc[kHd / 8][4];  // dQ / scale: kHd columns in 8-wide tiles
#pragma unroll
  for (int n = 0; n < kHd / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile it
    __syncthreads();  // everyone's (and q_s); the stage refilled is free
    if (it + kStages - 1 < n_tiles)
      load_tile(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    const int k0 = k_lo + it * kKeyTile;
    if (!warp_active || k0 > warp_top) continue;
    const bf16* ks = ring + (it % kStages) * kStage;
    const bf16* vs = ks + kTile * kLd;

    // S = Q K^T, rounded to bf16; P = exp(S - lse), masked keys 0
    float x[8][4];
    mm_rows<kHd>(x, q_s, kLd, warp * 16, ks, kLd);
    const bool edge = k0 < warp_lo || k0 + kKeyTile - 1 > warp_hi;
    int c_lo[2], c_hi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      c_lo[h] = lo[h] - k0 - 2 * (lane % 4);
      c_hi[h] = hi[h] == INT_MAX ? INT_MAX : hi[h] - k0 - 2 * (lane % 4);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      round_pair(x[n][0], x[n][1]);
      round_pair(x[n][2], x[n][3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + e % 2;
        x[n][e] = edge && (c < c_lo[e / 2] || c > c_hi[e / 2])
                      ? 0.f
                      : exp2_ftz(__fmul_rn(x[n][e], kLog2e) - lse2[e / 2]);
      }
    }
    uint32_t pa[4][4];  // P, then dS, as bf16 A fragments
    to_a(x, pa);

    // dP = dO V^T; dS = P (dP - delta)
    mm_rows<kVd>(x, do_s, kLdV, warp * 16, vs, kLdV);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[n][e] = a_elem(pa, n, e) * (x[n][e] - dl[e / 2]);
    to_a(x, pa);

    // dQ += dS K: K fragments transposed out of the key-major tile
    mm_cols<kHd>(acc, pa, ks, kLd);
  }
  cp_async_wait<0>();
  if (!warp_active) return;
  // dq = scale * acc, staged in this warp's rows of q_s
  store_acc<kHd>(acc, p.scale, q_s + warp * 16 * kLd, kLd, [&](int r) {
    const int rg = r0 + warp * 16 + r, t = rg / G, g = rg - t * G;
    return t < S ? dq + ((size_t)b * S + t) * H * kHd +
                       ((size_t)kvh * G + g) * kHd
                 : nullptr;
  });
}

// -- dk, dv (and the rope key's partial sums) --------------------------------

template <int kHd, int kVd>
__host__ __device__ constexpr int kv_stage_elems() {
  // q and dout tiles, then lse and delta (64 f32 each, as bf16 pairs)
  return kTile * ((kHd + 8) + (kVd + 8)) + 2 * kTile * 2;
}

// kWarps warps a block, kHalves to each 16 keys (kRows = kWarps / kHalves
// * 16 keys)
template <int kHd, int kVd, int kRope, int kStages, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
dkdv_kernel(Args<kHd, kVd, kRope> p, bf16* __restrict__ dk,
            bf16* __restrict__ dv, float* __restrict__ rope_part) {
  constexpr bool kMla = kRope > 0;
  constexpr int kHalves = dkdv_halves<kHd, kVd, kRope>();
  constexpr int kThreads = kWarps * 32, kRows = kWarps / kHalves * 16;
  constexpr int kNope = kHd - kRope;
  // dK's accumulated columns: MLA's rope columns go to rope_s every step
  constexpr int kDk = kMla ? kNope : kHd;
  // this warp's share of them and of dV's, and of the tile's queries
  constexpr int kDkW = kDk / kHalves, kVdW = kVd / kHalves;
  constexpr int kQW = kTile / kHalves;
  constexpr int kLdX = kTile + 8;  // exchange row stride (kHalves > 1)
  constexpr int kLd = kHd + 8, kLdV = kVd + 8;
  constexpr int kChunks = kHd / 8, kVChunks = kVd / 8;
  constexpr int kStage = kv_stage_elems<kHd, kVd>();
  constexpr int kLoads = kTile * kChunks / kThreads;     // a q tile
  constexpr int kVLoads = kTile * kVChunks / kThreads;   // a dout tile
  constexpr int kKLoads = kRows * kChunks / kThreads;    // K rows
  constexpr int kKVLoads = kRows * kVChunks / kThreads;  // V rows
  static_assert(kLoads * kThreads == kTile * kChunks &&
                    kVLoads * kThreads == kTile * kVChunks &&
                    kKLoads * kThreads == kRows * kChunks &&
                    kKVLoads * kThreads == kRows * kVChunks &&
                    kThreads >= 2 * kTile && kStages >= 2,
                "uneven loads");
  static_assert(kHalves == 1 || (!kMla && kDkW % 16 == 0 && kVdW % 16 == 0),
                "bad column split");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // this block's K rows
  bf16* v_s = k_s + kRows * kLd;                   // and V rows
  bf16* ring = v_s + kRows * kLdV;   // per stage: q * scale, dout, lse, delta
  // kHalves > 1: P^T, then dS^T, of the block's keys x the tile's queries
  bf16* pt_s = ring + kStages * kStage;
  bf16* dst_s = pt_s + kRows * kLdX;
  float* rope_s = reinterpret_cast<float*>(ring + kStages * kStage);

  const int b = blockIdx.x, grp = blockIdx.y, k0 = blockIdx.z * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int S = p.S, T = p.T, H = p.H, KV = p.KV, G = H / KV;
  const int causal = p.causal, window = p.window;
  // the heads this block walks: GQA the KV head's group, MLA a group of
  // kMlaHeads (each with its own K/V)
  const int h0 = kMla ? grp * kMlaHeads : grp * G;
  const int n_heads = kMla ? min(kMlaHeads, H - h0) : G;
  // the queries that see a key of this block, in tiles of 64
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S - 1, k0 + kRows - 1 + window - 1)
                              : S - 1;
  const int n_q = q_hi >= q_lo ? (q_hi - q_lo) / kTile + 1 : 0;
  const int n_steps = n_heads * n_q;

  auto stage_at = [&](int stage) { return ring + stage * kStage; };
  auto load_step = [&](int step, int stage) {
    const int h = h0 + step / n_q, q0 = q_lo + (step % n_q) * kTile;
    bf16* qs = stage_at(stage);
    bf16* ds = qs + kTile * kLd;
    float* ls = reinterpret_cast<float*>(ds + kTile * kLdV);
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int i = tid + it * kThreads;
      const int j = i / kChunks, c = i - j * kChunks;
      const bool in = q0 + j < S;
      cp_async16(smem_addr(qs + j * kLd + c * 8),
                 p.q + (((size_t)b * S + (in ? q0 + j : 0)) * H + h) * kHd +
                     c * 8,
                 in);
    }
#pragma unroll
    for (int it = 0; it < kVLoads; ++it) {
      const int i = tid + it * kThreads;
      const int j = i / kVChunks, c = i - j * kVChunks;
      const bool in = q0 + j < S;
      cp_async16(smem_addr(ds + j * kLdV + c * 8),
                 p.dout + (((size_t)b * S + (in ? q0 + j : 0)) * H + h) *
                              kVd + c * 8,
                 in);
    }
    // thread tid < 128 copies lse (tid < 64) or delta of query q0 + tid % 64
    if (tid < 2 * kTile) {
      const int j = tid % kTile;
      const bool in = q0 + j < S;
      cp_async4(smem_addr(ls + tid),
                (tid < kTile ? p.lse : p.delta) + ((size_t)b * H + h) * S +
                    (in ? q0 + j : 0),
                in);
    }
  };
  // after its wait, a thread scales the q chunks it copied (q * scale
  // rounded to bf16, as the forward) and takes its lse to log2 units
  auto finish_step = [&](int stage) {
    bf16* qs = stage_at(stage);
    float* ls = reinterpret_cast<float*>(qs + kTile * (kLd + kLdV));
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int i = tid + it * kThreads;
      const int j = i / kChunks, c = i - j * kChunks;
      uint4* at = reinterpret_cast<uint4*>(qs + j * kLd + c * 8);
      uint4 w = *at;
      uint32_t* o = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&o[e]));
        o[e] = pack_bf16(f.x * p.scale, f.y * p.scale);
      }
      *at = w;
    }
    if (tid < kTile) ls[tid] = __fmul_rn(ls[tid], kLog2e);
  };
  // this block's K and V rows of head h (keys past T zero)
  auto load_kv = [&](int h) {
    const int kvh = kMla ? h : h / G;
#pragma unroll
    for (int it = 0; it < kKLoads; ++it) {
      const int i = tid + it * kThreads;
      const int j = i / kChunks, c = i - j * kChunks;
      const bool in = k0 + j < T;
      cp_async16(smem_addr(k_s + j * kLd + c * 8),
                 p.k_chunk(b, in ? k0 + j : 0, kvh, c), in);
    }
#pragma unroll
    for (int it = 0; it < kKVLoads; ++it) {
      const int i = tid + it * kThreads;
      const int j = i / kVChunks, c = i - j * kVChunks;
      const bool in = k0 + j < T;
      cp_async16(smem_addr(v_s + j * kLdV + c * 8),
                 p.v_chunk(b, in ? k0 + j : 0, kvh, c), in);
    }
    cp_async_commit();
  };

  // this warp's 16 keys (shared by the kHalves warps kw * kHalves + half)
  // and its share of the columns; this thread's rows lane / 4 and 8 below
  const int kw = warp / kHalves, half = warp % kHalves;
  const int kw0 = k0 + kw * 16;
  float dk_acc[kDkW / 8][4], dv_acc[kVdW / 8][4];
  auto zero_acc = [&]() {
#pragma unroll
    for (int n = 0; n < kDkW / 8; ++n)
      dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
#pragma unroll
    for (int n = 0; n < kVdW / 8; ++n)
      dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;
  };
  zero_acc();
  // MLA: the rope key's gradient over this block's heads, accumulated in
  // rope_s at every step (its 32 registers a thread would spill beside dK
  // and dV); each thread owns the elements of its accumulator layout
  auto rope_at = [&](int n, int e) {
    return rope_s + (warp * 16 + lane / 4 + 8 * (e / 2)) * kRope + n * 8 +
           2 * (lane % 4) + e % 2;
  };
  if constexpr (kMla) {
#pragma unroll
    for (int n = 0; n < kRope / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) *rope_at(n, e) = 0.f;
  }
  // MLA: head h's dk (nope columns) and dv, staged in this warp's rows of
  // k_s and v_s (its K/V rows are read no more)
  auto flush_head = [&](int h) {
    auto row_of = [&](bf16* base, int width) {
      return [=](int r) {
        const int key = kw0 + r;
        return key < T ? base + (((size_t)b * T + key) * H + h) * width
                       : nullptr;
      };
    };
    store_acc<kNope>(dk_acc, 1.f, k_s + warp * 16 * kLd, kLd,
                     row_of(dk, kNope));
    store_acc<kVd>(dv_acc, 1.f, v_s + warp * 16 * kLdV, kLdV,
                   row_of(dv, kVd));
    zero_acc();
  };

  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_steps) load_step(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < n_steps; ++it) {
    const int hi = it / n_q, qt = it - hi * n_q;
    if (qt == 0 && (kMla || hi == 0)) {
      // a new head's K/V (GQA: the only one): every warp is done with the
      // last; wait for it and for every tile in flight
      __syncthreads();
      load_kv(h0 + hi);
      cp_async_wait<0>();
    } else {
      cp_async_wait<kStages - 2>();  // this thread's copies of step it
    }
    finish_step(it % kStages);
    __syncthreads();  // everyone's; the stage refilled next is free
    if (it + kStages - 1 < n_steps)
      load_step(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();

    const int q0 = q_lo + qt * kTile;
    // the warp's keys see none of these queries, or lie past T
    const bool skip = kw0 >= T || (causal && q0 + kTile - 1 < kw0) ||
                      (window > 0 && q0 > kw0 + 15 + window - 1);
    if (!skip) {
      const bf16* qs = stage_at(it % kStages);
      const bf16* ds = qs + kTile * kLd;
      const float* ls = reinterpret_cast<const float*>(ds + kTile * kLdV);
      const float* dls = ls + kTile;
      if constexpr (kHalves > 1) {
        // S^T and dP^T of this warp's queries q0 + c0 .. (all of the head
        // dims deep); P^T and dS^T to the exchange in bf16
        const int c0 = half * kQW;
        float x[kQW / 8][4];
        mm_rows<kHd, kQW>(x, k_s, kLd, kw * 16, qs + c0 * kLd, kLd);
        const bool full = (!causal || q0 >= kw0 + 15) &&
                          (window <= 0 || q0 + kTile - 1 <= kw0 + window - 1) &&
                          q0 + kTile <= S;
        auto xch = [&](bf16* t, int n, int h) {  // accumulator (n, 2h..)
          return reinterpret_cast<uint32_t*>(
              t + (kw * 16 + lane / 4 + 8 * h) * kLdX + c0 + n * 8 +
              2 * (lane % 4));
        };
        uint32_t pk[kQW / 8][2];  // P^T rounded to bf16, row pairs packed
#pragma unroll
        for (int n = 0; n < kQW / 8; ++n) {
          round_pair(x[n][0], x[n][1]);
          round_pair(x[n][2], x[n][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + n * 8 + 2 * (lane % 4) + e % 2;  // q0 + c
            bool vis = true;
            if (!full) {
              const int q = q0 + c, key = kw0 + lane / 4 + 8 * (e / 2);
              vis = q < S && (!causal || q >= key) &&
                    (window <= 0 || q < key + window);
            }
            x[n][e] = vis ? exp2_ftz(__fmul_rn(x[n][e], kLog2e) - ls[c])
                          : 0.f;
          }
          pk[n][0] = *xch(pt_s, n, 0) = pack_bf16(x[n][0], x[n][1]);
          pk[n][1] = *xch(pt_s, n, 1) = pack_bf16(x[n][2], x[n][3]);
        }
        mm_rows<kVd, kQW>(x, v_s, kLdV, kw * 16, ds + c0 * kLdV, kLdV);
#pragma unroll
        for (int n = 0; n < kQW / 8; ++n) {
          float d[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t w = pk[n][e / 2];
            d[e] = __uint_as_float(e % 2 ? w & 0xffff0000u : w << 16) *
                   (x[n][e] - dls[c0 + n * 8 + 2 * (lane % 4) + e % 2]);
          }
          *xch(dst_s, n, 0) = pack_bf16(d[0], d[1]);
          *xch(dst_s, n, 1) = pack_bf16(d[2], d[3]);
        }
        // the pair's halves both in the exchange (its named barrier)
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + kw), "n"(kHalves * 32)
                     : "memory");
        uint32_t pa[4][4];  // P^T, then dS^T, 16 keys x 64 queries
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          frag_a(pt_s, kLdX, kw * 16, kk * 16, pa[kk]);
        mm_cols<kVdW>(dv_acc, pa, ds + half * kVdW, kLdV);  // dV += P^T dO
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          frag_a(dst_s, kLdX, kw * 16, kk * 16, pa[kk]);
        mm_cols<kDkW>(dk_acc, pa, qs + half * kDkW, kLd);  // dK += dS^T Q
      } else {
        // S^T = K Q^T (keys x queries), rounded to bf16; P^T = exp(S^T -
        // lse), masked pairs 0
        float x[8][4];
        mm_rows<kHd>(x, k_s, kLd, warp * 16, qs, kLd);
        const bool full = (!causal || q0 >= kw0 + 15) &&
                          (window <= 0 || q0 + kTile - 1 <= kw0 + window - 1) &&
                          q0 + kTile <= S;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          round_pair(x[n][0], x[n][1]);
          round_pair(x[n][2], x[n][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = n * 8 + 2 * (lane % 4) + e % 2;  // query q0 + c
            bool vis = true;
            if (!full) {
              const int q = q0 + c, key = kw0 + lane / 4 + 8 * (e / 2);
              vis = q < S && (!causal || q >= key) &&
                    (window <= 0 || q < key + window);
            }
            x[n][e] = vis ? exp2_ftz(__fmul_rn(x[n][e], kLog2e) - ls[c])
                          : 0.f;
          }
        }
        uint32_t pa[4][4];  // P^T, then dS^T, as bf16 A fragments
        to_a(x, pa);
        mm_cols<kVd>(dv_acc, pa, ds, kLdV);  // dV += P^T dO

        // dP^T = V dO^T; dS^T = P^T (dP^T - delta)
        mm_rows<kVd>(x, v_s, kLdV, warp * 16, ds, kLdV);
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[n][e] = a_elem(pa, n, e) *
                      (x[n][e] - dls[n * 8 + 2 * (lane % 4) + e % 2]);
        to_a(x, pa);
        mm_cols<kDk>(dk_acc, pa, qs, kLd);  // dK += dS^T (q * scale)
        if constexpr (kMla) {
          // the rope columns: this step's product, added to rope_s
          float r[kRope / 8][4];
#pragma unroll
          for (int n = 0; n < kRope / 8; ++n) r[n][0] = r[n][1] = r[n][2] =
              r[n][3] = 0.f;
          mm_cols<kRope>(r, pa, qs + kNope, kLd);
#pragma unroll
          for (int n = 0; n < kRope / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) *rope_at(n, e) += r[n][e];
        }
      }
    }
    if constexpr (kMla)
      if (qt == n_q - 1) flush_head(h0 + hi);
  }
  cp_async_wait<0>();

  if constexpr (kMla) {
    // a key tile no query sees: zero gradients for every head
    if (n_q == 0)
      for (int hi = 0; hi < n_heads; ++hi) flush_head(h0 + hi);
    // this warp's 16 keys of the rope partial (B, T, groups, kRope)
    __syncwarp();
    const int n_grp = gridDim.y;
    for (int i = lane; i < 16 * kRope / 4; i += 32) {
      const int r = i / (kRope / 4), c = (i - r * (kRope / 4)) * 4;
      const int key = kw0 + r;
      if (key < T)
        *reinterpret_cast<float4*>(
            rope_part + (((size_t)b * T + key) * n_grp + grp) * kRope + c) =
            *reinterpret_cast<const float4*>(rope_s +
                                             (warp * 16 + r) * kRope + c);
    }
  } else {
    // the group's sums, staged in this warp's rows and columns of k_s and
    // v_s (read no more: a pair's last barrier follows its last read)
    auto row_of = [&](bf16* base, int width, int col0) {
      return [=](int r) {
        const int key = kw0 + r;
        return key < T ? base + (((size_t)b * T + key) * KV + grp) * width +
                             col0
                       : nullptr;
      };
    };
    store_acc<kDkW>(dk_acc, 1.f, k_s + kw * 16 * kLd + half * kDkW, kLd,
                    row_of(dk, kHd, half * kDkW));
    store_acc<kVdW>(dv_acc, 1.f, v_s + kw * 16 * kLdV + half * kVdW, kLdV,
                    row_of(dv, kVd, half * kVdW));
  }
}

// the rope key's gradient: d_rope (B, T, kRope) = the sum of the groups'
// partials, in group order
template <int kRope>
__global__ void __launch_bounds__(256)
rope_sum_kernel(const float* __restrict__ part, bf16* __restrict__ d_rope,
                int n_rows, int n_grp) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)n_rows * kRope) return;
  const size_t row = i / kRope, c = i % kRope;
  float sum = 0.f;
  for (int g = 0; g < n_grp; ++g) sum += part[(row * n_grp + g) * kRope + c];
  d_rope[i] = __float2bfloat16(sum);
}

// -- launch -------------------------------------------------------------------

template <int kHd, int kVd, int kStages, int kWarps>
constexpr size_t dq_smem() {
  // q and dout rows, then the K/V ring
  return sizeof(bf16) * (kWarps * 16 * ((kHd + 8) + (kVd + 8)) +
                         kStages * kTile * ((kHd + 8) + (kVd + 8)));
}
template <int kHd, int kVd, int kRope, int kStages, int kWarps>
constexpr size_t dkdv_smem() {
  // K and V rows, the ring, the P^T / dS^T exchange (split columns) or
  // MLA's rope accumulator
  constexpr int kHalves = dkdv_halves<kHd, kVd, kRope>();
  constexpr int kKeys = kWarps / kHalves * 16;
  return sizeof(bf16) * (kKeys * ((kHd + 8) + (kVd + 8)) +
                         kStages * kv_stage_elems<kHd, kVd>() +
                         (kHalves > 1 ? 2 * kKeys * (kTile + 8) : 0)) +
         sizeof(float) * kKeys * kRope;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The passes on stream st.  out (B, S, H, kVd) for delta; dq (B, S, H,
// kHd); dk (GQA: (B, T, KV, kHd); MLA: the nope gradient (B, T, H, kHd -
// kRope)); dv like v; MLA: d_rope (B, T, kRope) and rope_part (B, T,
// ceil(H / kMlaHeads), kRope) f32 scratch, which may be dq's storage (dq
// is written last).  Stages: the rings' depths; warps: each kernel's
// warps a block.
template <int kHd, int kVd, int kRope, int kStages, int kWarps>
int launch(const Args<kHd, kVd, kRope>& p, int B, const void* out,
           float* delta, void* dq, void* dk, void* dv, void* d_rope,
           float* rope_part, cudaStream_t st) {
  constexpr int kRows = kWarps * 16;
  constexpr size_t qs = dq_smem<kHd, kVd, kStages, kWarps>();
  constexpr size_t ks = dkdv_smem<kHd, kVd, kRope, kStages, kWarps>();
  auto dq_k = dq_kernel<kHd, kVd, kRope, kStages, kWarps>;
  auto kv_k = dkdv_kernel<kHd, kVd, kRope, kStages, kWarps>;
  cudaError_t e;
  if ((e = allow_smem(dq_k, qs)) != cudaSuccess) return (int)e;
  if ((e = allow_smem(kv_k, ks)) != cudaSuccess) return (int)e;
  const int S = p.S, T = p.T, H = p.H, G = H / p.KV;
  const size_t lanes = (size_t)B * S * H * delta_lanes<kVd>();
  delta_kernel<kVd><<<(unsigned)((lanes + 255) / 256), 256, 0, st>>>(
      (const bf16*)out, p.dout, delta, B, S, H);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  Args<kHd, kVd, kRope> a = p;
  a.delta = delta;
  // dk/dv and the rope sum before dq: rope_part may lie in dq's storage
  const int n_grp = kRope ? (H + kMlaHeads - 1) / kMlaHeads : p.KV;
  constexpr int kKeys = kWarps / dkdv_halves<kHd, kVd, kRope>() * 16;
  kv_k<<<dim3(B, n_grp, (T + kKeys - 1) / kKeys), kWarps * 32, ks, st>>>(
      a, (bf16*)dk, (bf16*)dv, rope_part);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if constexpr (kRope > 0) {
    const size_t n = (size_t)B * T * kRope;
    rope_sum_kernel<kRope><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        rope_part, (bf16*)d_rope, B * T, n_grp);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  dq_k<<<dim3(B, p.KV, (S * G + kRows - 1) / kRows), kWarps * 32, qs, st>>>(
      a, (bf16*)dq);
  return (int)cudaGetLastError();
}

}  // namespace bwd_mma
}  // namespace kern
