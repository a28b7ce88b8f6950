// B2's backward in f32 on Hopper's tensor cores in split TF32 (sm_90a):
// the body of flash_backward.cu's flash_attention_backward_f32_tf32 at
// head_dim 64 and 128 (GQA, V as wide).  FlashAttention-2's backward with
// backward_mma.cuh's three passes and rules, every product on
// mma.sync.m16n8k8 tf32 with both f32 operands split as
// prefill_tf32.cuh splits them (a = hi + lo, each TF32; a product is
// Alo.Bhi + Ahi.Blo + Ahi.Bhi with f32 accumulators, the dropped Alo.Blo
// ~2^-22 of it): f32 accuracy, where one TF32 product (~2^-11) misses the
// 1e-5 tolerance B2''s f32 gradients are held to.
//
// It computes what flash_attention/ops.py::flash_attention_backward_plain
// computes, under B2's masks (causal, window, kpos < T; without the
// causal mask S may exceed T), from the forward's row logsumexp lse,
// which flash_attention_f32_tf32_lse stores (prefill_tf32.cuh's kLse).
// Three kernels on the caller's stream, in this order:
//   delta  rowsum(dout * out) in f32, a row's 16-byte chunks over 16 (64)
//          or 32 (128) lanes: bound by its bytes.
//   dk/dv  one block of 8 warps per (row, KV head, 64 keys), its K and V
//          rows staged once.  The block walks the group's G heads and the
//          query tiles that see its keys (32 queries at head_dim 64, 16
//          at 128), q, dout, lse and delta streaming through a 2-stage
//          ring.  Two roles share each 16 keys: warp w < 4 (P) computes
//          S^T = scale K Q^T and P^T = exp(S^T - lse), puts P^T in a
//          shared exchange and adds dV += P^T dO; warp w + 4 (dS)
//          computes dP^T = V dO^T meanwhile, then, after one barrier,
//          dS^T = P^T (dP^T - delta) and dK += dS^T Q (times scale once,
//          at the end).  Each warp holds one accumulator (hd / 2 f32 a
//          thread), not two: at 128 the two pushed a warp past 255
//          registers.
//   dq     one block of 8 warps per (row, KV head, 128 packed GQA rows),
//          rows packed as the forward packs them (row r = t * G + g is
//          token t of head kvh * G + g), so each K/V tile serves the
//          group's heads; over the visible key tiles (32 keys at 64, 16
//          at 128; a 2-stage ring): S = scale Q K^T, P, dP = dO V^T, dS,
//          dQ += dS K.
// No atomics on any output: every element is written by one thread of
// one block, so two launches give the same bits.
//
// Split once, read by every warp.  The tiles that stream through a ring
// (q and dout in dk/dv, K and V in dq) are the B operands of every warp's
// products: each thread splits the 16-byte chunks it copied as they land
// (hi in place, lo into a second plane), so a tile is split once a block,
// not once a warp.  The rows a block stages once (K and V in dk/dv,
// q and dout in dq; a warp reads only its own 16) and P, dS, the A
// operands from registers, are split where they are read.  Splits round
// in integer arithmetic (prefill_tf32.cuh's split_tf32_int; cvt.rna.tf32
// compiles to four instructions).
//
// Fragments.  Every tile lives in shared memory as f32 rows of hd + 4
// values (a 16-byte pad).  A row-major A fragment and a B fragment of Y^T
// (the product takes the rows of Y: K, V, q and dout in S, dP, S^T and
// dP^T) are 8 rows x 4 values each: one ldmatrix.x4 reads an A fragment,
// or the B fragments of two 8-column tiles (32-bit elements through the
// b16 form: thread t gets row t / 4, value t % 4, the tf32 fragment
// layout); the 16-byte row pad puts a matrix's 8 rows in 8 distinct bank
// quads.  A B fragment of Y itself (K in dS K, dout and q in P^T dO and
// dS^T Q) is rows 2c and 2c + 1 of 8 columns, which ldmatrix cannot
// transpose for 32-bit elements: one 4-byte load each, banks 8 c + r and
// 8 c + 4 + r, distinct with the row stride = 4 (mod 32) floats.  P and
// dS stay in registers: the m16n8 accumulator of an 8-wide group (columns
// 2c and 2c + 1 in thread column c) is the A fragment of the next product
// with the group's columns taken in the order 0, 2, 4, 6, 1, 3, 5, 7, and
// that product's B fragments are read in that order (prefill_tf32.cuh's
// P.V).  The mma.sync instructions issue in passes over groups of four
// 8-column tiles (mma3), so consecutive ones write different
// accumulators.  In the gradients' products (dV, dK, dQ) each k8 step's
// three products are summed apart and added to the accumulator on the
// CUDA cores (mma3's fold): dK and dV sum over G * S queries, and carried
// through that chain of mma.sync instructions the sums drift past the
// 1e-5 tolerance (ablations.py --body bwd32, no_fold).  The score
// tiles' chains (hd / 8 steps from zero) stay on the tensor cores.
//
// Resources (ptxas, chip_smoke.py phase 2): dk/dv 221 registers at 64,
// 230 at 128; dq 208 and 229; no spills.  Shared memory: dk/dv K and V
// rows (64 x 2), the exchange and the ring: 111.5 KB at 64, 137 KB at 128;
// dq q and dout rows (128 x 2) and the ring: 136 KB and 198 KB.  One
// block an SM either way.
//
// What bounds it on the card: 2.5 times the forward's operations (five
// S x T products a head against the forward's two; dq's pass recomputes
// S and dP, so seven are run), each split product three TF32 products:
// ~1.0e10 f32 operations at smollm-360m's training shape (B = 8, S = 512,
// 15/5 heads of 64, causal), 0.15 ms at the 67 TFLOP/s f32 rate of the
// bound's convention, ~0.06 ms as 3 x TF32 at 495 TFLOP/s.  With one
// 8-warp block an SM the kernels wait on latency (the fragment loads and
// splits between the products) more than on the tensor cores
// (ablations.py --body bwd32 times the splits' and the fold's
// share).
//
// Rounding: q and the scores in f32, P = exp(S - lse) as 2^(S log2 e -
// lse log2 e) on ex2.approx.ftz, P and dS in f32 as split operands,
// accumulators in f32, each gradient written once (dq and dk times the
// scale at the end).

#pragma once

#include <climits>

#include "prefill_tf32.cuh"

namespace kern {
namespace bwd_tf32 {

using prefill_tf32::kLog2e;
using prefill_tf32::mma3;
using prefill_tf32::split_tf32_int;

constexpr int kWarps = 8;                // warps a block, both passes
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;       // dq: packed rows a block
constexpr int kStages = 2;

// rows of the tiles that stream through the rings (dq: keys; dk/dv:
// queries): 32 at head_dim 64, 16 at 128, where dq's ring of split
// 32-key tiles would not fit beside its 128 rows of q and dout, and
// dk/dv's warps spill at 32
template <int kHd>
__host__ __device__ constexpr int tile_rows() {
  return kHd > 64 ? 16 : 32;
}

// The operands: q (B, S, H, kHd), k and v (B, T, KV, kHd), dout (B, S,
// H, kHd); lse and delta (B, H, S).
struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* delta;
  int S, T, H, KV, causal, window;
  float scale;
};

// -- split tiles and fragments ------------------------------------------------

// The 4 values of a 16-byte chunk at hi, split: hi = tf32(x) in place and
// lo = tf32(x - hi) at the same offset of the lo plane
__device__ __forceinline__ void split_chunk(float* hi, float* lo) {
  const float4 x = *reinterpret_cast<const float4*>(hi);
  uint4 h, l;
  split_tf32_int(x.x, h.x, l.x);
  split_tf32_int(x.y, h.y, l.y);
  split_tf32_int(x.z, h.z, l.z);
  split_tf32_int(x.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(lo) = l;
}

// ldmatrix of 32-bit elements: matrix j (lanes 8j .. 8j + 7 give its 8
// rows of 4 values) lands in r[j], thread t holding row t / 4, value t % 4
// -- the m16n8k8 tf32 fragment layout
__device__ __forceinline__ void ldsm4(const float* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
// A fragment of depth step kk of the 16 rows at t: (gr, tc), (gr + 8,
// tc), (gr, tc + 4), (gr + 8, tc + 4) of columns kk * 8 ..
__device__ __forceinline__ void frag_a(const float* t, int ld, int kk,
                                       uint32_t (&a)[4]) {
  const int lane = threadIdx.x % 32;
  ldsm4(t + (lane % 8 + 8 * (lane / 8 % 2)) * ld + kk * 8 + 4 * (lane / 16),
        a);
}
// B fragments of tiles n and n + 1 (rows n * 8 .. of Y, the product takes
// Y^T) at depth step kk: b[0], b[1] tile n's, b[2], b[3] tile n + 1's
__device__ __forceinline__ void frag_b2(const float* y, int ld, int n, int kk,
                                        uint32_t (&b)[4]) {
  const int lane = threadIdx.x % 32;
  ldsm4(y + ((n + lane / 16) * 8 + lane % 8) * ld + kk * 8 +
            4 * (lane / 8 % 2),
        b);
}

// -- warp products -----------------------------------------------------------

// The products issue their mma.sync instructions in passes over groups of
// up to kGroup 8-column tiles (prefill_tf32.cuh's mma3): Alo.Bhi for each
// tile of the group, then Ahi.Blo, then Ahi.Bhi, so that consecutive
// instructions write different accumulators and one's latency hides
// behind the next (a tile's three in a row wait on each other).
constexpr int kGroup = 4;

// c (16 x kN) = A . Y^T: A the 16 rows at a (f32, split here, stride lda),
// Y the kN rows of the split planes y_hi, y_lo (stride ldy), both kDepth
// columns deep.  Accumulator (n, e) is row gr + 8 * (e / 2), column n * 8
// + 2 * tc + e % 2.
template <int kDepth, int kN, int kG = (kN / 8 < kGroup ? kN / 8 : kGroup)>
__device__ __forceinline__ void mm_rows(float (&c)[kN / 8][4], const float* a,
                                        int lda, const float* y_hi,
                                        const float* y_lo, int ldy) {
  static_assert(kN % (8 * kG) == 0 && kG % 2 == 0, "whole groups of tiles");
#pragma unroll
  for (int n = 0; n < kN / 8; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kDepth / 8; ++kk) {
    uint32_t ah[4], al[4];
    frag_a(a, lda, kk, ah);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_tf32_int(__uint_as_float(ah[e]), ah[e], al[e]);
#pragma unroll
    for (int n0 = 0; n0 < kN / 8; n0 += kG) {
      uint32_t bh[kG][2], bl[kG][2];
#pragma unroll
      for (int n = 0; n < kG; n += 2) {
        uint32_t r[4];
        frag_b2(y_hi, ldy, n0 + n, kk, r);
        bh[n][0] = r[0], bh[n][1] = r[1], bh[n + 1][0] = r[2],
        bh[n + 1][1] = r[3];
        frag_b2(y_lo, ldy, n0 + n, kk, r);
        bl[n][0] = r[0], bl[n][1] = r[1], bl[n + 1][0] = r[2],
        bl[n + 1][1] = r[3];
      }
      // a tile's chain, hd / 8 steps from zero: on the tensor cores
      mma3<false, kG>(c + n0, ah, al, bh, bl);
    }
  }
}

// c (16 x kN) += X . Y: X (16 x kK) an accumulator tile in registers (split
// here), Y the kK rows of the split planes y_hi, y_lo (stride ldy), kN
// columns wide.  Depth step kk takes X's group kk with its columns in the
// order 0, 2, 4, 6, 1, 3, 5, 7: A elements (x0, x2, x1, x3) of the group,
// B rows kk * 8 + 2 * tc and + 1 (column loads: ldmatrix does not
// transpose 32-bit elements).  Each step's products are summed from zero
// and added to c on the CUDA cores (mma3's fold).
template <int kK, int kN>
__device__ __forceinline__ void mm_cols(float (*c)[4],
                                        const float (&x)[kK / 8][4],
                                        const float* y_hi, const float* y_lo,
                                        int ldy) {
  static_assert(kN % (8 * kGroup) == 0, "whole groups of tiles");
  const int lane = threadIdx.x % 32, gr = lane / 4, tc = lane % 4;
  const int at = 2 * tc * ldy + gr;
#pragma unroll
  for (int kk = 0; kk < kK / 8; ++kk) {
    uint32_t ah[4], al[4];
    split_tf32_int(x[kk][0], ah[0], al[0]);
    split_tf32_int(x[kk][2], ah[1], al[1]);
    split_tf32_int(x[kk][1], ah[2], al[2]);
    split_tf32_int(x[kk][3], ah[3], al[3]);
#pragma unroll
    for (int n0 = 0; n0 < kN / 8; n0 += kGroup) {
      uint32_t bh[kGroup][2], bl[kGroup][2];
#pragma unroll
      for (int n = 0; n < kGroup; ++n) {
        const int o = at + kk * 8 * ldy + (n0 + n) * 8;
        bh[n][0] = __float_as_uint(y_hi[o]);
        bh[n][1] = __float_as_uint(y_hi[o + ldy]);
        bl[n][0] = __float_as_uint(y_lo[o]);
        bl[n][1] = __float_as_uint(y_lo[o + ldy]);
      }
      mma3<true, kGroup>(c + n0, ah, al, bh, bl);
    }
  }
}

// A warp's 16 x kN f32 accumulator times mul to rows row(r) (r < 16; a
// null row is dropped), each thread's column pairs as 8-byte stores
template <int kN, typename Dst>
__device__ __forceinline__ void store_acc(const float (*acc)[4], float mul,
                                          Dst row) {
  const int lane = threadIdx.x % 32, gr = lane / 4, tc = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* d = row(gr + 8 * h);
    if (!d) continue;
#pragma unroll
    for (int n = 0; n < kN / 8; ++n)
      *reinterpret_cast<float2*>(d + n * 8 + 2 * tc) =
          make_float2(acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
  }
}

// -- delta = rowsum(dout * out) ---------------------------------------------

template <int kHd>
__global__ void __launch_bounds__(256)
delta_kernel(const float* __restrict__ out, const float* __restrict__ dout,
             float* __restrict__ delta, int B, int S, int H) {
  constexpr int kLanes = kHd / 4;  // one 16-byte chunk a lane
  static_assert(32 % kLanes == 0, "a row's lanes share a warp");
  const size_t row = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  const int c = threadIdx.x % kLanes;
  const size_t n_rows = (size_t)B * S * H;
  float sum = 0.f;
  if (row < n_rows) {
    const float4 o = *reinterpret_cast<const float4*>(out + row * kHd + c * 4);
    const float4 d = *reinterpret_cast<const float4*>(dout + row * kHd + c * 4);
    sum = fmaf(o.x, d.x, fmaf(o.y, d.y, fmaf(o.z, d.z, o.w * d.w)));
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

// -- dk, dv -----------------------------------------------------------------

// A dk/dv block's 8 warps: warp w < 4 (the P role) takes keys k0 + 16 w ..
// + 15: S^T, P^T and dV; warp w + 4 (the dS role) the same keys: dP^T,
// dS^T and dK.  Each warp holds one accumulator of hd / 2 f32 a thread,
// not two.
constexpr int kKeys = 64;   // keys a dk/dv block

template <int kHd>
__host__ __device__ constexpr int kv_stage_floats() {
  // q and dout tiles, each as hi and lo planes, then lse and delta
  return 4 * tile_rows<kHd>() * (kHd + 4) + 2 * tile_rows<kHd>();
}

template <int kHd>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(Args p, float* __restrict__ dk, float* __restrict__ dv) {
  constexpr int kTile = tile_rows<kHd>();
  constexpr int kLd = kHd + 4;
  constexpr int kPlane = kTile * kLd;
  constexpr int kLdX = kTile + 4;   // exchange row stride
  constexpr int kChunks = kHd / 4;  // 16-byte chunks a row
  constexpr int kStage = kv_stage_floats<kHd>();
  constexpr int kLoads = kTile * kChunks / kThreads;   // a q or dout tile
  constexpr int kKLoads = kKeys * kChunks / kThreads;  // K or V rows
  static_assert(kLoads * kThreads == kTile * kChunks &&
                    kKLoads * kThreads == kKeys * kChunks &&
                    kThreads >= 2 * kTile && kWarps == 2 * kKeys / 16,
                "uneven loads");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);  // this block's K rows
  float* v_s = k_s + kKeys * kLd;                    // and V rows
  float* x_s = v_s + kKeys * kLd;  // P^T of the step, keys x queries
  // per stage: q hi, q lo, dout hi, dout lo, lse, delta
  float* ring = x_s + kKeys * kLdX;

  const int b = blockIdx.x, kvh = blockIdx.y, k0 = blockIdx.z * kKeys;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tc = lane % 4;
  const bool p_role = warp < kWarps / 2;
  const int kw = warp % (kWarps / 2);  // the warp's key group
  const int S = p.S, T = p.T, H = p.H, KV = p.KV, G = H / KV;
  const int causal = p.causal, window = p.window;
  const float sl2 = p.scale * kLog2e;
  // the queries that see a key of this block, in tiles of kTile
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S - 1, k0 + kKeys - 1 + window - 1)
                              : S - 1;
  const int n_q = q_hi >= q_lo ? (q_hi - q_lo) / kTile + 1 : 0;
  const int n_steps = G * n_q;

  auto stage_at = [&](int stage) { return ring + stage * kStage; };
  auto load_step = [&](int step, int stage) {
    const int h = kvh * G + step / n_q, q0 = q_lo + (step % n_q) * kTile;
    float* qs = stage_at(stage);
    float* ds = qs + 2 * kPlane;
    float* ls = ds + 2 * kPlane;
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int i = tid + it * kThreads;
      const int j = i / kChunks, c = i - j * kChunks;
      const bool in = q0 + j < S;
      const size_t at =
          (((size_t)b * S + (in ? q0 + j : 0)) * H + h) * kHd + c * 4;
      cp_async16(smem_addr(qs + j * kLd + c * 4), p.q + at, in);
      cp_async16(smem_addr(ds + j * kLd + c * 4), p.dout + at, in);
    }
    // thread tid < 2 * kTile copies lse (tid < kTile) or delta of query
    // q0 + tid % kTile
    if (tid < 2 * kTile) {
      const int j = tid % kTile;
      const bool in = q0 + j < S;
      cp_async4(smem_addr(ls + tid),
                (tid < kTile ? p.lse : p.delta) + ((size_t)b * H + h) * S +
                    (in ? q0 + j : 0),
                in);
    }
  };
  // after its wait, a thread splits the chunks it copied (hi in place, lo
  // to the lo plane) and takes its lse to log2 units
  auto finish_step = [&](int stage) {
    float* qs = stage_at(stage);
    float* ds = qs + 2 * kPlane;
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int i = tid + it * kThreads;
      const int j = i / kChunks, c = i - j * kChunks;
      split_chunk(qs + j * kLd + c * 4, qs + kPlane + j * kLd + c * 4);
      split_chunk(ds + j * kLd + c * 4, ds + kPlane + j * kLd + c * 4);
    }
    float* ls = ds + 2 * kPlane;
    if (tid < kTile) ls[tid] = __fmul_rn(ls[tid], kLog2e);
  };

  // this block's K and V rows (keys past T zero), with the first step
  const int kw0 = k0 + kw * 16;  // this warp's 16 keys
#pragma unroll
  for (int it = 0; it < kKLoads; ++it) {
    const int i = tid + it * kThreads;
    const int j = i / kChunks, c = i - j * kChunks;
    const bool in = k0 + j < T;
    const size_t at =
        (((size_t)b * T + (in ? k0 + j : 0)) * KV + kvh) * kHd + c * 4;
    cp_async16(smem_addr(k_s + j * kLd + c * 4), p.k + at, in);
    cp_async16(smem_addr(v_s + j * kLd + c * 4), p.v + at, in);
  }
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_steps) load_step(st, st);
    cp_async_commit();
  }

  float acc[kHd / 8][4];  // dV (P role) or dK / scale (dS role)
#pragma unroll
  for (int n = 0; n < kHd / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // this thread's P^T pairs in the exchange: row gr (+ 8), query pair
  // n * 8 + 2 * tc
  float* xp = x_s + (kw * 16 + gr) * kLdX + 2 * tc;

  for (int it = 0; it < n_steps; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of step it
    finish_step(it % kStages);
    // everyone's; the stage refilled next and the exchange are free
    __syncthreads();
    if (it + kStages - 1 < n_steps)
      load_step(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();

    const int q0 = q_lo + (it % n_q) * kTile;
    // the warp's keys see none of these queries, or lie past T (the same
    // for both roles of a key group)
    const bool skip = kw0 >= T || (causal && q0 + kTile - 1 < kw0) ||
                      (window > 0 && q0 > kw0 + 15 + window - 1);
    const float* qs = stage_at(it % kStages);
    const float* ds = qs + 2 * kPlane;
    const float* ls = ds + 2 * kPlane;
    const float* dls = ls + kTile;

    // S^T = scale K Q^T (16 keys x kTile queries) and P^T = exp(S^T -
    // lse), masked pairs 0, to the exchange (P role); dP^T = V dO^T (dS
    // role)
    float x[kTile / 8][4];
    if (!skip) {
      if (p_role) {
        mm_rows<kHd, kTile>(x, k_s + kw * 16 * kLd, kLd, qs, qs + kPlane,
                            kLd);
        const bool full = (!causal || q0 >= kw0 + 15) &&
                          (window <= 0 ||
                           q0 + kTile - 1 <= kw0 + window - 1) &&
                          q0 + kTile <= S;
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = n * 8 + 2 * tc + e % 2;  // query q0 + c
            bool vis = true;
            if (!full) {
              const int q = q0 + c, key = kw0 + gr + 8 * (e / 2);
              vis = q < S && (!causal || q >= key) &&
                    (window <= 0 || q < key + window);
            }
            x[n][e] = vis ? exp2_ftz(__fmul_rn(x[n][e], sl2) - ls[c]) : 0.f;
          }
          *reinterpret_cast<float2*>(xp + n * 8) =
              make_float2(x[n][0], x[n][1]);
          *reinterpret_cast<float2*>(xp + 8 * kLdX + n * 8) =
              make_float2(x[n][2], x[n][3]);
        }
      } else {
        mm_rows<kHd, kTile>(x, v_s + kw * 16 * kLd, kLd, ds, ds + kPlane,
                            kLd);
      }
    }
    __syncthreads();  // P^T in the exchange
    if (skip) continue;
    if (p_role) {
      mm_cols<kTile, kHd>(acc, x, ds, ds + kPlane, kLd);  // dV
    } else {
      // dS^T = P^T (dP^T - delta); dK += dS^T Q
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        const float2 p0 = *reinterpret_cast<const float2*>(xp + n * 8);
        const float2 p1 =
            *reinterpret_cast<const float2*>(xp + 8 * kLdX + n * 8);
        const float pt[4] = {p0.x, p0.y, p1.x, p1.y};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[n][e] = pt[e] * (x[n][e] - dls[n * 8 + 2 * tc + e % 2]);
      }
      mm_cols<kTile, kHd>(acc, x, qs, qs + kPlane, kLd);
    }
  }
  cp_async_wait<0>();

  // the group's sums: dk = scale * acc (dS role), dv (P role)
  float* base = p_role ? dv : dk;
  store_acc<kHd>(acc, p_role ? 1.f : p.scale, [=](int r) -> float* {
    const int key = kw0 + r;
    return key < T ? base + (((size_t)b * T + key) * KV + kvh) * kHd
                   : nullptr;
  });
}

// -- dq -----------------------------------------------------------------------

template <int kHd>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(Args p, float* __restrict__ dq) {
  constexpr int kTile = tile_rows<kHd>();
  constexpr int kLd = kHd + 4;
  constexpr int kPlane = kTile * kLd;
  constexpr int kChunks = kHd / 4;
  constexpr int kStage = 4 * kPlane;  // K hi, K lo, V hi, V lo
  constexpr int kLoads = kTile * kChunks / kThreads;   // a K or V tile
  constexpr int kQLoads = kRows * kChunks / kThreads;  // q or dout rows
  static_assert(kLoads * kThreads == kTile * kChunks &&
                    kQLoads * kThreads == kRows * kChunks,
                "uneven loads");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // the block's q rows
  float* do_s = q_s + kRows * kLd;                   // and dout rows
  float* ring = do_s + kRows * kLd;

  // row blocks in reverse: under a causal mask the last rows see the most
  // keys, and their blocks start first
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tc = lane % 4;
  const int S = p.S, T = p.T, H = p.H, KV = p.KV, G = H / KV;
  const int causal = p.causal, window = p.window;
  const float sl2 = p.scale * kLog2e;

  // the keys any row of this block sees
  const int t_first = r0 / G, t_last = min((r0 + kRows - 1) / G, S - 1);
  const int k_lo = window > 0 ? max(0, t_first - window + 1) : 0;
  const int k_hi = causal ? min(t_last, T - 1) : T - 1;
  const int n_tiles = k_hi >= k_lo ? (k_hi - k_lo) / kTile + 1 : 0;

  auto load_tile = [&](int tile, int stage) {
    const int k0 = k_lo + tile * kTile;
    float* ks = ring + stage * kStage;
    float* vs = ks + 2 * kPlane;
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int i = tid + it * kThreads;
      const int j = i / kChunks, c = i - j * kChunks;
      const bool in = k0 + j <= k_hi;
      const size_t at =
          (((size_t)b * T + (in ? k0 + j : 0)) * KV + kvh) * kHd + c * 4;
      cp_async16(smem_addr(ks + j * kLd + c * 4), p.k + at, in);
      cp_async16(smem_addr(vs + j * kLd + c * 4), p.v + at, in);
    }
  };
  // after its wait, a thread splits the chunks it copied
  auto finish_tile = [&](int stage) {
    float* ks = ring + stage * kStage;
    float* vs = ks + 2 * kPlane;
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int i = tid + it * kThreads;
      const int j = i / kChunks, c = i - j * kChunks;
      split_chunk(ks + j * kLd + c * 4, ks + kPlane + j * kLd + c * 4);
      split_chunk(vs + j * kLd + c * 4, vs + kPlane + j * kLd + c * 4);
    }
  };

  // the block's q and dout rows (rows past S * G zero), with the first
  // tile
#pragma unroll
  for (int it = 0; it < kQLoads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kChunks, c = i - r * kChunks;
    const int rg = r0 + r, t = rg / G, g = rg - t * G;
    const bool in = t < S;
    const size_t at =
        (((size_t)b * S + (in ? t : 0)) * H + kvh * G + g) * kHd + c * 4;
    cp_async16(smem_addr(q_s + r * kLd + c * 4), p.q + at, in);
    cp_async16(smem_addr(do_s + r * kLd + c * 4), p.dout + at, in);
  }
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }

  // this thread's two rows (gr and gr + 8 of the warp's 16): the keys each
  // sees [lo, hi], lse in log2 units and delta.  Rows past S * G take lse
  // = +inf (P = 0) and see everything.
  int lo[2], hi[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rg = r0 + warp * 16 + gr + 8 * h;
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
    if ((r0 + warp * 16 + gr + 8 * h) / G < S) top = max(top, hi[h]);
  const int warp_top = __reduce_max_sync(0xffffffffu, top);

  float acc[kHd / 8][4];  // dQ / scale
#pragma unroll
  for (int n = 0; n < kHd / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile it
    finish_tile(it % kStages);
    __syncthreads();  // everyone's (and q_s, do_s); the stage refilled is free
    if (it + kStages - 1 < n_tiles)
      load_tile(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    const int k0 = k_lo + it * kTile;
    if (!warp_active || k0 > warp_top) continue;
    const float* ks = ring + (it % kStages) * kStage;
    const float* vs = ks + 2 * kPlane;

    // S = scale Q K^T; P = exp(S - lse), masked keys 0
    float x[kTile / 8][4];
    mm_rows<kHd, kTile>(x, q_s + warp * 16 * kLd, kLd, ks, ks + kPlane, kLd);
    const bool edge = k0 < warp_lo || k0 + kTile - 1 > warp_hi;
    int c_lo[2], c_hi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      c_lo[h] = lo[h] - k0 - 2 * tc;
      c_hi[h] = hi[h] == INT_MAX ? INT_MAX : hi[h] - k0 - 2 * tc;
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + e % 2;
        x[n][e] = edge && (c < c_lo[e / 2] || c > c_hi[e / 2])
                      ? 0.f
                      : exp2_ftz(__fmul_rn(x[n][e], sl2) - lse2[e / 2]);
      }

    // dP = dO V^T; dS = P (dP - delta); dQ += dS K
    float y[kTile / 8][4];
    mm_rows<kHd, kTile>(y, do_s + warp * 16 * kLd, kLd, vs, vs + kPlane,
                        kLd);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[n][e] = x[n][e] * (y[n][e] - dl[e / 2]);
    mm_cols<kTile, kHd>(acc, y, ks, ks + kPlane, kLd);
  }
  cp_async_wait<0>();
  if (!warp_active) return;
  // dq = scale * acc
  store_acc<kHd>(acc, p.scale, [&](int r) -> float* {
    const int rg = r0 + warp * 16 + r, t = rg / G, g = rg - t * G;
    return t < S ? dq + (((size_t)b * S + t) * H + kvh * G + g) * kHd
                 : nullptr;
  });
}

// -- launch -------------------------------------------------------------------

template <int kHd>
constexpr size_t dkdv_smem() {
  // K and V rows, the P^T exchange, then the ring
  return sizeof(float) * (2 * kKeys * (kHd + 4) +
                          kKeys * (tile_rows<kHd>() + 4) +
                          kStages * kv_stage_floats<kHd>());
}
template <int kHd>
constexpr size_t dq_smem() {
  // q and dout rows, then the ring of split K and V tiles
  return sizeof(float) * (2 * kRows * (kHd + 4) +
                          kStages * 4 * tile_rows<kHd>() * (kHd + 4));
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The passes on stream st: delta from out (B, S, H, kHd), then dk and dv
// (B, T, KV, kHd), then dq (B, S, H, kHd).
template <int kHd>
int launch(const Args& p, int B, const float* out, float* delta, float* dq,
           float* dk, float* dv, cudaStream_t st) {
  constexpr size_t qs = dq_smem<kHd>(), ks = dkdv_smem<kHd>();
  cudaError_t e;
  if ((e = allow_smem(dq_kernel<kHd>, qs)) != cudaSuccess) return (int)e;
  if ((e = allow_smem(dkdv_kernel<kHd>, ks)) != cudaSuccess) return (int)e;
  const int S = p.S, T = p.T, H = p.H, G = H / p.KV;
  const size_t lanes = (size_t)B * S * H * (kHd / 4);
  delta_kernel<kHd><<<(unsigned)((lanes + 255) / 256), 256, 0, st>>>(
      out, p.dout, delta, B, S, H);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  Args a = p;
  a.delta = delta;
  dkdv_kernel<kHd><<<dim3(B, p.KV, (T + kKeys - 1) / kKeys), kThreads, ks,
                     st>>>(a, dk, dv);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dq_kernel<kHd><<<dim3(B, p.KV, (S * G + kRows - 1) / kRows), kThreads, qs,
                   st>>>(a, dq);
  return (int)cudaGetLastError();
}

}  // namespace bwd_tf32
}  // namespace kern
