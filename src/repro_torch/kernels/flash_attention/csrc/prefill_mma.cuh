// Blockwise attention of a chunk of query tokens over a row's K/V on
// Hopper's tensor cores (sm_90a): the bf16 body of paged_prefill.cu (K2)
// and flash_prefill.cu (B2's contiguous entry) at head_dim 64, 128 and
// 192 (nemotron-4-340b: q/k and V 192), and of B2's MLA entry
// (DeepSeek-V3: q/k 192 = 128 + 64, V 128).
// It takes the same row policy as prefill_body.cuh (q_pos0, n_keys, row,
// kRoundScores), so the paged and contiguous entries plug in unchanged,
// and computes the same function: query t of row b sits at position
// q_pos0(b) + t and sees key kpos iff kpos < n_keys(b), kpos <= its
// position (causal) and kpos > its position - window (window > 0); query
// head h reads KV head h / G.  f32 q at head_dim 64 and 128 runs its
// split TF32 twin (prefill_tf32.cuh); f32 at 192 and bf16 at any other
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
// ablations.py): K2 at T = 32 is latency: ~0.3 GFLOP over ~4 MB
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
// MLA's operands (a row policy with common.cuh's SplitK: kNope, kRope,
// kVd, rope(b, pos); launch_mla).  q (B, S, H, 192) is [q_nope | q_rope];
// K comes from two sources, k_nope (B, T, H, 128) read per head and the
// rope key (B, T, 64) that every head of a token shares: each 64-key K
// tile is assembled in shared memory from 16 chunks of the head's k_nope
// row and 8 of the token's rope row, so the rope key is never broadcast
// in device memory (each head's block reads its 128 bytes a key from L2).
// V (B, T, H, 128) and the output (B, S, H, 128) keep their own head
// dim: the template takes kHd (q/k, 192) and kVd (V, 128) apart, and the
// P.V product, the accumulators (64 registers) and the epilogue are kVd
// wide.  One query head per K/V head (G = 1).  Resources: q fragments 48
// registers, accumulators 64, scores and P 48; ptxas reports 239
// registers and no spills (chip_smoke.py phase 2).  Blocks of 8 warps
// (128 rows: every K/V tile filled from L2 serves twice the rows of a
// 4-warp block; ablations.py measured the 4-warp fill bound by L2,
// ~1.5 GB at ~6.4 TB/s at S = 512) run one a SM by registers, so q is
// staged in a region after the 2-stage ring (134 KB in all), and a warp
// skips the tiles past its own rows' positions.  Grid (B, H, row blocks)
// as for GQA (launching each (row, head)'s row blocks together measured
// slower).  What bounds it: the math between the two products, as at
// head_dim 128 (ablations.py: at B = 8, S = 512 the math alone
// takes 0.53 of the body's 0.62 ms, the loads alone 0.40, q and the
// output alone 0.14).  q's fragments read from shared memory at each
// head-dim step (48 registers freed), a 3-stage ring and the Q.K^T loop
// with the head-dim steps outside measured no faster.  mma.sync meets the
// criteria this body was built for (<= 2.5x SDPA), so it stays on it.
//
// Head_dim 192 with V as wide (nemotron-4-340b, 96/8 heads: G = 12).
// The output accumulators take 96 f32 a thread; q's fragments held
// beside them (48) and the score tile and P (48) would leave too few of
// the 255 registers for the addresses, so at V 192 (q_in_regs) q stays
// in a shared region of its own after the ring and each key tile reads
// one A fragment of it per head-dim step (the Q.K^T loop runs the
// head-dim steps outside, so each fragment is read once a tile).  Blocks
// of 8 warps (128 rows, ~11 tokens of the 12-head group), as MLA's: each
// 64-key tile serves twice the rows of a 4-warp block; a 2-stage ring
// of 51 KB stages and q's 51 KB, 154 KB in all, one block an SM.
// chip_smoke.py phase 2 logs registers and spills.
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

// q's A fragments (kHd / 4 registers a thread) are held in registers for
// the whole key walk where they fit beside the output accumulators (kVd
// / 2); at V 192 they are reread from shared memory at each key tile
template <int kHd, int kVd>
__host__ __device__ constexpr bool q_in_regs() {
  return kVd <= 128;
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

// a ring stage holds a K tile of kHd columns and a V tile of kVd, each
// row with a 16-byte pad
template <int kHd, int kVd>
__host__ __device__ constexpr int stage_elems() {
  return kKeyTile * ((kHd + 8) + (kVd + 8));
}
// q (kWarps * 16 rows of kHd + 8) is staged in the ring's last stage
// until the first tile lands there, or after the ring where it does not
// fit a stage or is read at every tile (q_in_regs false)
template <int kHd, int kVd, int kWarps>
__host__ __device__ constexpr bool q_after_ring() {
  return !q_in_regs<kHd, kVd>() ||
         kWarps * 16 * (kHd + 8) > stage_elems<kHd, kVd>();
}
template <int kHd, int kVd, int kStages, int kWarps>
constexpr size_t smem_bytes() {
  return sizeof(bf16) *
         (kStages * stage_elems<kHd, kVd>() +
          (q_after_ring<kHd, kVd, kWarps>() ? kWarps * 16 * (kHd + 8) : 0));
}

constexpr float kLog2e = 1.4426950408889634f;

// kLse: the epilogue also stores each row's logsumexp (natural log, f32,
// (B, H, S); +inf for a row that sees no key), which B2's backward
// (backward_mma.cuh) takes instead of recomputing it.  The served entries
// instantiate kLse = false: their code is the body's without it.
template <typename Rows, int kHd, int kVd, int kStages, int kWarps,
          bool kLse = false>
__global__ void __launch_bounds__(kWarps * 32)
prefill_mma_kernel(const bf16* __restrict__ q,  // (B, S, H, kHd)
                   // slabs of (KV, kHd), or (H, kNope) for MLA; see Rows
                   const bf16* __restrict__ k,
                   const bf16* __restrict__ v,  // slabs of (KV, kVd)
                   bf16* __restrict__ out,      // (B, S, H, kVd)
                   Rows rows, int S, int H, int KV, int causal, int window,
                   float scale,
                   float* __restrict__ lse) {   // (B, H, S) with kLse

  constexpr int kRope = SplitK<Rows>::kRope;  // K columns from rows.rope
  constexpr int kThreads = kWarps * 32;
  constexpr int kRows = kWarps * 16;  // score rows per block, 16 a warp
  // a block whose rows span more than a key tile: each warp skips the
  // tiles past its own rows (all masked under the causal mask)
  constexpr bool kWarpSkip = kRows > kKeyTile;
  constexpr int kLd = kHd + 8;        // K (and q) shared row stride: 16-byte pad
  constexpr int kLdV = kVd + 8;       // V (and output) shared row stride
  constexpr int kChunks = kHd / 8;    // 16-byte chunks per K row
  constexpr int kVChunks = kVd / 8;   // and per V row
  constexpr int kTile = kKeyTile * kLd;
  constexpr int kStage = kTile + kKeyTile * kLdV;
  constexpr int kLoads = kKeyTile * kChunks / kThreads;
  constexpr int kVLoads = kKeyTile * kVChunks / kThreads;
  constexpr int kQLoads = kRows * kChunks / kThreads;
  constexpr bool kQRegs = q_in_regs<kHd, kVd>();
  static_assert(kHd % 16 == 0 && kVd % 16 == 0 && kStages >= 2, "bad tile");
  static_assert(kLoads * kThreads == kKeyTile * kChunks &&
                    kVLoads * kThreads == kKeyTile * kVChunks &&
                    kQLoads * kThreads == kRows * kChunks,
                "uneven loads");
  static_assert(kRope == 0 || (kRope + SplitK<Rows>::kNope == kHd &&
                               SplitK<Rows>::kVd == kVd),
                "MLA rows must match the instantiation");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // stage s: K, then V

  // row blocks in reverse: under a causal mask the last rows see the most
  // keys, and their blocks start first
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = H / KV;
  const int pos0 = rows.q_pos0(b), n_keys = rows.n_keys(b);
  const size_t q_row = (size_t)H * kHd;  // elements per token of q
  const size_t o_row = (size_t)H * kVd;  // and of out

  // the keys any row of this block sees: from the first row's window
  // start to the last row's position
  const int t_first = r0 / G;
  const int t_last = min((r0 + kRows - 1) / G, S - 1);
  const int k_lo = window > 0 ? max(0, pos0 + t_first - window + 1) : 0;
  const int k_hi = causal ? min(pos0 + t_last, n_keys - 1) : n_keys - 1;
  const int n_tiles = k_hi >= k_lo ? (k_hi - k_lo) / kKeyTile + 1 : 0;

  auto load_tile = [&](int tile, int stage) {
    const int k0 = k_lo + tile * kKeyTile;
    bf16* ks = ring + stage * kStage;
    bf16* vs = ks + kTile;
    if constexpr (kRope == 0 && kVd == kHd) {
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
    } else {
      // the K row assembled from two sources: kNope columns of the head's
      // slab, then the token's shared rope key; V rows kVd wide
      constexpr int kNopeChunks = (kHd - kRope) / 8;
#pragma unroll
      for (int it = 0; it < kLoads; ++it) {
        const int i = tid + it * kThreads;
        const int j = i / kChunks, c = i - j * kChunks;
        const bool in = k0 + j <= k_hi;
        const int pos = in ? k0 + j : 0;
        const bf16* src =
            c < kNopeChunks
                ? k + (rows.row(b, pos) * KV + kvh) * (kHd - kRope) + c * 8
                : rows.rope(b, pos) + (c - kNopeChunks) * 8;
        cp_async16(smem_addr(ks + j * kLd + c * 8), src, in);
      }
#pragma unroll
      for (int it = 0; it < kVLoads; ++it) {
        const int i = tid + it * kThreads;
        const int j = i / kVChunks, c = i - j * kVChunks;
        const bool in = k0 + j <= k_hi;
        const size_t off =
            in ? (rows.row(b, k0 + j) * KV + kvh) * kVd + c * 8 : 0;
        cp_async16(smem_addr(vs + j * kLdV + c * 8), v + off, in);
      }
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
  // the last key any row of this warp sees (kWarpSkip)
  int warp_top = INT_MAX;
  if constexpr (kWarpSkip) {
    int top = -1;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if ((r0 + warp * 16 + lane / 4 + 8 * h) / G < S) top = max(top, hi[h]);
    warp_top = __reduce_max_sync(0xffffffffu, top);
  }

  // the first tiles load while q is staged
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }

  // q * scale, rounded to bf16, in the last stage until the first tile
  // lands there (rows past S * G are zero); all loads in flight at once
  bf16* q_s = ring + (q_after_ring<kHd, kVd, kWarps>() ? kStages
                                                          : kStages - 1) *
                         kStage;
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

  // A fragments of this warp's 16 rows of q, held in registers (kQRegs)
  uint32_t qf[kQRegs ? kHd / 16 : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk)
      ldmatrix_x4(smem_addr(q_s + (warp * 16 + lane % 16) * kLd + kk * 16 +
                            (lane / 16) * 8),
                  qf[kk]);
  }

  float o[kVd / 8][4];  // output accumulators: kVd columns in 8-wide tiles
#pragma unroll
  for (int n = 0; n < kVd / 8; ++n)
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
    const int k0 = k_lo + it * kKeyTile;
    if (!warp_active || (kWarpSkip && k0 > warp_top)) continue;
    const bf16* ks = ring + (it % kStages) * kStage;
    const bf16* vs = ks + kTile;

    // S = Q K^T: 16 rows x 64 keys in 8 accumulator tiles of 8 keys
    float s[kKeyTile / 8][4];
#pragma unroll
    for (int n = 0; n < kKeyTile / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if constexpr (kQRegs) {
#pragma unroll
      for (int np = 0; np < kKeyTile / 16; ++np) {
#pragma unroll
        for (int kk = 0; kk < kHd / 16; ++kk) {
          uint32_t kb[4];  // keys np*16 + 0..7 and + 8..15, hd kk*16 + 0..15
          ldmatrix_x4(
              smem_addr(ks + (np * 16 + lane % 8 + (lane / 16) * 8) * kLd +
                        kk * 16 + (lane / 8 % 2) * 8),
              kb);
          mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
        }
      }
    } else {
      // q's fragment kk read once a tile, every key block against it
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk) {
        uint32_t qa[4];
        ldmatrix_x4(smem_addr(q_s + (warp * 16 + lane % 16) * kLd + kk * 16 +
                              (lane / 16) * 8),
                    qa);
#pragma unroll
        for (int np = 0; np < kKeyTile / 16; ++np) {
          uint32_t kb[4];
          ldmatrix_x4(
              smem_addr(ks + (np * 16 + lane % 8 + (lane / 16) * 8) * kLd +
                        kk * 16 + (lane / 8 % 2) * 8),
              kb);
          mma_bf16(s[2 * np], qa, kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        }
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
      for (int n = 0; n < kVd / 8; ++n) {
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
      for (int np = 0; np < kVd / 16; ++np) {
        uint32_t vb[4];  // keys kk*16 + 0..15, vd np*16 + 0..7 and + 8..15
        ldmatrix_x4_trans(
            smem_addr(vs + (kk * 16 + lane % 8 + (lane / 8 % 2) * 8) * kLdV +
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
  if constexpr (kLse) {
    // m is the row's largest score (natural units; ml holds it times
    // log2 e) and l the sum of exp(s - m) over its keys; a row whose
    // max is still kNeg saw no key
    if (lane % 4 == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rg = r0 + warp * 16 + lane / 4 + 8 * h;
        const int t = rg / G, g = rg - t * G;
        if (t < S)
          lse[((size_t)b * H + kvh * G + g) * S + t] =
              m[h] == kNeg ? INFINITY : m[h] + logf(l[h]);
      }
  }
  bf16* o_s = ring + warp * 16 * kLdV;
  const float den0 = fmaxf(l[0], 1e-30f), den1 = fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int n = 0; n < kVd / 8; ++n) {
    bf16* p = o_s + (lane / 4) * kLdV + n * 8 + 2 * (lane % 4);
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(o[n][0] / den0, o[n][1] / den0);
    *reinterpret_cast<uint32_t*>(p + 8 * kLdV) =
        pack_bf16(o[n][2] / den1, o[n][3] / den1);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * kVChunks; i += 32) {
    const int r = i / kVChunks, c = i - r * kVChunks;
    const int rg = r0 + warp * 16 + r, t = rg / G, g = rg - t * G;
    if (t < S)
      *reinterpret_cast<uint4*>(out + ((size_t)b * S + t) * o_row +
                                ((size_t)kvh * G + g) * kVd + c * 8) =
          *reinterpret_cast<const uint4*>(o_s + r * kLdV + c * 8);
  }
}

template <typename Rows, int kHd, int kVd, int kStages, int kWarps,
          bool kLse = false>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              Rows rows, int B, int S, int H, int KV, int causal, int window,
              float scale, void* stream, float* lse = nullptr) {
  constexpr int kRows = kWarps * 16;
  constexpr size_t smem = smem_bytes<kHd, kVd, kStages, kWarps>();
  auto kernel = prefill_mma_kernel<Rows, kHd, kVd, kStages, kWarps, kLse>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B, KV, (S * (H / KV) + kRows - 1) / kRows);
  kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, rows, S, H,
      KV, causal, window, scale, lse);
  return (int)cudaGetLastError();
}

// bf16 q, K, V and output; head_dim 64 (a ring of 3 stages, 54 KB of
// shared memory) or 128 (2 stages, 68 KB), 4 warps a block; 192 (V 192:
// 8 warps, 2 stages and q after the ring, 154 KB); any other head_dim is
// refused (cudaErrorInvalidValue), the wrappers never send one.  At 64
// and 128, deeper rings, 8-warp blocks and 32 rows a warp measured no
// faster at the served shapes (PERF.md §6).
// With kLse, each row's logsumexp into lse (B, H, S) besides.
template <typename Rows, bool kLse = false>
int launch(const void* q, const void* k, const void* v, void* out, Rows rows,
           int B, int S, int H, int KV, int hd, int causal, int window,
           float scale, void* stream, float* lse = nullptr) {
  if (hd == 64)
    return launch_hd<Rows, 64, 64, 3, 4, kLse>(
        q, k, v, out, rows, B, S, H, KV, causal, window, scale, stream, lse);
  if (hd == 128)
    return launch_hd<Rows, 128, 128, 2, 4, kLse>(
        q, k, v, out, rows, B, S, H, KV, causal, window, scale, stream, lse);
  if (hd == 192)
    return launch_hd<Rows, 192, 192, 2, 8, kLse>(
        q, k, v, out, rows, B, S, H, KV, causal, window, scale, stream, lse);
  return (int)cudaErrorInvalidValue;
}

// MLA's operands (Rows with kNope, kRope, kVd; DeepSeek-V3's 128 + 64 and
// 128): q (B, S, H, kNope + kRope), k the (H, kNope) slabs, the rope key
// through rows.rope, V the (H, kVd) slabs, out (B, S, H, kVd); one K/V
// head per query head; causal, no window (MLA's prefill is causal
// only).  Blocks of kMlaWarps warps (128 rows: each K/V tile filled from
// L2 serves twice the rows of a 4-warp block), one a SM by registers, a
// ring of kMlaStages stages and q staged after it.
constexpr int kMlaWarps = 8, kMlaStages = 2;
template <typename Rows, bool kLse = false>
int launch_mla(const void* q, const void* k, const void* v, void* out,
               Rows rows, int B, int S, int H, float scale, void* stream,
               float* lse = nullptr) {
  using D = SplitK<Rows>;
  static_assert(D::kRope > 0, "launch_mla takes MLA rows");
  return launch_hd<Rows, D::kNope + D::kRope, D::kVd, kMlaStages, kMlaWarps,
                   kLse>(q, k, v, out, rows, B, S, H, H, 1, 0, scale, stream,
                         lse);
}

}  // namespace prefill_mma
}  // namespace kern
