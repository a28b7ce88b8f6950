// One-token attention over a row's K/V on Hopper's tensor cores (sm_90a)
// for grouped query heads: the body of paged_decode.cu's
// paged_decode_attention_bf16_bf16_mma and _f32_f32_tf32 (K1), of
// dense_decode.cu's decode_attention_bf16_bf16_mma and _f32_f32_tf32 (B4)
// and of paged_decode_quant.cu's paged_decode_attention_quant_f32_tf32
// (B3: f32 q over int8 pools with per-row f32 scales), which ops.py's
// decode_entry and quant_decode_entry pick for G = H / KV query heads a
// K/V head up to 16 at head_dim 64, 128 and 192.  It takes the same row
// policy as decode_body.cuh (n_keys, row, kRoundScores) and scales policy
// (common.cuh: NoScales, RowScales) and computes the same function: query
// head h reads KV head h / G over the keys kpos < n_keys(b) of its row.
//
// Replaces, with decode_body.cuh, src/repro/kernels/decode_attention/
// kernel.py::paged_decode_attention (K1), ::decode_attention (B4) and
// ::paged_decode_attention_quant (B3).
//
// What bounds it on the card: bytes.  Each valid key costs one K and one
// V row of hd elements (2 * hd * 2 bytes in bf16) against 4 * G * hd
// operations, at G = 16 ~16 operations a byte, far under the H100's ~295.
// decode_body.cuh scores with one lane a key (a serial hd-long chain of
// multiply-adds) and forms P.V on the CUDA cores, 2 * G * hd scalar
// multiply-adds a key between two block barriers a tile: at G >= 8 that
// arithmetic, not the bytes, sets its time.  Here the tensor cores do it:
//   * one block of kWarps warps per (row, KV head, split of the key range)
//     as in decode_body.cuh.  The group's G <= 16 query heads are the 16
//     rows of the MMA; rows G..15 are zero and their outputs dropped;
//   * each warp walks its own contiguous run of kKeys-key tiles with its
//     own online softmax (m, l and the output fragments in registers) and
//     its own ring of kStages stages, filled with cp.async, as
//     decode_mla.cuh's warps do: no block barrier inside the key loop, a
//     warp waits for its own copies (cp.async.wait_group, then __syncwarp
//     for its lanes' copies of the tile);
//   * bf16: S = Q.K^T and O += P.V are mma.sync.m16n8k16 with f32
//     accumulators; K fragments by ldmatrix, V by ldmatrix.trans from
//     rows padded by 16 bytes (conflict-free), as in prefill_mma.cuh; P
//     is the score accumulator repacked to bf16 in registers as the A
//     operand of P.V, never through shared memory.  q * scale (bf16) sits
//     in shared memory; its A fragments stay in registers at head_dim 64
//     and 128 and are reread at each k-step at 192, where the output's 96
//     f32 a thread leave no room for them (prefill_mma.cuh does the same);
//   * f32: split TF32, mma.sync.m16n8k8 with three products a step
//     (Alo.Bhi + Ahi.Blo + Ahi.Bhi) and each k8 step's products summed
//     apart before they are added (prefill_tf32.cuh's mma3 with kFold, its
//     integer splits): f32 accuracy, within 1e-5 of the plain version.
//     Tiles of 8 keys at head_dim 128 and 192 (one k8 step of P.V), so
//     that rows twice as wide as bf16's keep two blocks an SM.  The score
//     accumulator of an 8-key group is the A fragment of P.V with its keys
//     in the order 0, 2, 4, 6, 1, 3, 5, 7 (prefill_tf32.cuh's trick); q, K
//     and V fragments are read from padded rows;
//   * int8 K/V (B3): the tiles stay int8 in the ring (a quarter of the
//     f32 bytes) with each key's two f32 row scales copied beside them,
//     and the fragments are widened in registers: a lane's 32-bit shared
//     load holds four int8 values, each made an exact f32 by placing its
//     biased byte in the mantissa of 2^23 (prmt) and taking 2^23 + 128 off
//     (widen_int8).  An int8 value is exact in TF32, so each k8 step is two
//     products, Alo.B + Ahi.B (mma2, summed apart): q * scale is split once
//     into TF32 hi and lo planes in shared memory, the probability times
//     its V row's scale at each tile.  The score of a key is multiplied by
//     its K row's scale after the dot.  Both products walk a permuted
//     order that suits the int8 rows: the k8 steps of Q.K take the head
//     dim in the order a lane's 4-byte load of a K row holds it (q's
//     planes are read in the same order, one 16-byte load a row and step),
//     and P.V's output tiles take their columns in the order a lane's
//     4-byte load of a V row holds them (tile n's column j is head-dim
//     column 32 (n / 4) + 4 j + n % 4), undone when the accumulators are
//     stored.  Every such load of K, V or q falls on 32 distinct banks.
//     Blocks of 8 warps over 16-key tiles (4 ring stages at head_dim 64,
//     2 at 128 and 192): two warps an SM sub-partition hide each other's
//     latencies, which one warp a sub-partition (4 warps, one block an
//     SM) left exposed (ablations.py --body dec8);
//   * at the end the warps merge in shared memory, in warp order; the
//     splits write (m, l, acc) to the workspace and the last block of a
//     (row, KV head) combines them in split order, as decode_body.cuh
//     does.  Where every cluster of the grid can be resident at once with
//     one block an SM, up to kClusterMax = 8 splits of a (row, KV head)
//     are launched as one thread block cluster instead: each keeps its partial in shared
//     memory and, after a cluster barrier, combines its share of the
//     outputs from every split's in split order over distributed shared
//     memory (no workspace round trip, no counter).  Both merges give the
//     same bits.
//     Every sum runs in a fixed order: two launches give the same bits.
//
// Rounding follows the reference, as decode_body.cuh: q * scale in q's
// type; with kRoundScores (B4) the scores rounded to the promoted q/K type
// (bf16 for bf16 operands); the online softmax in f32 with -1e30 masking,
// exp(x - m) as 2^(x log2 e - m log2 e) on ex2.approx.ftz (each product
// rounded on its own, as prefill_mma.cuh); the probabilities rounded to
// the K/V type for P.V (relative to the warp's running max) while the sum
// l takes them unrounded; the output acc / max(l, 1e-30) in the K/V type
// (f32 for int8 pools).  int8 pools fold their scales in as
// decode_body.cuh does (one product a score and a probability, where the
// reference dequantizes each element): within f32's 1e-5 of the plain
// version.  A row with no keys outputs 0.

#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "../../csrc/common.cuh"
#include "../../flash_attention/csrc/prefill_mma.cuh"
#include "../../flash_attention/csrc/prefill_tf32.cuh"

namespace kern {
namespace decode_gqa {

using bf16 = __nv_bfloat16;
constexpr int kRows = 16;  // MMA rows: the group's query heads, G <= 16
constexpr int kSplitTile = 16;  // split_keys is a multiple of this
// up to this many splits of a (row, KV head) are launched as one thread
// block cluster and merged in distributed shared memory (the portable
// cluster size); more go through the workspace
constexpr int kClusterMax = 8;
constexpr float kLog2e = 1.4426950408889634f;

// The layout of a block for q of type T over K/V of type Tkv (T, or int8
// with f32 q) at head dim kHd: a ring of kStages stages a warp (a stage: a
// K tile, then a V tile, each kKeys rows of kHd values and a 16-byte pad,
// then for int8 the tile's K and V row scales), then q * scale (kRows rows
// at the K/V rows' stride; int8: its TF32 hi and lo planes, a 16-byte unit
// a column pair, kQLd bytes a row), then the last-block flag.  A bf16 tile
// is 16 keys (one k16 step of P.V); an f32 tile at head_dim 128 and 192 is
// 8 (one k8 step), so that f32 rows (twice as wide) keep two blocks an SM
// as bf16 does (~74-113 KB a block; 16-key f32 tiles at 128 and 192 held
// one block an SM and measured slower, 8-key ones at 64 slower than 16:
// chip_smoke.py phase 3, PERF.md §6).  occupancy() below reports the
// residency that follows.
template <typename T, int kHd, typename Tkv = T>
struct Layout {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr bool kInt8 = std::is_same<Tkv, int8_t>::value;
  // int8 tiles (B3): keys a warp tile, ring stages and warps a block
  // (ablations.py --body dec8 times the others)
  static constexpr int kInt8Keys = 16;
  static constexpr int kInt8Stages = kHd <= 64 ? 4 : 2;
  static constexpr int kInt8Warps = 8;
  static constexpr int kWarps = kInt8 ? kInt8Warps : 4;
  static constexpr int kThreads = 32 * kWarps;
  // blocks an SM the registers are capped for (255 a thread either way)
  static constexpr int kMinBlocks = kWarps > 4 ? 1 : 2;
  static constexpr int kKeys =  // a warp tile
      kInt8 ? kInt8Keys : kBf16 || kHd <= 64 ? 16 : 8;
  static constexpr int kNT = kKeys / 8;  // score tiles of 8 keys
  static constexpr int kStages =
      kInt8 ? kInt8Stages
            : kHd <= 64 ? (kBf16 ? 4 : 2) : kHd <= 128 ? 3 : 2;
  static constexpr int kLd = kHd * (int)sizeof(Tkv) + 16;  // row bytes
  static constexpr int kLdE = kLd / (int)sizeof(Tkv);      // row elements
  static constexpr int kTileBytes = kKeys * kLd;
  static constexpr int kStageBytes = 2 * kTileBytes + (kInt8 ? 8 * kKeys : 0);
  static constexpr int kRingBytes = kWarps * kStages * kStageBytes;
  static constexpr int kQLd = kInt8 ? 8 * kHd + 16 : kLd;  // q's row bytes
  static constexpr int kQBytes = kRows * kQLd;
  static constexpr size_t kSmem = (size_t)kRingBytes + kQBytes + 16;
  static constexpr int kChunks = kHd * (int)sizeof(Tkv) / 16;  // a row's
  static constexpr int kCopies = kKeys * kChunks / 32;  // a lane's, a tile
  // the warps' merge records (m, l, acc of the 16 rows, its rows kAccLd
  // apart) reuse the rings, and then the last block's split weights
  static constexpr int kAccLd = kHd + 4;
  static constexpr int kRec = kRows * (kAccLd + 2);
  static_assert(kHd % (kInt8 ? 32 : 16) == 0 &&
                    kCopies * 32 == kKeys * kChunks &&
                    kSplitTile % kKeys == 0,
                "bad head_dim");
  static_assert(!kInt8 || std::is_same<T, float>::value,
                "int8 pools take f32 q");
  static_assert((size_t)kWarps * kRec * sizeof(float) <= (size_t)kRingBytes,
                "the merge records do not fit the rings");
  // per row: the block's max, sum and each warp's weight (the merge)
  static_assert((size_t)kRows * (kWarps + 2) * sizeof(float) <=
                    (size_t)kQBytes,
                "the merge weights do not fit q's region");
};

// S (16 rows x 16 keys, 2 accumulator tiles of 8 keys) = Q K^T over a
// K tile of bf16 rows: two partial sums over even and odd k-steps (four
// independent mma chains), added at the end
template <int kHd, bool kQRegs>
__device__ __forceinline__ void scores_bf16(float (&s)[2][4],
                                            uint32_t (*qf)[4],
                                            const unsigned char* q_s,
                                            const unsigned char* ks,
                                            int lane) {
  using L = Layout<bf16, kHd>;
  float t[2][2][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int n = 0; n < 2; ++n)
      t[p][n][0] = t[p][n][1] = t[p][n][2] = t[p][n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk) {
    uint32_t qa[4];
    if constexpr (kQRegs) {
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
    } else {
      prefill_mma::ldmatrix_x4(
          smem_addr(q_s + (lane % 16) * L::kLd +
                    (kk * 16 + (lane / 16) * 8) * 2),
          qa);
    }
    // keys 0..7 (kb[0], kb[1]) and 8..15 (kb[2], kb[3]), hd kk*16 + 0..15
    uint32_t kb[4];
    prefill_mma::ldmatrix_x4(
        smem_addr(ks + (lane % 8 + (lane / 16) * 8) * L::kLd +
                  (kk * 16 + (lane / 8 % 2) * 8) * 2),
        kb);
    prefill_mma::mma_bf16(t[kk % 2][0], qa, kb[0], kb[1]);
    prefill_mma::mma_bf16(t[kk % 2][1], qa, kb[2], kb[3]);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = t[0][n][e] + t[1][n][e];
}

// S = Q K^T over a K tile of f32 rows in split TF32: q * scale from its
// shared rows (stride kHd + 4), split at each k8 step; each step's three
// products summed apart (mma3, kFold)
template <int kHd>
__device__ __forceinline__ void scores_tf32(
    float (&s)[Layout<float, kHd>::kNT][4], const float* q_s, const float* ks,
    int gr, int tc) {
  using L = Layout<float, kHd>;
  constexpr int kNT = L::kNT;
  namespace t32 = prefill_tf32;
#pragma unroll
  for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  const float* qr = q_s + gr * L::kLdE + tc;
#pragma unroll
  for (int kk = 0; kk < kHd / 8; ++kk) {
    // A element e: row gr + 8 * (e % 2), column kk * 8 + tc + 4 * (e / 2)
    uint32_t qh[4], ql[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      t32::split_tf32_int(qr[8 * (e % 2) * L::kLdE + kk * 8 + 4 * (e / 2)],
                          qh[e], ql[e]);
    // B fragments: key n * 8 + gr, hd kk * 8 + tc and + 4
    uint32_t kh[kNT][2], kl[kNT][2];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const float* kr = ks + (n * 8 + gr) * L::kLdE + kk * 8 + tc;
      t32::split_tf32_int(kr[0], kh[n][0], kl[n][0]);
      t32::split_tf32_int(kr[4], kh[n][1], kl[n][1]);
    }
    t32::mma3<true, kNT>(s, qh, ql, kh, kl);
  }
}

// Byte e of a 32-bit word of int8 values, biased to unsigned (u = w ^
// 0x80808080: x + 128), as the f32 bits of its exact value (what a TF32
// operand reads): the biased byte is the low mantissa byte of 2^23 (one
// prmt), and 2^23 + 128 is taken off (one add, exact)
__device__ __forceinline__ uint32_t widen_byte(uint32_t u, int e) {
  return __float_as_uint(
      __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440u + e)) - 8388736.f);
}
// the four int8 values of a word
__device__ __forceinline__ void widen_int8(uint32_t w, uint32_t (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = widen_byte(u, e);
}

// S = Q K^T over an int8 K tile in split TF32, K exact: q * scale's hi
// and lo planes from q_s (a 16-byte unit per column pair c, c + 1: hi c,
// hi c + 1, lo c, lo c + 1), two products a k8 step summed apart (mma2,
// kFold).  The k8 steps walk the head dim in a permuted order: a lane's
// 32-bit load of K bytes 16 u + 4 tc .. + 3 feeds steps 2u (bytes 0, 1)
// and 2u + 1 (bytes 2, 3), so step 2u + s takes column 16 u + 4 tc + 2 s
// as its k index tc and the next column as tc + 4; q's unit 8 u + 2 tc + s
// holds both columns of both planes
template <int kHd>
__device__ __forceinline__ void scores_int8(
    float (&s)[Layout<float, kHd, int8_t>::kNT][4],
    const unsigned char* q_s, const unsigned char* ks, int gr, int tc) {
  using L = Layout<float, kHd, int8_t>;
  constexpr int kNT = L::kNT;
  namespace t32 = prefill_tf32;
#pragma unroll
  for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  const unsigned char* q0 = q_s + gr * L::kQLd + 32 * tc;  // row gr
  const unsigned char* q1 = q0 + 8 * L::kQLd;              // row gr + 8
  const unsigned char* kr = ks + gr * L::kLd + 4 * tc;
#pragma unroll
  for (int u = 0; u < kHd / 16; ++u) {
    uint32_t kw[kNT];  // key n * 8 + gr, columns 16 u + 4 tc + 0..3, biased
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      kw[n] = *reinterpret_cast<const uint32_t*>(kr + n * 8 * L::kLd +
                                                 16 * u) ^ 0x80808080u;
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const uint4 a = *reinterpret_cast<const uint4*>(q0 + 128 * u + 16 * st);
      const uint4 b = *reinterpret_cast<const uint4*>(q1 + 128 * u + 16 * st);
      const uint32_t qh[4] = {a.x, b.x, a.y, b.y};
      const uint32_t ql[4] = {a.z, b.z, a.w, b.w};
      uint32_t kb[kNT][2];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        kb[n][0] = widen_byte(kw[n], 2 * st);
        kb[n][1] = widen_byte(kw[n], 2 * st + 1);
      }
      t32::mma2<true, kNT>(s, qh, ql, kb);
    }
  }
}

template <typename T, typename Tkv, typename Rows, typename Scales, int kHd>
__global__ void __launch_bounds__(Layout<T, kHd, Tkv>::kThreads,
                                  Layout<T, kHd, Tkv>::kMinBlocks)
decode_gqa_kernel(const T* __restrict__ q,    // (B, H, kHd)
                  const Tkv* __restrict__ k,  // slabs of (KV, kHd); Rows
                  const Tkv* __restrict__ v,
                  T* __restrict__ out,        // (B, H, kHd)
                  Rows rows, Scales scales, int H, int KV, float scale,
                  int split_keys,
                  float* __restrict__ ws,   // (B*KV, n_split, G*(kHd+2))
                  int* __restrict__ counters) {  // (B*KV,) 0 between calls
  using L = Layout<T, kHd, Tkv>;
  constexpr int kWarps = L::kWarps, kThreads = L::kThreads;
  constexpr bool kBf16 = L::kBf16;
  constexpr bool kInt8 = L::kInt8;
  static_assert(kInt8 == Scales::kQuant, "int8 pools carry row scales");
  constexpr int kStages = L::kStages;
  constexpr int kKeys = L::kKeys, kNT = L::kNT;
  constexpr int kN = kHd / 8;  // output accumulator tiles of 8 columns
  constexpr bool kQRegs = kBf16 && kHd <= 128;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tc = lane % 4;  // fragment row group, column
  const int G = H / KV;
  unsigned char* ring = smem + (size_t)warp * kStages * L::kStageBytes;
  unsigned char* q_s = smem + L::kRingBytes;
  int* last_s = reinterpret_cast<int*>(q_s + L::kQBytes);

  // the group's rows of q; over int8 pools every 4-value chunk of them is
  // read first (elementwise where q is not 16-byte aligned), so that its
  // trip to device memory overlaps the lengths' and the page table's
  const size_t base = ((size_t)b * H + (size_t)kvh * G) * kHd;
  constexpr int kQRow = kHd * (int)sizeof(T) / 16;  // chunks a row of q
  constexpr int kQPer = (kRows * kQRow + kThreads - 1) / kThreads;
  constexpr int kN16 = 16 / (int)sizeof(T);      // values a chunk
  float4 xq[kInt8 ? kQPer : 1];
  if constexpr (kInt8) {
    const bool aligned = (reinterpret_cast<uintptr_t>(q + base) & 15) == 0;
#pragma unroll
    for (int it = 0; it < kQPer; ++it) {
      const int c = tid + it * kThreads, g = c / kQRow;
      const T* src = q + base + 4 * c;
      xq[it] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < kRows * kQRow && g < G)
        xq[it] = aligned ? *reinterpret_cast<const float4*>(src)
                         : make_float4(src[0], src[1], src[2], src[3]);
    }
  }

  const int n_keys = rows.n_keys(b);
  const int k_begin = split * split_keys;
  const int k_end = min(n_keys, k_begin + split_keys);
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys : 0;
  // this warp's run of tiles
  const int t_begin = warp * n_tiles / kWarps;
  const int nt = (warp + 1) * n_tiles / kWarps - t_begin;
  const int key0 = k_begin + t_begin * kKeys;

  // the slab of key j = lane % kKeys of this warp's tile t (0 past the
  // split's end), read through the page table for K1 and B3
  auto slab_of = [&](int t) -> size_t {
    const int kpos = key0 + t * kKeys + lane % kKeys;
    return kpos < k_end ? rows.row(b, kpos) * KV + kvh : 0;
  };
  // tile t of this warp into stage st, lane j < kKeys holding key j's
  // slab; each 16-byte copy takes its key's from that lane, consecutive
  // lanes on consecutive chunks of a row; for int8 lane j also copies key
  // j's K and V row scales (the slab's index in the scales) beside the
  // tiles
  auto load_tile = [&](int t, int st, size_t slab_own) {
    const int k0 = key0 + t * kKeys;
    unsigned char* ks = ring + st * L::kStageBytes;
    unsigned char* vs = ks + L::kTileBytes;
#pragma unroll
    for (int it = 0; it < L::kCopies; ++it) {
      const int i = lane + 32 * it;
      const int j = i / L::kChunks, c = i - j * L::kChunks;
      const size_t slab = __shfl_sync(0xffffffffu, slab_own, j);
      const bool in = k0 + j < k_end;
      const size_t off = slab * kHd + c * (16 / sizeof(Tkv));
      cp_async16(smem_addr(ks + j * L::kLd + c * 16), k + off, in);
      cp_async16(smem_addr(vs + j * L::kLd + c * 16), v + off, in);
    }
    if constexpr (kInt8) {
      if (lane < kKeys) {
        const bool in_own = k0 + lane < k_end;
        unsigned char* sc = vs + L::kTileBytes;
        cp_async4(smem_addr(sc + 4 * lane), scales.ks + slab_own, in_own);
        cp_async4(smem_addr(sc + 4 * (kKeys + lane)), scales.vs + slab_own,
                  in_own);
      }
    }
  };

  // the first tiles load while q is staged; the page-table read of the
  // next tile to load then runs a tile ahead of its copies
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nt) load_tile(st, st, slab_of(st));
    cp_async_commit();
  }
  size_t slab_next = kStages - 1 < nt ? slab_of(kStages - 1) : 0;
  // q * scale in q's type, rows G..15 zero: every 16-byte chunk of the
  // group's rows read at once (one trip to device memory), elementwise
  // where q is not 16-byte aligned
  if constexpr (kInt8) {
    // int8 pools: q * scale (f32) split into TF32 hi and lo, a 16-byte
    // unit per column pair: hi c, hi c + 1, lo c, lo c + 1
#pragma unroll
    for (int it = 0; it < kQPer; ++it) {
      const int c = tid + it * kThreads, g = c / kQRow;
      if (c >= kRows * kQRow) break;
      uint4 u0, u1;
      prefill_tf32::split_tf32_int(__fmul_rn(xq[it].x, scale), u0.x, u0.z);
      prefill_tf32::split_tf32_int(__fmul_rn(xq[it].y, scale), u0.y, u0.w);
      prefill_tf32::split_tf32_int(__fmul_rn(xq[it].z, scale), u1.x, u1.z);
      prefill_tf32::split_tf32_int(__fmul_rn(xq[it].w, scale), u1.y, u1.w);
      uint4* dst = reinterpret_cast<uint4*>(q_s + g * L::kQLd +
                                            32 * (c - g * kQRow));
      dst[0] = u0;
      dst[1] = u1;
    }
  } else if ((reinterpret_cast<uintptr_t>(q + base) & 15) == 0) {
    uint4 raw[kQPer];
#pragma unroll
    for (int it = 0; it < kQPer; ++it) {
      const int c = tid + it * kThreads, g = c / kQRow;
      raw[it] = c < kRows * kQRow && g < G
                    ? *reinterpret_cast<const uint4*>(q + base + c * kN16)
                    : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int it = 0; it < kQPer; ++it) {
      const int c = tid + it * kThreads, g = c / kQRow;
      if (c >= kRows * kQRow) break;
      const T* src = reinterpret_cast<const T*>(&raw[it]);
      uint4 packed;
      T* val = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int e = 0; e < kN16; ++e)
        val[e] = from_f32<T>(to_f32(src[e]) * scale);
      *reinterpret_cast<uint4*>(q_s + g * L::kQLd + (c - g * kQRow) * 16) =
          packed;
    }
  } else {
    for (int i = tid; i < kRows * kHd; i += kThreads) {
      const int g = i / kHd, d = i - g * kHd;
      const float x = g < G ? to_f32(q[base + i]) * scale : 0.f;
      reinterpret_cast<T*>(q_s + g * L::kQLd)[d] = from_f32<T>(x);
    }
  }
  __syncthreads();  // q_s written

  // A fragments of q (bf16, kQRegs)
  uint32_t qf[kQRegs ? kHd / 16 : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk)
      prefill_mma::ldmatrix_x4(
          smem_addr(q_s + (lane % 16) * L::kLd +
                    (kk * 16 + (lane / 16) * 8) * 2),
          qf[kk]);
  }

  // accumulator (n, e) of the output: row gr + 8 * (e / 2), column
  // n * 8 + 2 * tc + e % 2
  float o[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // per row (gr, gr + 8): running max m, m * log2 e, running sum l
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float ml[2] = {__fmul_rn(kNeg, kLog2e), __fmul_rn(kNeg, kLog2e)};

  for (int it = 0; it < nt; ++it) {
    cp_async_wait<kStages - 2>();  // this lane's copies of tile it
    __syncwarp();  // every lane's; and the stage refilled next is read
    if (it + kStages - 1 < nt) {
      load_tile(it + kStages - 1, (it + kStages - 1) % kStages, slab_next);
      if (it + kStages < nt) slab_next = slab_of(it + kStages);
    }
    cp_async_commit();
    const unsigned char* ks = ring + (it % kStages) * L::kStageBytes;
    const unsigned char* vs = ks + L::kTileBytes;
    const int k0 = key0 + it * kKeys;

    // scores: accumulator (n, e) is row gr + 8 * (e / 2), key k0 + n * 8
    // + 2 * tc + e % 2
    float s[kNT][4];
    if constexpr (kBf16) {
      scores_bf16<kHd, kQRegs>(s, qf, q_s, ks, lane);
    } else if constexpr (kInt8) {
      scores_int8<kHd>(s, q_s, ks, gr, tc);
      // each key's K row scale after the dot (its column pair's two)
      const float* k_scale =
          reinterpret_cast<const float*>(vs + L::kTileBytes);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const float2 sk =
            *reinterpret_cast<const float2*>(k_scale + n * 8 + 2 * tc);
        s[n][0] *= sk.x;
        s[n][1] *= sk.y;
        s[n][2] *= sk.x;
        s[n][3] *= sk.y;
      }
    } else {
      scores_tf32<kHd>(s, reinterpret_cast<const float*>(q_s),
                       reinterpret_cast<const float*>(ks), gr, tc);
    }
    if constexpr (Rows::kRoundScores && kBf16) {
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        prefill_mma::round_pair(s[n][0], s[n][1]);
        prefill_mma::round_pair(s[n][2], s[n][3]);
      }
    }
    if (k0 + kKeys > k_end) {  // the split's ragged end
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + n * 8 + 2 * tc + e % 2 >= k_end) s[n][e] = kNeg;
    }

    // online softmax in f32, one row pair per thread quad (every tile
    // holds a valid key, so a masked key's probability is 0)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
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
    float p[kNT][4], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[n][e] = exp2_ftz(__fmul_rn(s[n][e], kLog2e) - ml[e / 2]);
        sum[e / 2] += p[n][e];
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
      for (int n = 0; n < kN; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
    }

    if constexpr (kBf16) {
      // P as the A fragment (m16k16): keys 0..7 from tile 0, 8..15 from 1
      uint32_t pf[4];
      pf[0] = prefill_mma::pack_bf16(p[0][0], p[0][1]);
      pf[1] = prefill_mma::pack_bf16(p[0][2], p[0][3]);
      pf[2] = prefill_mma::pack_bf16(p[1][0], p[1][1]);
      pf[3] = prefill_mma::pack_bf16(p[1][2], p[1][3]);
      // O += P V: V fragments transposed out of the key-major tile
#pragma unroll
      for (int np = 0; np < kHd / 16; ++np) {
        uint32_t vb[4];  // keys 0..15, columns np*16 + 0..7 and + 8..15
        prefill_mma::ldmatrix_x4_trans(
            smem_addr(vs + (lane % 8 + (lane / 8 % 2) * 8) * L::kLd +
                      (np * 16 + (lane / 16) * 8) * 2),
            vb);
        prefill_mma::mma_bf16(o[2 * np], pf, vb[0], vb[1]);
        prefill_mma::mma_bf16(o[2 * np + 1], pf, vb[2], vb[3]);
      }
    } else if constexpr (kInt8) {
      namespace t32 = prefill_tf32;
      const float* v_scale =
          reinterpret_cast<const float*>(vs + L::kTileBytes) + kKeys;
      // O += (P * v_scale) V per 8-key group kk: the A fragment as in the
      // f32 branch below, each probability times its V row's scale, then
      // split; B fragments from keys kk * 8 + 2 * tc (b0) and + 1 (b1):
      // one 32-bit load of each row's bytes 32 w + 4 gr .. + 3 feeds
      // output tiles 4 w .. 4 w + 3 at B column gr
#pragma unroll
      for (int kk = 0; kk < kNT; ++kk) {
        const float2 sv =
            *reinterpret_cast<const float2*>(v_scale + kk * 8 + 2 * tc);
        uint32_t ph[4], pl[4];
        t32::split_tf32_int(p[kk][0] * sv.x, ph[0], pl[0]);
        t32::split_tf32_int(p[kk][2] * sv.x, ph[1], pl[1]);
        t32::split_tf32_int(p[kk][1] * sv.y, ph[2], pl[2]);
        t32::split_tf32_int(p[kk][3] * sv.y, ph[3], pl[3]);
        const unsigned char* v0 = vs + (kk * 8 + 2 * tc) * L::kLd + 4 * gr;
        // output tiles kGv at a time: two at head_dim 192, where the 96
        // accumulators leave fewest registers for the products in flight
        constexpr int kGv = kHd > 128 ? 2 : 4;
#pragma unroll
        for (int w = 0; w < kHd / 32; ++w) {
          uint32_t f0[4], f1[4];
          widen_int8(*reinterpret_cast<const uint32_t*>(v0 + 32 * w), f0);
          widen_int8(*reinterpret_cast<const uint32_t*>(v0 + L::kLd + 32 * w),
                     f1);
#pragma unroll
          for (int e0 = 0; e0 < 4; e0 += kGv) {
            uint32_t vb[kGv][2];
#pragma unroll
            for (int e = 0; e < kGv; ++e) {
              vb[e][0] = f0[e0 + e];
              vb[e][1] = f1[e0 + e];
            }
            t32::mma2<true, kGv>(o + 4 * w + e0, ph, pl, vb);
          }
        }
      }
    } else {
      namespace t32 = prefill_tf32;
      const float* vf = reinterpret_cast<const float*>(vs);
      // O += P V per 8-key group kk: A elements (gr, key 2tc), (gr + 8,
      // 2tc), (gr, 2tc + 1), (gr + 8, 2tc + 1); B fragments at keys
      // kk * 8 + 2 * tc (b0) and + 1 (b1), column n * 8 + gr
#pragma unroll
      for (int kk = 0; kk < kNT; ++kk) {
        uint32_t ph[4], pl[4];
        t32::split_tf32_int(p[kk][0], ph[0], pl[0]);
        t32::split_tf32_int(p[kk][2], ph[1], pl[1]);
        t32::split_tf32_int(p[kk][1], ph[2], pl[2]);
        t32::split_tf32_int(p[kk][3], ph[3], pl[3]);
        // output tiles kGv at a time: one at head_dim 192, where the 96
        // accumulators leave fewest registers for the products in flight
        constexpr int kGv = kHd > 128 ? 1 : 2;
#pragma unroll
        for (int n0 = 0; n0 < kN; n0 += kGv) {
          uint32_t vh[kGv][2], vl[kGv][2];
#pragma unroll
          for (int n = 0; n < kGv; ++n) {
            const float* vr = vf + (kk * 8 + 2 * tc) * L::kLdE +
                              (n0 + n) * 8 + gr;
            t32::split_tf32_int(vr[0], vh[n][0], vl[n][0]);
            t32::split_tf32_int(vr[L::kLdE], vh[n][1], vl[n][1]);
          }
          t32::mma3<true, kGv>(o + n0, ph, pl, vh, vl);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: records go there

  // this warp's record: m[16], l[16], acc[16][kAccLd] (rows padded: a
  // store of the accumulators meets at most 2-way bank conflicts)
  constexpr int kAccLd = L::kAccLd;
  float* rec = reinterpret_cast<float*>(smem) + warp * L::kRec;
  if (tc == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rec[gr + 8 * h] = m[h];
      rec[kRows + gr + 8 * h] = l[h];
    }
  }
  // accumulator (n, e) is column n * 8 + 2 * tc + e % 2 of the head dim;
  // int8: column 32 (n / 4) + 4 (2 tc + e % 2) + n % 4 (P.V's order)
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      rec[2 * kRows + (gr + 8 * (e / 2)) * kAccLd +
          (kInt8 ? 32 * (n / 4) + 4 * (2 * tc + e % 2) + n % 4
                 : n * 8 + 2 * tc + e % 2)] = o[n][e];
  __syncthreads();

  // per row: the block's max, sum and each warp's weight, in warp order
  const float* recs = reinterpret_cast<const float*>(smem);
  float* wts = reinterpret_cast<float*>(q_s);  // (kRows, kWarps + 2)
  if (tid < G) {
    float mb = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, recs[w * L::kRec + tid]);
    float lb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wi = expf(recs[w * L::kRec + tid] - mb);
      wts[tid * (kWarps + 2) + 2 + w] = wi;
      lb = fmaf(wi, recs[w * L::kRec + kRows + tid], lb);
    }
    wts[tid * (kWarps + 2)] = mb;
    wts[tid * (kWarps + 2) + 1] = lb;
  }
  __syncthreads();
  auto merged = [&](int i) {  // element i = g * kHd + d of the block's acc
    const int g = i / kHd, d = i - g * kHd;
    const float* wg = wts + g * (kWarps + 2) + 2;
    float ob = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      ob = fmaf(wg[w], recs[w * L::kRec + 2 * kRows + g * kAccLd + d], ob);
    return ob;
  };

  if (n_split == 1) {
    for (int i = tid; i < G * kHd; i += kThreads)
      out[base + i] = from_f32<T>(
          merged(i) / fmaxf(wts[(i / kHd) * (kWarps + 2) + 1], 1e-30f));
    return;
  }

  {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    if ((int)cluster.num_blocks() == n_split) {
      // the splits of this (row, KV head) are one cluster (launch_hd, at
      // most kClusterMax): each block's partial stays in its shared
      // memory, acc in warp 0's record (rows kAccLd apart), m and l in
      // wts, and block `split` combines its share of the G * kHd outputs
      // from every block's, in split order, over distributed shared
      // memory: no workspace, no counter, no second pass through L2
      constexpr int kPerC = (kRows * kHd + kThreads - 1) / kThreads;
      float a[kPerC];
#pragma unroll
      for (int j = 0; j < kPerC; ++j) {
        const int i = tid + j * kThreads;
        a[j] = i < G * kHd ? merged(i) : 0.f;
      }
      __syncthreads();  // every warp's record read
      float* acc_s = reinterpret_cast<float*>(smem) + 2 * kRows;
#pragma unroll
      for (int j = 0; j < kPerC; ++j) {
        const int i = tid + j * kThreads;
        if (i < G * kHd) acc_s[(i / kHd) * kAccLd + i % kHd] = a[j];
      }
      cluster.sync();  // every block's partial is in
      const int chunk = (G * kHd + n_split - 1) / n_split;
      const int hi = min(G * kHd, (split + 1) * chunk);
      for (int i = split * chunk + tid; i < hi; i += kThreads) {
        const int g = i / kHd, d = i - g * kHd;
        float ms[kClusterMax], ls[kClusterMax], as[kClusterMax];
        float mmax = kNeg;
#pragma unroll
        for (int r = 0; r < kClusterMax; ++r) {
          if (r >= n_split) break;
          const float* w = cluster.map_shared_rank(wts, r);
          ms[r] = w[g * (kWarps + 2)];
          ls[r] = w[g * (kWarps + 2) + 1];
          as[r] = cluster.map_shared_rank(acc_s, r)[g * kAccLd + d];
          mmax = fmaxf(mmax, ms[r]);
        }
        float o = 0.f, den = 0.f;
#pragma unroll
        for (int r = 0; r < kClusterMax; ++r) {
          if (r >= n_split) break;
          const float w = expf(ms[r] - mmax);
          den = fmaf(w, ls[r], den);
          o = fmaf(w, as[r], o);
        }
        out[base + i] = from_f32<T>(o / fmaxf(den, 1e-30f));
      }
      cluster.sync();  // no block leaves while its shared memory is read
      return;
    }
  }

  // this split's partial: acc[G*kHd], then m[G], l[G]
  const size_t pair = (size_t)b * KV + kvh;
  const int acc_len = G * kHd, rec_len = G * (kHd + 2);
  float* part = ws + (pair * n_split + split) * rec_len;
  for (int g = tid; g < G; g += kThreads) {
    part[acc_len + g] = wts[g * (kWarps + 2)];
    part[acc_len + G + g] = wts[g * (kWarps + 2) + 1];
  }
  for (int i = tid; i < acc_len; i += kThreads) part[i] = merged(i);
  __threadfence();  // the partial is visible before the count says so
  __syncthreads();
  if (tid == 0) *last_s = atomicAdd(counters + pair, 1) == n_split - 1;
  __syncthreads();
  if (!*last_s) return;
  __threadfence();

  // the last block: out = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30),
  // w_s = exp(m_s - max_s m_s), summed in split order.  Every (split, row)
  // m and l is read at once into shared memory (the rings are free), the
  // weights made there, then each split's accumulators are read a whole
  // block at a time: the reads of a split are all in flight together
  const float* first = ws + pair * n_split * rec_len;
  float* w_s = reinterpret_cast<float*>(smem);  // (n_split, G) m, then w
  float* l_s = w_s + n_split * G;                // (n_split, G) l
  float* den_s = l_s + n_split * G;              // (G,)
  for (int j = tid; j < n_split * G; j += kThreads) {
    const int s = j / G, g = j - s * G;
    w_s[j] = __ldcg(first + s * rec_len + acc_len + g);
    l_s[j] = __ldcg(first + s * rec_len + acc_len + G + g);
  }
  __syncthreads();
  if (tid < G) {
    float mmax = kNeg;
    for (int s = 0; s < n_split; ++s) mmax = fmaxf(mmax, w_s[s * G + tid]);
    float den = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = expf(w_s[s * G + tid] - mmax);
      w_s[s * G + tid] = w;
      den = fmaf(w, l_s[s * G + tid], den);
    }
    den_s[tid] = den;
  }
  __syncthreads();
  constexpr int kPer = kRows * kHd / kThreads;  // elements a thread, at most
  constexpr int kBatch = 4;  // splits whose reads are in flight together
  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
  for (int s0 = 0; s0 < n_split; s0 += kBatch) {
    float x[kBatch][kPer];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = tid + j * kThreads;
        x[u][j] = s0 + u < n_split && i < acc_len
                      ? __ldcg(first + (s0 + u) * rec_len + i)
                      : 0.f;
      }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = tid + j * kThreads;
        if (s0 + u < n_split && i < acc_len)
          acc[j] = fmaf(w_s[(s0 + u) * G + i / kHd], x[u][j], acc[j]);
      }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = tid + j * kThreads;
    if (i < acc_len)
      out[base + i] = from_f32<T>(acc[j] / fmaxf(den_s[i / kHd], 1e-30f));
  }
  if (tid == 0) counters[pair] = 0;  // ready for the next call
}

template <typename T, typename Tkv, typename Rows, typename Scales, int kHd>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(decode_gqa_kernel<T, Tkv, Rows, Scales, kHd>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Layout<T, kHd, Tkv>::kSmem);
}

// Clusters of n_split blocks of the kernel that can be resident on the
// current device at once with one block an SM, in *n: the count
// cudaOccupancyMaxActiveClusters gives for cfg with each block holding
// the most shared memory a block may (so no SM holds two), asked once a
// device and n_split; the first error of the query, if one fails
template <typename T, typename Tkv, typename Rows, typename Scales, int kHd>
cudaError_t max_clusters(cudaLaunchConfig_t cfg, int n_split, int* n) {
  constexpr int kDevices = 16;
  static int known[kDevices][kClusterMax + 1];  // the count + 1; 0 unasked
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  if (known[dev][n_split] == 0) {
    auto* kernel = decode_gqa_kernel<T, Tkv, Rows, Scales, kHd>;
    int smem = 0;
    e = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cfg.dynamicSmemBytes = smem;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
    const cudaError_t r = set_smem<T, Tkv, Rows, Scales, kHd>();
    if (e == cudaSuccess) e = r;
    if (e != cudaSuccess) {
      cudaGetLastError();  // returned here, not left for the next launch
      return e;
    }
    known[dev][n_split] = *n + 1;
  }
  *n = known[dev][n_split] - 1;
  return cudaSuccess;
}

template <typename T, typename Tkv, typename Rows, typename Scales, int kHd>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              Rows rows, Scales scales, int B, int H, int KV, float scale,
              int split_keys, int n_split, void* ws, void* counters,
              void* stream) {
  using L = Layout<T, kHd, Tkv>;
  // the last block's (split, row) weights and sums live in the rings
  if ((size_t)(2 * n_split + 1) * (H / KV) * sizeof(float) >
      (size_t)L::kRingBytes)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = set_smem<T, Tkv, Rows, Scales, kHd>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, KV, n_split);
  cfg.blockDim = dim3(L::kThreads);
  cfg.dynamicSmemBytes = L::kSmem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  if (n_split > 1 && n_split <= kClusterMax) {
    // a (row, KV head)'s splits are one cluster, merged in distributed
    // shared memory, where every cluster of the grid is resident at once
    // with one block an SM.  Else the clusters run in waves (glm4-9b's 16
    // int8 clusters of 8 took 1.5x the workspace merge's time,
    // ablations.py --body dec8) or two blocks share an SM that the
    // workspace merge would have spread (f32 K1's 16 clusters of 8 there
    // took 1.13-1.24x its time: chip_smoke.py phase 3, PERF.md §6)
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 1;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = n_split;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int resident = 0;
    const cudaError_t ce =
        max_clusters<T, Tkv, Rows, Scales, kHd>(cfg, n_split, &resident);
    if (ce != cudaSuccess) return (int)ce;
    if (resident < B * KV) {
      cfg.attrs = nullptr;
      cfg.numAttrs = 0;
    }
  }
  cudaLaunchKernelEx(&cfg, decode_gqa_kernel<T, Tkv, Rows, Scales, kHd>,
                     (const T*)q, (const Tkv*)k, (const Tkv*)v, (T*)out, rows,
                     scales, H, KV, scale, split_keys, (float*)ws,
                     (int*)counters);
  return (int)cudaGetLastError();
}

// Launch (B, KV, n_split) blocks, split_keys keys a split (a multiple of
// kSplitTile); q and the output of type T (bf16 or f32), K/V of
// type Tkv (T, or int8 with f32 q and RowScales); G = H / KV from 1 to 16
// and head_dim 64, 128 or 192, else cudaErrorInvalidValue (the wrappers
// never send one).  ws holds B*KV*n_split*G*(hd+2) floats and counters
// B*KV zeroed ints when n_split > 1.  Returns cudaGetLastError().
template <typename T, typename Rows, typename Tkv = T,
          typename Scales = NoScales>
int launch(const void* q, const void* k, const void* v, void* out, Rows rows,
           int B, int H, int KV, int hd, float scale, int split_keys,
           int n_split, void* ws, void* counters, void* stream,
           Scales scales = Scales()) {
  if (KV < 1 || H % KV || H / KV > kRows || split_keys < kSplitTile ||
      split_keys % kSplitTile || n_split < 1)
    return (int)cudaErrorInvalidValue;
  if (hd == 64)
    return launch_hd<T, Tkv, Rows, Scales, 64>(
        q, k, v, out, rows, scales, B, H, KV, scale, split_keys, n_split,
        ws, counters, stream);
  if (hd == 128)
    return launch_hd<T, Tkv, Rows, Scales, 128>(
        q, k, v, out, rows, scales, B, H, KV, scale, split_keys, n_split,
        ws, counters, stream);
  if (hd == 192)
    return launch_hd<T, Tkv, Rows, Scales, 192>(
        q, k, v, out, rows, scales, B, H, KV, scale, split_keys, n_split,
        ws, counters, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename Tkv, typename Rows, typename Scales, int kHd>
int occupancy_hd(int* out) {
  using L = Layout<T, kHd, Tkv>;
  cudaError_t e = set_smem<T, Tkv, Rows, Scales, kHd>();
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, decode_gqa_kernel<T, Tkv, Rows, Scales, kHd>);
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)L::kSmem;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], decode_gqa_kernel<T, Tkv, Rows, Scales, kHd>, L::kThreads,
      L::kSmem);
  out[4] = L::kWarps;
  out[5] = L::kKeys;
  out[6] = L::kStages;
  return (int)e;
}

// What the card makes of the kernel for q of type T over K/V of type Tkv
// at head_dim hd: out[0] registers and out[1] local (spill) bytes a
// thread, out[2] dynamic shared bytes a block, out[3] resident blocks an
// SM, out[4] warps a block, out[5] keys a warp tile, out[6] ring stages.
// Launches nothing.
template <typename T, typename Rows, typename Tkv = T,
          typename Scales = NoScales>
int occupancy(int hd, int* out) {
  if (hd == 64) return occupancy_hd<T, Tkv, Rows, Scales, 64>(out);
  if (hd == 128) return occupancy_hd<T, Tkv, Rows, Scales, 128>(out);
  if (hd == 192) return occupancy_hd<T, Tkv, Rows, Scales, 192>(out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace decode_gqa
}  // namespace kern
