// One-token attention at DeepSeek-V3's MLA heads for Hopper (sm_90a): the
// body of dense_decode.cu's decode_attention_mla_bf16 (B4 on MLA's own
// operands, bf16).  Per (batch row, head): q (kNope + kRope) against K
// rows assembled from the head's k_nope row and the token's rope key,
// read in place from the latent cache (one row per token shared by every
// head), and V rows kVd wide, over the first n_valid slots; softmax with
// an online (m, l, acc) in f32, the reference's -1e30 masking and a
// max(l, 1e-30) denominator.
//
// What bounds it on the card: bytes.  Each (row, head, key) costs a
// 256-byte k_nope row and a 256-byte V row against 320 multiply-adds: ~0.6
// operations a byte, far below the H100's ~295 bf16 operations a byte.  At
// B = 8, 128 heads and 576 valid keys the K/V rows are 302 MB, ~0.090 ms
// at 3.35 TB/s.  MLA has one query head per K/V head (G = 1), so the GQA
// body (decode_body.cuh), which gives a tile's scores to one warp a query
// head, would leave three of its four warps idle and make every key a
// chain of 192 dependent multiply-adds.  This body is built for G = 1:
//   * one block of kWarps warps per (head, row, split of the key range),
//     heads fastest in the grid, so the blocks of a row's heads run side
//     by side and share its rope keys in L2; the split's keys are cut into
//     tiles of kTileKeys and each warp walks its own contiguous run of
//     tiles with its own online softmax, so no block barrier sits inside
//     the key loop;
//   * a warp scores kGroups keys at once, kGroup lanes to a key: lane s of
//     a group holds every kGroup-th 16-byte chunk of the K row from s on
//     (two of k_nope, one of the rope key) and of the V row (two), with its
//     slice of q * scale in registers; a key's score is 24 multiply-adds a
//     lane and a 3-step butterfly, which leaves the same bits in all 8
//     lanes, so the group shares (m, l) and each lane keeps the
//     accumulator of its 16 V columns;
//   * each lane copies exactly the chunks it reads, with cp.async into a
//     ring of kStages stages of the warp's own shared memory: a lane waits
//     for its own copies only (no barrier, no __syncwarp), and the ring
//     keeps (kStages - 1) tiles of every warp in flight; stages are laid
//     out chunk-major, so every shared load of a warp is 512 contiguous
//     bytes;
//   * at the end the four groups of a warp merge by butterfly, the warps
//     through shared memory in warp order, one thread an output column;
//   * splits: each writes (m, l, acc) in f32 to the workspace and the last
//     block of a (row, head) to finish, told by an atomic counter (reset to
//     0 by that block), combines them in split order, as decode_body.cuh
//     does; with one split the block writes the output itself.
// Every sum runs in a fixed order, so two launches give the same bits.
//
// Rounding follows the reference: q * scale in bf16, scores rounded to
// bf16, the probabilities rounded to bf16 before the P.V product relative
// to the running max of the key group that owns them, the output in bf16.

#pragma once

#include "../../csrc/common.cuh"

namespace kern {
namespace mla_decode {

using bf16 = __nv_bfloat16;
constexpr int kNope = MlaDims::kNope, kRope = MlaDims::kRope,
              kVd = MlaDims::kVd;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 8;              // lanes to a key
constexpr int kGroups = 32 / kGroup;   // keys a warp scores at once
constexpr int kKeysPerGroup = 2;       // keys of a tile for each group
constexpr int kTileKeys = kGroups * kKeysPerGroup;  // keys a warp tile
constexpr int kStages = 3;  // ~62 KB a block: three blocks an SM
// 16-byte chunks a lane holds of one key: every kGroup-th chunk of the
// k_nope row, of the rope key and of the V row
constexpr int kChunkCols = 8 * kGroup;  // columns between a lane's chunks
constexpr int kNc = kNope / kChunkCols, kRc = kRope / kChunkCols,
              kVc = kVd / kChunkCols;
constexpr int kKeyChunks = kNc + kRc + kVc;
constexpr int kStageBytes = kKeysPerGroup * kKeyChunks * 32 * 16;  // a warp
// the warps' rings, then one (m, l, acc[kVd]) record a warp for the merge
// and the last-block flag
constexpr size_t kSmemBytes = (size_t)kWarps * kStages * kStageBytes +
                              sizeof(float) * kWarps * (kVd + 2) + 16;
static_assert(kNope % kChunkCols == 0 && kRope % kChunkCols == 0 &&
                  kVd % kChunkCols == 0 && kNc + kRc > 0,
              "the MLA head dims must be whole chunks of every lane");
static_assert(kThreads == kVd, "the merge gives one output column a thread");

__global__ void __launch_bounds__(kThreads, 3)
mla_decode_kernel(const bf16* __restrict__ q,         // (B, H, kNope+kRope)
                  const bf16* __restrict__ k_nope,    // (B, T, H, kNope)
                  const bf16* __restrict__ kr_cache,  // (B, C_kr, kRope)
                  const bf16* __restrict__ v,         // (B, T, H, kVd)
                  bf16* __restrict__ out,             // (B, H, kVd)
                  int T, int C_kr, int H, int n_valid, float scale,
                  int split_keys,
                  float* __restrict__ ws,  // (B*H, n_split, kVd + 2)
                  int* __restrict__ counters) {  // (B*H,) 0 between calls
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / kGroup, s = lane % kGroup;
  unsigned char* ring = smem + (size_t)warp * kStages * kStageBytes;
  float* merge =
      reinterpret_cast<float*>(smem + (size_t)kWarps * kStages * kStageBytes);
  int* last_s = reinterpret_cast<int*>(merge + kWarps * (kVd + 2));

  const int k_begin = split * split_keys;
  const int k_end = min(n_valid, k_begin + split_keys);
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kTileKeys - 1) / kTileKeys : 0;
  // this warp's run of tiles
  const int t_begin = warp * n_tiles / kWarps;
  const int nt = (warp + 1) * n_tiles / kWarps - t_begin;
  const int key0 = k_begin + t_begin * kTileKeys;

  // key u * kGroups + g of tile t: this lane's chunks, chunk-major
  auto load_tile = [&](int t, int st) {
    unsigned char* dst = ring + st * kStageBytes + lane * 16;
#pragma unroll
    for (int u = 0; u < kKeysPerGroup; ++u) {
      const int pos = key0 + t * kTileKeys + u * kGroups + g;
      const bool in = pos < k_end;
      const int p = in ? pos : 0;  // a copy that reads nothing: any row
      const size_t slab = ((size_t)b * T + p) * H + h;
      const bf16* rope = kr_cache + ((size_t)b * C_kr + p) * kRope;
      const bf16* src[kKeyChunks];
#pragma unroll
      for (int i = 0; i < kNc; ++i)
        src[i] = k_nope + slab * kNope + i * kChunkCols + s * 8;
#pragma unroll
      for (int i = 0; i < kRc; ++i)
        src[kNc + i] = rope + i * kChunkCols + s * 8;
#pragma unroll
      for (int i = 0; i < kVc; ++i)
        src[kNc + kRc + i] = v + slab * kVd + i * kChunkCols + s * 8;
#pragma unroll
      for (int c = 0; c < kKeyChunks; ++c)
        cp_async16(smem_addr(dst + (u * kKeyChunks + c) * 32 * 16), src[c],
                   in);
    }
  };

  // the first tiles load while q is read
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nt) load_tile(st, st);
    cp_async_commit();
  }
  // q * scale in bf16, this lane's chunks of [q_nope | q_rope]
  float qf[(kNc + kRc) * 8];
  {
    const bf16* qr = q + ((size_t)b * H + h) * (kNope + kRope) + s * 8;
#pragma unroll
    for (int i = 0; i < kNc + kRc; ++i) {
      const int col =
          i < kNc ? i * kChunkCols : kNope + (i - kNc) * kChunkCols;
      Chunk<bf16>::load(qr + col, qf + 8 * i);
    }
#pragma unroll
    for (int e = 0; e < (kNc + kRc) * 8; ++e)
      qf[e] = round_to<bf16>(qf[e] * scale);
  }

  float m = kNeg, l = 0.f, acc[kVc * 8];
#pragma unroll
  for (int e = 0; e < kVc * 8; ++e) acc[e] = 0.f;

  for (int it = 0; it < nt; ++it) {
    cp_async_wait<kStages - 2>();  // this lane's copies of tile it
    // refill the stage this lane read in the previous tile
    if (it + kStages - 1 < nt)
      load_tile(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    const unsigned char* src = ring + (it % kStages) * kStageBytes + lane * 16;
    auto chunk = [&](int u, int c) {
      return reinterpret_cast<const bf16*>(src +
                                           (u * kKeyChunks + c) * 32 * 16);
    };

    float sc[kKeysPerGroup];
    bool in[kKeysPerGroup];
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kKeysPerGroup; ++u) {
      float part[kNc + kRc];
#pragma unroll
      for (int c = 0; c < kNc + kRc; ++c) {
        float kf[8];
        Chunk<bf16>::load(chunk(u, c), kf);
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) a = fmaf(qf[8 * c + e], kf[e], a);
        part[c] = a;
      }
      float dot = part[0];
#pragma unroll
      for (int c = 1; c < kNc + kRc; ++c) dot += part[c];
      // a butterfly: every lane of the group ends with the same bits
#pragma unroll
      for (int o = kGroup / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      in[u] = key0 + it * kTileKeys + u * kGroups + g < k_end;
      sc[u] = in[u] ? round_to<bf16>(dot) : kNeg;
      m_new = fmaxf(m_new, sc[u]);
    }
    const float corr = expf(m - m_new);
    float p[kKeysPerGroup], psum = 0.f;
#pragma unroll
    for (int u = 0; u < kKeysPerGroup; ++u) {
      p[u] = in[u] ? expf(sc[u] - m_new) : 0.f;
      psum += p[u];
    }
    l = fmaf(l, corr, psum);
    m = m_new;
#pragma unroll
    for (int e = 0; e < kVc * 8; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < kKeysPerGroup; ++u) {
      const float pv = round_to<bf16>(p[u]);
#pragma unroll
      for (int c = 0; c < kVc; ++c) {
        float vf[8];
        Chunk<bf16>::load(chunk(u, kNc + kRc + c), vf);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[8 * c + e] = fmaf(pv, vf[e], acc[8 * c + e]);
      }
    }
  }
  cp_async_wait<0>();

  // the warp's groups by butterfly over lanes s, s + 8, s + 16, s + 24
  float mw = m;
#pragma unroll
  for (int o = kGroup; o < 32; o <<= 1)
    mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, o));
  const float w = expf(m - mw);
  float lw = l * w;
#pragma unroll
  for (int o = kGroup; o < 32; o <<= 1)
    lw += __shfl_xor_sync(0xffffffffu, lw, o);
#pragma unroll
  for (int e = 0; e < kVc * 8; ++e) {
    float a = acc[e] * w;
#pragma unroll
    for (int o = kGroup; o < 32; o <<= 1)
      a += __shfl_xor_sync(0xffffffffu, a, o);
    acc[e] = a;
  }
  float* rec = merge + warp * (kVd + 2);
  if (lane < kGroup) {
#pragma unroll
    for (int c = 0; c < kVc; ++c)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        rec[2 + c * kChunkCols + s * 8 + e] = acc[8 * c + e];
    if (lane == 0) {
      rec[0] = mw;
      rec[1] = lw;
    }
  }
  __syncthreads();

  // the warps in warp order: thread tid owns output column tid
  float mb = kNeg;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) mb = fmaxf(mb, merge[i * (kVd + 2)]);
  float lb = 0.f, ob = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const float* r = merge + i * (kVd + 2);
    const float wi = expf(r[0] - mb);
    lb = fmaf(wi, r[1], lb);
    ob = fmaf(wi, r[2 + tid], ob);
  }
  const size_t pair = (size_t)b * H + h;
  if (n_split == 1) {
    out[pair * kVd + tid] = __float2bfloat16(ob / fmaxf(lb, 1e-30f));
    return;
  }

  // this split's partial: m, l, acc[kVd]
  constexpr int kRec = kVd + 2;
  float* part = ws + (pair * n_split + split) * kRec;
  if (tid == 0) {
    part[0] = mb;
    part[1] = lb;
  }
  part[2 + tid] = ob;
  __threadfence();  // the partial is visible before the count says so
  __syncthreads();
  if (tid == 0) *last_s = atomicAdd(counters + pair, 1) == n_split - 1;
  __syncthreads();
  if (!*last_s) return;
  __threadfence();

  // the last block: out = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30),
  // w_s = exp(m_s - max_s m_s), summed in split order
  const float* first = ws + pair * n_split * kRec;
  float mmax = kNeg;
  for (int i = 0; i < n_split; ++i)
    mmax = fmaxf(mmax, __ldcg(first + i * kRec));
  float o = 0.f, den = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const float* ps = first + i * kRec;
    const float wi = expf(__ldcg(ps) - mmax);
    den = fmaf(wi, __ldcg(ps + 1), den);
    o = fmaf(wi, __ldcg(ps + 2 + tid), o);
  }
  out[pair * kVd + tid] = __float2bfloat16(o / fmaxf(den, 1e-30f));
  if (tid == 0) counters[pair] = 0;  // ready for the next call
}

inline cudaError_t set_smem() {
  return cudaFuncSetAttribute(mla_decode_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kSmemBytes);
}

// Launch (H, B, n_split) blocks, split_keys keys a split (a multiple of
// kTileKeys); ws holds B*H*n_split*(kVd + 2) floats and counters B*H
// zeroed ints when n_split > 1.  Returns cudaGetLastError().
inline int launch(const void* q, const void* k_nope, const void* kr_cache,
                  const void* v, void* out, int B, int T, int C_kr, int H,
                  int n_valid, float scale, int split_keys, int n_split,
                  void* ws, void* counters, void* stream) {
  if (split_keys < kTileKeys || split_keys % kTileKeys || n_split < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = set_smem();
  if (e != cudaSuccess) return (int)e;
  mla_decode_kernel<<<dim3(H, B, n_split), kThreads, kSmemBytes,
                      (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k_nope, (const bf16*)kr_cache,
      (const bf16*)v, (bf16*)out, T, C_kr, H, n_valid, scale, split_keys,
      (float*)ws, (int*)counters);
  return (int)cudaGetLastError();
}

// What the card makes of the kernel: out[0] registers and out[1] local
// (spill) bytes a thread, out[2] dynamic shared bytes a block, out[3]
// resident blocks an SM, out[4] warps a block, out[5] keys a warp tile,
// out[6] ring stages.  Launches nothing.
inline int occupancy(int* out) {
  cudaError_t e = set_smem();
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, mla_decode_kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)kSmemBytes;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], mla_decode_kernel, kThreads, kSmemBytes);
  out[4] = kWarps;
  out[5] = kTileKeys;
  out[6] = kStages;
  return (int)e;
}

}  // namespace mla_decode
}  // namespace kern
