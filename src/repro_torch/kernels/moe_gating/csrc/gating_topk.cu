// Top-k MoE gating for Hopper (sm_90a): per token, the k largest of E
// expert scores and their indices, largest first.
//
// Replaces src/repro/kernels/moe_gating/kernel.py::gating_topk (body
// _gating_kernel).  Same function and the same rule as the TPU kernel: k
// passes, each taking the maximum and the *first* (lowest) expert index
// holding it, then masking that entry to -1e30; ties therefore go to the
// lowest index, as jax.lax.top_k orders them.  Scores are f32 (the
// router's softmax or sigmoid output); values come out f32, indices
// int32.  E <= 256, k <= 8 (the repository's configs go up to 256 experts
// and top-8).
//
// What bounds it on the card: neither bytes nor operations — at serving
// sizes (tens to hundreds of tokens x 16 experts: a few KB) a launch is
// microseconds of fixed cost; the bytes are E floats in and 2k values out
// per token.  Design: selection, not a sort.  One warp per token; lane l
// holds the scores of experts l, l + 32, ... (coalesced loads; absent
// experts hold -inf), and each of the k passes is a lane-local scan plus
// a 5-step shuffle reduction of (value, index) pairs ordered by value,
// then lowest index.  The winning lane masks its entry in registers.
// Nothing touches shared memory; a block of 8 warps serves 8 tokens.

#include "../../csrc/common.cuh"

#include <cmath>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxExperts = 256;
constexpr int kPerLane = kMaxExperts / 32;
constexpr int kMaxK = 8;
constexpr float kNeg = -1e30f;  // the TPU kernel's mask value
constexpr int kNone = 1 << 30;  // index of "no expert seen yet"

__global__ void __launch_bounds__(kWarps * 32)
gating_topk_kernel(const float* __restrict__ scores,  // (T, E)
                   float* __restrict__ vals,           // (T, k)
                   int* __restrict__ idx,              // (T, k)
                   int n_tokens, int E, int k) {
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.x * kWarps + threadIdx.x / 32;
  if (t >= n_tokens) return;  // the whole warp leaves together
  const float* row = scores + (size_t)t * E;
  float s[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int e = lane + 32 * i;
    s[i] = e < E ? row[e] : -INFINITY;
  }
  for (int j = 0; j < k; ++j) {
    // this lane's maximum; ascending e, strict '>' keeps the first index
    float bv = -INFINITY;
    int bi = kNone;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int e = lane + 32 * i;
      if (e < E && (s[i] > bv || bi == kNone)) {
        bv = s[i];
        bi = e;
      }
    }
    // warp reduction: larger value wins, equal values go to the lower
    // index; after the xor butterfly every lane holds the same winner
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      vals[(size_t)t * k + j] = bv;
      idx[(size_t)t * k + j] = bi;
    }
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      if (lane + 32 * i == bi) s[i] = kNeg;
  }
}

}  // namespace

extern "C" int gating_topk_f32(const void* scores, void* vals, void* idx,
                               int n_tokens, int E, int k, void* stream) {
  if (E < 1 || E > kMaxExperts || k < 1 || k > kMaxK || k > E)
    return (int)cudaErrorInvalidValue;
  const int grid = (n_tokens + kWarps - 1) / kWarps;
  gating_topk_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)scores, (float*)vals, (int*)idx, n_tokens, E, k);
  return (int)cudaGetLastError();
}
