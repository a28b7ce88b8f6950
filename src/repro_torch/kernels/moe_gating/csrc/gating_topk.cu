// Top-k MoE gating for Hopper (sm_90a): per token, the k largest of E
// expert scores and their indices, largest first.
//
// Replaces src/repro/kernels/moe_gating/kernel.py::gating_topk (body
// _gating_kernel).  Same function and the same rule as the TPU kernel: k
// passes, each taking the maximum and the *first* (lowest) expert index
// holding it, then masking that entry to -1e30; ties therefore go to the
// lowest index, as jax.lax.top_k orders them.  Scores are f32 (the
// router's softmax or sigmoid output); values come out f32, indices
// int32.  E <= 256, k <= min(E, 8) (the repository's configs go up to
// 256 experts and top-8).  NaN scores are outside the contract, as they
// are for the TPU kernel: their order is not defined.
//
// What bounds it on the card: neither bytes nor operations.  At serving
// sizes (tens to hundreds of tokens x 16 experts: a few KB) the bytes
// take nanoseconds and the kernel sits on the launch floor, the time a
// one-thread kernel takes (chip_smoke.py phase 3 times both).  What is
// left above the floor is the serial chain of each token's k passes.
// Design: selection, not a sort, with the chain cut short.
//   * Sub-warp groups.  For E <= 32 a token gets W lanes, W the next
//     power of two >= E, one expert per lane, and a warp serves 32 / W
//     tokens (two at E = 16; no lane idles on -inf).  For E > 32 a token
//     gets the whole warp, lane l holding experts l, l + 32, ...
//     (coalesced loads either way).
//   * One packed key per entry: the order-preserving bits of the value
//     in the high word (sign flipped for positives, all bits for
//     negatives, so unsigned order is float order) and 255 - e in the
//     low word.  The larger key is the larger value and, among equal
//     values, the lower index: the tie rule is one unsigned compare.
//     -0.0 is keyed as +0.0 first (float comparison treats the two as
//     equal, so the tie rule must too); a zero winner's value is read
//     back from its entry, so each value keeps the bits of the score it
//     came from, -0.0 included.  A pass is a lane-local max of
//     the lane's keys and one 64-bit xor butterfly over log2(W) levels
//     (__shfl_xor_sync with width W); every lane of the group ends with
//     the winner, and the lane holding it re-keys it as -1e30 with its
//     index, the TPU kernel's mask.
//   * Stores: lane j < k of a group keeps pass j's winner and stores
//     vals[j] and idx[j] once, after the passes (one store each, the
//     group's k lanes side by side).
// A block of 8 warps serves 8 x 32 / W tokens; nothing touches shared
// memory.

#include "../../csrc/common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxExperts = 256;
constexpr int kMaxK = 8;
constexpr float kNeg = -1e30f;  // the TPU kernel's mask value
using Key = unsigned long long;  // the shuffles' 64-bit type

// unsigned order of the result == float order of v (v not NaN)
__device__ __forceinline__ uint32_t order_bits(float v) {
  const uint32_t u = __float_as_uint(v == 0.f ? 0.f : v);  // -0 -> +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_order_bits(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}
__device__ __forceinline__ Key pack(float v, int e) {
  return ((Key)order_bits(v) << 32) | (uint32_t)(kMaxExperts - 1 - e);
}
__device__ __forceinline__ int index_of(Key key) {
  return kMaxExperts - 1 - (int)(uint32_t)key;
}

// W lanes per token, P experts per lane (P > 1 only with W == 32).
// Absent experts hold key 0, below every real key.
template <int W, int P>
__global__ void __launch_bounds__(kWarps * 32)
gating_topk_kernel(const float* __restrict__ scores,  // (T, E)
                   float* __restrict__ vals,           // (T, k)
                   int* __restrict__ idx,              // (T, k)
                   int n_tokens, int E, int k) {
  constexpr int G = 32 / W;  // tokens per warp
  const int lane = threadIdx.x % 32;
  const int r = lane % W;
  const int t = (blockIdx.x * kWarps + threadIdx.x / 32) * G + lane / W;
  const bool live = t < n_tokens;  // dead groups still shuffle
  const float* row = scores + (size_t)t * E;
  Key key[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int e = r + W * i;
    key[i] = live && e < E ? pack(row[e], e) : 0ull;
  }
  Key mine = 0;
  for (int j = 0; j < k; ++j) {
    Key best = key[0];
#pragma unroll
    for (int i = 1; i < P; ++i) best = key[i] > best ? key[i] : best;
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1) {
      const Key other = __shfl_xor_sync(0xffffffffu, best, o, W);
      best = other > best ? other : best;
    }
    if (r == j) mine = best;
    const int e = index_of(best);
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (r + W * i == e) key[i] = pack(kNeg, e);
  }
  if (live && r < k) {
    const int e = index_of(mine);
    float v = from_order_bits((uint32_t)(mine >> 32));
    if (v == 0.f) v = row[e];  // the key folded -0.0 into +0.0
    vals[(size_t)t * k + r] = v;
    idx[(size_t)t * k + r] = e;
  }
}

template <int W, int P>
int launch(const void* scores, void* vals, void* idx, int n_tokens, int E,
           int k, void* stream) {
  constexpr int kTokensPerBlock = kWarps * 32 / W;
  const int grid = (n_tokens + kTokensPerBlock - 1) / kTokensPerBlock;
  gating_topk_kernel<W, P><<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)scores, (float*)vals, (int*)idx, n_tokens, E, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gating_topk_f32(const void* scores, void* vals, void* idx,
                               int n_tokens, int E, int k, void* stream) {
  if (E < 1 || E > kMaxExperts || k < 1 || k > kMaxK || k > E ||
      n_tokens < 1)
    return (int)cudaErrorInvalidValue;
#define GO(W, P) launch<W, P>(scores, vals, idx, n_tokens, E, k, stream)
  if (E <= 1) return GO(1, 1);
  if (E <= 2) return GO(2, 1);
  if (E <= 4) return GO(4, 1);
  if (E <= 8) return GO(8, 1);
  if (E <= 16) return GO(16, 1);
  if (E <= 32) return GO(32, 1);
  if (E <= 64) return GO(32, 2);
  if (E <= 128) return GO(32, 4);
  return GO(32, 8);
#undef GO
}
