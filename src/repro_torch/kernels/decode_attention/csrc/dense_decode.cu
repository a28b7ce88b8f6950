// Dense decode attention for Hopper (sm_90a): one new query token per
// (row, head) attends over the first n_valid slots of the row's
// contiguous KV cache.
//
// Replaces src/repro/kernels/decode_attention/kernel.py::decode_attention
// (body _decode_kernel), the TPU kernel for the dense engine's T = 1
// steps.  Same function: q (B, H, hd), caches (B, C, KV, hd) in the
// model's own layout, read in place (the TPU op moves the head axis in
// front of the slots on every call); one valid length shared by the
// batch, n_valid = min(pos + 1, C), passed as a kernel argument from the
// host — with a sliding window the cache is a ring, and once it wraps
// every slot is valid, in ring order, which softmax does not care about.
// The plain version is models/attention.py::decode_attention.
//
// What bounds it on the card: bytes.  At the dense engine's decode
// (B = 8, C = 576, smollm-360m's 5 KV heads, head_dim 64, bf16) it reads
// ~5.6 MB of K and V for 544 valid slots, ~0.0017 ms at 3.35 TB/s.
// Design: K1's (decode_body.cuh) with contiguous rows; the key range is
// split by the host-known n_valid.  Rounding as the
// reference's decode_attention: scores in the promoted q/K type.

#include "decode_body.cuh"

namespace {

struct ContiguousRows {
  int C;        // cache slots per row
  int n_valid;  // valid slots, shared by the batch
  static constexpr bool kRoundScores = true;
  __device__ int n_keys(int) const { return n_valid; }
  __device__ size_t row(int b, int pos) const {
    return (size_t)b * C + pos;
  }
};

}  // namespace

#define DENSE_DECODE_ENTRY(NAME, TQ, TKV)                                     \
  extern "C" int NAME(const void* q, const void* k_cache,                    \
                      const void* v_cache, void* out, int B, int C, int H,   \
                      int KV, int hd, int n_valid, float scale,              \
                      int split_keys, int n_split, void* ws, void* counters, \
                      void* stream) {                                         \
    return kern::decode::launch<TQ, TKV>(                                     \
        q, k_cache, v_cache, out, ContiguousRows{C, n_valid}, B, H, KV, hd,   \
        scale, split_keys, n_split, ws, counters, stream);                    \
  }

DENSE_DECODE_ENTRY(decode_attention_f32_f32, float, float)
DENSE_DECODE_ENTRY(decode_attention_f32_bf16, float, __nv_bfloat16)
DENSE_DECODE_ENTRY(decode_attention_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
