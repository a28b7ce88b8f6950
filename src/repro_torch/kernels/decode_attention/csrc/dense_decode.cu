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
//
// decode_attention_mla_bf16 takes DeepSeek-V3's expanded MLA decode
// (models/attention.py::mla_decode, absorb=False) as the model makes it:
// q (B, H, 192) = [q_nope | q_rope], k_nope and V (B, T, H, 128)
// expanded for the T = n_valid visible slots, and the rope key read in
// place from the latent cache kr_cache (B, C, 64), one row per token
// shared by every head -> (B, H, 128): no broadcast rope key, no
// zero-padded V, no cut output (a third fewer bytes than the padded
// operands).  Its body is decode_mla.cuh, built for MLA's one query head
// per K/V head: every warp of a block walks its own keys, 8 lanes to a
// key.  The same split plan and workspace as the GQA entries.  The plain
// version is decode_attention/ops.py::mla_decode_attention_plain.
//
// Every group of up to 16 query heads a KV head at head_dim 64, 128 or
// 192 (whisper-tiny's 6/6 up to glm4-9b's 32/2) takes the tensor-core
// body decode_gqa_mma.cuh:
// decode_attention_bf16_bf16_mma (bf16 mma.sync, scores rounded to bf16)
// and decode_attention_f32_f32_tf32 (split TF32), the GQA entries'
// arguments, split_keys a multiple of its 16-key tiles.

#include "decode_body.cuh"
#include "decode_gqa_mma.cuh"
#include "decode_mla.cuh"

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

#define DENSE_DECODE_GQA_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const void* q, const void* k_cache,                    \
                      const void* v_cache, void* out, int B, int C, int H,   \
                      int KV, int hd, int n_valid, float scale,              \
                      int split_keys, int n_split, void* ws, void* counters, \
                      void* stream) {                                         \
    return kern::decode_gqa::launch<T>(                                       \
        q, k_cache, v_cache, out, ContiguousRows{C, n_valid}, B, H, KV, hd,   \
        scale, split_keys, n_split, ws, counters, stream);                    \
  }

DENSE_DECODE_GQA_ENTRY(decode_attention_bf16_bf16_mma, __nv_bfloat16)
DENSE_DECODE_GQA_ENTRY(decode_attention_f32_f32_tf32, float)

// registers, spills, shared memory, residency and layout of the
// tensor-core body's kernel for bf16 (bf16 = 1) or f32 operands at
// head_dim hd: see decode_gqa_mma.cuh's occupancy()
extern "C" int decode_attention_gqa_occupancy(int bf16, int hd, int* out) {
  return bf16 ? kern::decode_gqa::occupancy<__nv_bfloat16, ContiguousRows>(
                    hd, out)
              : kern::decode_gqa::occupancy<float, ContiguousRows>(hd, out);
}

extern "C" int decode_attention_mla_bf16(const void* q, const void* k_nope,
                                         const void* kr_cache, const void* v,
                                         void* out, int B, int T, int C_kr,
                                         int H, int n_valid, float scale,
                                         int split_keys, int n_split,
                                         void* ws, void* counters,
                                         void* stream) {
  return kern::mla_decode::launch(q, k_nope, kr_cache, v, out, B, T, C_kr, H,
                                  n_valid, scale, split_keys, n_split, ws,
                                  counters, stream);
}

// registers, spills, shared memory, residency and layout of
// decode_attention_mla_bf16's kernel: see decode_mla.cuh's occupancy()
extern "C" int decode_attention_mla_bf16_occupancy(int* out) {
  return kern::mla_decode::occupancy(out);
}
