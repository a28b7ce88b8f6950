// Contiguous flash attention for Hopper (sm_90a): the dense engine's
// prefill, S query tokens per row attending over T keys of the same row
// with a causal and optionally a sliding-window mask.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention
// (body _flash_kernel) in its contiguous form: q (B, S, H, hd) and k/v
// (B, T, KV, hd) in the model's own layout, read in place (the TPU op
// moves the head axis in front of the sequence on every call).  Query s
// sits at position s and sees key kpos iff kpos < T, kpos <= s (causal)
// and kpos > s - window (window > 0).  Key padding never enters the
// softmax (the TPU op's non-causal padding fault is not carried over).
// The plain version is models/attention.py::naive_attention.
//
// What bounds it on the card: at the dense engine's prefill (B = 8,
// S = T = 512, smollm-360m's 15/5 heads, head_dim 64, bf16) the work is
// ~4 GFLOP against ~21 MB of q/k/v/out, ~190 operations per byte — below
// the H100's ~295 bf16 operations per byte, so on paper bytes (~0.006
// ms); with causal masking about half the score matrix is skipped.
// Three bodies, chosen by the wrapper from dtype and head_dim alone:
// flash_attention_bf16_mma runs bf16 at head_dim 64, 128 and 192 on the
// tensor cores (prefill_mma.cuh: 64 packed q-head rows a block, 128 at
// 192, cp.async K/V ring), flash_attention_f32_tf32 f32 at 64, 128 and
// 192 in split TF32 (prefill_tf32.cuh, the same walk); everywhere else
// flash_attention_f32 and flash_attention_bf16 run prefill_body.cuh on
// CUDA cores (16 query tokens a block).
// flash_attention_mla_bf16_mma takes DeepSeek-V3's MLA operands as the
// model makes them (models/attention.py::mla_prefill): q (B, S, H, 192)
// = [q_nope | q_rope], k_nope (B, T, H, 128), the rope key (B, T, 64)
// that every head of a token shares, V (B, T, H, 128) -> (B, S, H, 128),
// causal with no window (MLA's prefill is causal only), on
// prefill_mma.cuh's tensor-core walk with the K tile assembled in
// shared memory from k_nope and the rope key (no broadcast, no padded V;
// the plain version is flash_attention/ops.py::mla_flash_attention_plain,
// which builds those operands and calls naive_attention).
// flash_attention_bf16_mma_lse, flash_attention_mla_bf16_mma_lse and
// flash_attention_f32_tf32_lse are the tensor-core entries with their
// body's kLse flag set: the same output bit for bit, and each row's
// logsumexp (natural log, f32, (B, H, S)) stored beside it for B2's
// backward (flash_backward.cu), so the backward does not recompute the
// scores to find it.  Only training's autograd Functions launch them;
// serving keeps the entries above.
// Rounding: K2's, and scores rounded to the input type, as
// naive_attention does.

#include "prefill_body.cuh"
#include "prefill_mma.cuh"
#include "prefill_tf32.cuh"

namespace {

struct ContiguousRows {
  int T;  // keys per row
  static constexpr bool kRoundScores = true;
  __device__ int q_pos0(int) const { return 0; }
  __device__ int n_keys(int) const { return T; }
  __device__ size_t row(int b, int pos) const { return (size_t)b * T + pos; }
};

// MLA's operands: the rope key row of key pos of batch row b
struct MlaRows : ContiguousRows, kern::MlaDims {
  const __nv_bfloat16* k_rope;  // (B, T, kRope)
  __device__ const __nv_bfloat16* rope(int b, int pos) const {
    return k_rope + row(b, pos) * kRope;
  }
};

constexpr int kQTile = 16;  // query tokens per block

}  // namespace

#define FLASH_PREFILL_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      void* out, int B, int S, int T_len, int H, int KV,    \
                      int hd, int causal, int window, float scale,          \
                      void* stream) {                                        \
    return kern::prefill::launch<T, T, kQTile>(                              \
        q, k, v, out, ContiguousRows{T_len}, B, S, H, KV, hd, causal,        \
        window, scale, stream);                                              \
  }

FLASH_PREFILL_ENTRY(flash_attention_f32, float)
FLASH_PREFILL_ENTRY(flash_attention_bf16, __nv_bfloat16)

extern "C" int flash_attention_bf16_mma(const void* q, const void* k,
                                        const void* v, void* out, int B,
                                        int S, int T_len, int H, int KV,
                                        int hd, int causal, int window,
                                        float scale, void* stream) {
  return kern::prefill_mma::launch(q, k, v, out, ContiguousRows{T_len}, B, S,
                                   H, KV, hd, causal, window, scale, stream);
}

extern "C" int flash_attention_bf16_mma_lse(const void* q, const void* k,
                                            const void* v, void* out,
                                            void* lse, int B, int S,
                                            int T_len, int H, int KV, int hd,
                                            int causal, int window,
                                            float scale, void* stream) {
  return kern::prefill_mma::launch<ContiguousRows, true>(
      q, k, v, out, ContiguousRows{T_len}, B, S, H, KV, hd, causal, window,
      scale, stream, static_cast<float*>(lse));
}

extern "C" int flash_attention_f32_tf32(const void* q, const void* k,
                                        const void* v, void* out, int B,
                                        int S, int T_len, int H, int KV,
                                        int hd, int causal, int window,
                                        float scale, void* stream) {
  return kern::prefill_tf32::launch<float>(q, k, v, out, ContiguousRows{T_len},
                                           B, S, H, KV, hd, causal, window,
                                           scale, stream);
}

extern "C" int flash_attention_f32_tf32_lse(const void* q, const void* k,
                                            const void* v, void* out,
                                            void* lse, int B, int S,
                                            int T_len, int H, int KV, int hd,
                                            int causal, int window,
                                            float scale, void* stream) {
  return kern::prefill_tf32::launch<float, ContiguousRows, kern::NoScales,
                                    true>(
      q, k, v, out, ContiguousRows{T_len}, B, S, H, KV, hd, causal, window,
      scale, stream, kern::NoScales(), static_cast<float*>(lse));
}

extern "C" int flash_attention_mla_bf16_mma(const void* q, const void* k_nope,
                                            const void* k_rope, const void* v,
                                            void* out, int B, int S,
                                            int T_len, int H, float scale,
                                            void* stream) {
  return kern::prefill_mma::launch_mla(
      q, k_nope, v, out,
      MlaRows{{T_len}, {}, static_cast<const __nv_bfloat16*>(k_rope)}, B, S,
      H, scale, stream);
}

extern "C" int flash_attention_mla_bf16_mma_lse(
    const void* q, const void* k_nope, const void* k_rope, const void* v,
    void* out, void* lse, int B, int S, int T_len, int H, float scale,
    void* stream) {
  return kern::prefill_mma::launch_mla<MlaRows, true>(
      q, k_nope, v, out,
      MlaRows{{T_len}, {}, static_cast<const __nv_bfloat16*>(k_rope)}, B, S,
      H, scale, stream, static_cast<float*>(lse));
}
