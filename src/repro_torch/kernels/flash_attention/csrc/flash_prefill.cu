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
// Three bodies, chosen by the wrapper from dtype and head_dim alone, at
// head_dim 64 and 128 on the tensor cores: flash_attention_bf16_mma runs
// bf16 (prefill_mma.cuh: 64 packed q-head rows a block, cp.async K/V
// ring), flash_attention_f32_tf32 f32 in split TF32 (prefill_tf32.cuh,
// the same walk); at any other head_dim flash_attention_f32 and
// flash_attention_bf16 run prefill_body.cuh on CUDA cores (16 query
// tokens a block).
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

extern "C" int flash_attention_f32_tf32(const void* q, const void* k,
                                        const void* v, void* out, int B,
                                        int S, int T_len, int H, int KV,
                                        int hd, int causal, int window,
                                        float scale, void* stream) {
  return kern::prefill_tf32::launch<float>(q, k, v, out, ContiguousRows{T_len},
                                           B, S, H, KV, hd, causal, window,
                                           scale, stream);
}
