// Paged chunked-prefill attention for Hopper (sm_90a): T query tokens per
// slot attend causally over the slot's KV pages through its page table.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention
// (body _flash_kernel) in the paged form the serving engine's mixed
// prefill+decode steps need.  Query t of slot b sits at position
// lengths[b] + t and attends to the keys at logical positions
// kpos <= lengths[b] + t (kpos < P * bs), read from physical row
// page_table[b][kpos / bs] * bs + kpos % bs of the shared pool in the
// engine's (nb, bs, KV, hd) layout — exactly the mask of
// repro/models/attention.py::paged_attention, its plain version.  Query
// rows past a slot's valid tokens compute whatever the pool holds there
// and the caller discards them, as in the reference.
//
// What bounds it on the card: at the engine's chunk of 32 tokens, bytes.
// Each key is used by at most G * T query rows of its slot: 4 * G * T * hd
// operations (two products, multiply and add) against its K and V rows of
// 4 * hd bytes in bf16, i.e. at most G * T = 96 operations per byte for
// G = 3, T = 32 — below the H100's ~295 bf16 operations per byte.
// Three bodies, chosen by the wrapper from dtypes and head_dim alone:
// paged_prefill_attention_bf16_bf16_mma runs bf16 q and pools at
// head_dim 64, 128 and 192 on the tensor cores (prefill_mma.cuh: 64
// packed q-head rows a block, 128 at 192, cp.async K/V ring through the
// page table), the *_tf32 entries f32 q over f32 or bf16 pools at 64,
// 128 and 192 in split TF32 (prefill_tf32.cuh, the same walk; 8-warp
// blocks at 192, whose shared memory does not grow with G); everywhere else
// the other entries run prefill_body.cuh on CUDA cores (8 query tokens a
// block).  All keep the scores in f32
// (PagedRows::kRoundScores is false).

#include "prefill_body.cuh"
#include "prefill_mma.cuh"
#include "prefill_tf32.cuh"

namespace {

constexpr int kQTile = 8;  // query tokens per block

}  // namespace

#define PAGED_PREFILL_ENTRY(NAME, TQ, TKV)                                    \
  extern "C" int NAME(const void* q, const void* k_pool, const void* v_pool,  \
                      const void* page_table, const void* lengths,            \
                      void* out, int B, int T, int H, int KV, int hd, int bs, \
                      int P, float scale, void* stream) {                     \
    const kern::prefill::PagedRows rows{(const int*)page_table,             \
                                        (const int*)lengths, bs, P};        \
    return kern::prefill::launch<TQ, TKV, kQTile>(                            \
        q, k_pool, v_pool, out, rows, B, T, H, KV, hd, /*causal=*/1,          \
        /*window=*/0, scale, stream);                                         \
  }

PAGED_PREFILL_ENTRY(paged_prefill_attention_f32_f32, float, float)
PAGED_PREFILL_ENTRY(paged_prefill_attention_f32_bf16, float, __nv_bfloat16)
PAGED_PREFILL_ENTRY(paged_prefill_attention_bf16_bf16, __nv_bfloat16,
                    __nv_bfloat16)

extern "C" int paged_prefill_attention_bf16_bf16_mma(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* lengths, void* out, int B, int T,
    int H, int KV, int hd, int bs, int P, float scale, void* stream) {
  const kern::prefill::PagedRows rows{(const int*)page_table,
                                      (const int*)lengths, bs, P};
  return kern::prefill_mma::launch(q, k_pool, v_pool, out, rows, B, T, H, KV,
                                   hd, /*causal=*/1, /*window=*/0, scale,
                                   stream);
}

#define PAGED_PREFILL_TF32_ENTRY(NAME, TKV)                                   \
  extern "C" int NAME(const void* q, const void* k_pool, const void* v_pool,  \
                      const void* page_table, const void* lengths,            \
                      void* out, int B, int T, int H, int KV, int hd, int bs, \
                      int P, float scale, void* stream) {                     \
    const kern::prefill::PagedRows rows{(const int*)page_table,             \
                                        (const int*)lengths, bs, P};        \
    return kern::prefill_tf32::launch<TKV>(q, k_pool, v_pool, out, rows, B,   \
                                           T, H, KV, hd, /*causal=*/1,        \
                                           /*window=*/0, scale, stream);      \
  }

PAGED_PREFILL_TF32_ENTRY(paged_prefill_attention_f32_f32_tf32, float)
PAGED_PREFILL_TF32_ENTRY(paged_prefill_attention_f32_bf16_tf32, __nv_bfloat16)
