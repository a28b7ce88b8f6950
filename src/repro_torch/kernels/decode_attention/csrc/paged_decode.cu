// Paged decode attention for Hopper (sm_90a): one query token per
// (slot, head) attends over the slot's KV pages through its page table.
//
// Replaces src/repro/kernels/decode_attention/kernel.py::
// paged_decode_attention (body _paged_decode_kernel), the TPU kernel for
// the T = 1 steps of the paged serving engine.  Same function: keys at
// logical positions kpos < lengths[b] of slot b, read from physical row
// page_table[b][kpos / bs] * bs + kpos % bs of the shared pool, which is
// read in the engine's own (nb, bs, KV, hd) layout (the TPU op transposed
// it to (nb, KV, bs, hd) on every call).  The plain version is
// models/attention.py::paged_attention.
//
// What bounds it on the card: bytes — one K and one V row per valid key
// (at B = 8, smollm-360m's 5 KV heads, head_dim 64, bf16 and ~300 keys a
// slot, ~3 MB, ~0.001 ms at 3.35 TB/s).  Design and rounding: see
// decode_body.cuh; the key range is split by the page table's P * bs
// keys, never by lengths (the host does not read them).  The reference's paged path keeps its scores in f32.

#include "decode_body.cuh"

#define PAGED_DECODE_ENTRY(NAME, TQ, TKV)                                    \
  extern "C" int NAME(const void* q, const void* k_pool, const void* v_pool, \
                      const void* page_table, const void* lengths,           \
                      void* out, int B, int H, int KV, int hd, int bs,       \
                      int P, float scale, int split_keys, int n_split,       \
                      void* ws, void* counters, void* stream) {              \
    const kern::decode::PagedRows rows{(const int*)page_table,             \
                                       (const int*)lengths, bs, P};        \
    return kern::decode::launch<TQ, TKV>(q, k_pool, v_pool, out, rows, B, H, \
                                         KV, hd, scale, split_keys, n_split, \
                                         ws, counters, stream);              \
  }

PAGED_DECODE_ENTRY(paged_decode_attention_f32_f32, float, float)
PAGED_DECODE_ENTRY(paged_decode_attention_f32_bf16, float, __nv_bfloat16)
PAGED_DECODE_ENTRY(paged_decode_attention_bf16_bf16, __nv_bfloat16,
                   __nv_bfloat16)
