// Paged chunked-prefill attention over an int8 KV pool for Hopper
// (sm_90a): T query tokens per slot attend causally over the slot's int8
// K/V pages, dequantized by their per-row scales as they are loaded.
//
// Not the port of a TPU kernel: the reference's gqa_paged_step_quant
// (src/repro/models/attention.py) dequantizes the gathered pool in XLA
// for every T, and its only int8 kernel (paged_decode_attention_quant,
// B3, paged_decode_quant.cu) covers T = 1.  The port's paged step sends
// T > 1 to this kernel, so a mixed prefill+decode step never
// dequantizes the whole gathered cache in plain torch.  Same function as
// K2 (paged_prefill.cu) over int8 pools (nb, bs, KV, hd) and their f32
// scales (nb, bs, KV): a row is widened to f32 and multiplied by its
// scale before the score dot.  q and the output are f32.  The plain
// version is models/attention.py::paged_attention over
// dequantize_kv(paged_gather(...)).
//
// What bounds it on the card: operations.  Each key is used by up to
// G * T query rows: 4 * G * T * hd f32 operations against its 2 * hd
// int8 bytes and 8 scale bytes, ~180 operations per byte for G = 3,
// T = 32, hd = 64, above the H100's ~20 f32 operations per byte of
// device memory (67 TFLOP/s outside the tensor cores over 3.35 TB/s).
// Two bodies, chosen by the wrapper from head_dim alone: at head_dim 64,
// 128 and 192 paged_prefill_attention_quant_f32_tf32 runs prefill_tf32.cuh
// (tensor cores in split TF32, int8 tiles in the ring, the row scales
// folded into the scores and probabilities); at any other head_dim
// paged_prefill_attention_quant_f32 runs prefill_body.cuh (CUDA cores, 8
// query tokens a block, rows dequantized as they load).  int8 rows are
// loaded 16 values per 16-byte load, so head_dim % 16 == 0.

#include "prefill_body.cuh"
#include "prefill_tf32.cuh"

extern "C" int paged_prefill_attention_quant_f32(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* lengths, void* out, int B, int T, int H, int KV, int hd,
    int bs, int P, float scale, void* stream) {
  const kern::prefill::PagedRows rows{(const int*)page_table,
                                      (const int*)lengths, bs, P};
  return kern::prefill::launch<float, int8_t, 8>(
      q, k_pool, v_pool, out, rows, B, T, H, KV, hd, /*causal=*/1,
      /*window=*/0, scale, stream,
      kern::RowScales{(const float*)k_scale, (const float*)v_scale});
}

extern "C" int paged_prefill_attention_quant_f32_tf32(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* lengths, void* out, int B, int T, int H, int KV, int hd,
    int bs, int P, float scale, void* stream) {
  const kern::prefill::PagedRows rows{(const int*)page_table,
                                      (const int*)lengths, bs, P};
  return kern::prefill_tf32::launch<int8_t>(
      q, k_pool, v_pool, out, rows, B, T, H, KV, hd, /*causal=*/1,
      /*window=*/0, scale, stream,
      kern::RowScales{(const float*)k_scale, (const float*)v_scale});
}
