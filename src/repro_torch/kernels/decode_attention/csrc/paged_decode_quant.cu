// Paged decode attention over an int8 KV pool for Hopper (sm_90a): one
// query token per (slot, head) attends over the slot's int8 K/V pages,
// dequantized by their per-row scales as they are loaded.
//
// Replaces src/repro/kernels/decode_attention/kernel.py::
// paged_decode_attention_quant (body _paged_decode_quant_kernel), the TPU
// kernel for the T = 1 steps of the paged serving engine under
// kv_dtype="int8".  Same function: K1's (paged_decode.cu) over int8 pools
// (nb, bs, KV, hd) whose rows carry one f32 scale per (block row, KV
// head) in k_scale / v_scale (nb, bs, KV); a row is widened to f32 and
// multiplied by its scale before the score dot, as the TPU kernel does
// (`k.astype(f32) * ks[:, None]`).  Pools and scales are read in the
// engine's layout (the TPU op transposed both on every call).  q and the
// output are f32: the reference's dequantized K/V are f32 and promote the
// attention.  The plain version is models/attention.py::paged_attention
// over dequantize_kv(paged_gather(...)).
//
// What bounds it on the card: bytes — per valid key one int8 K and V row
// (2 * KV * hd bytes) and their two f32 scales (2 * KV * 4 bytes): at
// B = 8, smollm-360m's 5 KV heads, head_dim 64 and ~540 keys a slot,
// ~3 MB, ~0.0009 ms at 3.35 TB/s, a quarter of the f32 stream.  Design
// and rounding: see decode_body.cuh; int8 rows are loaded 16 values per
// 16-byte load, so head_dim % 16 == 0.  Each thread that loads a chunk
// reads its row's two scales: KV consecutive floats per row (20 bytes at
// 5 KV heads), not 16-byte aligned, served from L1 for a row's chunks.

#include "decode_body.cuh"

extern "C" int paged_decode_attention_quant_f32(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* lengths, void* out, int B, int H, int KV, int hd, int bs,
    int P, float scale, void* stream) {
  const kern::decode::PagedRows rows{(const int*)page_table,
                                     (const int*)lengths, bs, P};
  return kern::decode::launch<float, int8_t>(
      q, k_pool, v_pool, out, rows, B, H, KV, hd, scale, stream,
      kern::RowScales{(const float*)k_scale, (const float*)v_scale});
}
