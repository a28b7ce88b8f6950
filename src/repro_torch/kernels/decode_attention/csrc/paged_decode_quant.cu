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
// ~3 MB, ~0.0009 ms at 3.35 TB/s, a quarter of the f32 stream; at
// glm4-9b's 32/2 heads of 128 over 4160 keys, ~17.6 MB, ~0.0052 ms.
//
// Two bodies, picked by ops.py's quant_decode_entry from the shapes alone:
//   * paged_decode_attention_quant_f32_tf32: the tensor-core body
//     decode_gqa_mma.cuh over int8 tiles (every G = H / KV up to 16 at
//     head_dim 64, 128 and 192: the G query heads are the 16 MMA rows,
//     each warp walks its own key tiles with its own cp.async ring, Q.K
//     and P.V in split TF32 with the int8 values exact, two products a k8
//     step, the scales folded into each score and probability), its split
//     plan ops.py's mma_split_plan over 2 * hd + 8 bytes a key;
//   * paged_decode_attention_quant_f32: decode_body.cuh (CUDA cores) for
//     every other shape (the tests' head dim 16, G > 16).
// Design and rounding: see the two bodies; int8 rows are loaded 16
// values per 16-byte copy, so head_dim % 16 == 0.

#include "decode_body.cuh"
#include "decode_gqa_mma.cuh"

namespace {

// the rows of a paged int8 call and its scales, as both bodies take them
struct QuantArgs {
  kern::decode::PagedRows rows;
  kern::RowScales scales;
};

QuantArgs quant_args(const void* k_scale, const void* v_scale,
                     const void* page_table, const void* lengths, int bs,
                     int P) {
  return {{(const int*)page_table, (const int*)lengths, bs, P},
          {(const float*)k_scale, (const float*)v_scale}};
}

}  // namespace

extern "C" int paged_decode_attention_quant_f32(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* lengths, void* out, int B, int H, int KV, int hd, int bs,
    int P, float scale, int split_keys, int n_split, void* ws,
    void* counters, void* stream) {
  const QuantArgs a = quant_args(k_scale, v_scale, page_table, lengths, bs, P);
  return kern::decode::launch<float, int8_t>(
      q, k_pool, v_pool, out, a.rows, B, H, KV, hd, scale, split_keys,
      n_split, ws, counters, stream, a.scales);
}

extern "C" int paged_decode_attention_quant_f32_tf32(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* lengths, void* out, int B, int H, int KV, int hd, int bs,
    int P, float scale, int split_keys, int n_split, void* ws,
    void* counters, void* stream) {
  const QuantArgs a = quant_args(k_scale, v_scale, page_table, lengths, bs, P);
  return kern::decode_gqa::launch<float, kern::decode::PagedRows, int8_t,
                                  kern::RowScales>(
      q, k_pool, v_pool, out, a.rows, B, H, KV, hd, scale, split_keys,
      n_split, ws, counters, stream, a.scales);
}

// registers, spills, shared memory, residency and layout of the
// tensor-core body's int8 kernel at head_dim hd (bf16 = 0: its q is f32,
// the argument the other decode libraries' occupancy entries take): see
// decode_gqa_mma.cuh's occupancy()
extern "C" int paged_decode_attention_quant_gqa_occupancy(int bf16, int hd,
                                                          int* out) {
  if (bf16) return (int)cudaErrorInvalidValue;
  return kern::decode_gqa::occupancy<float, kern::decode::PagedRows, int8_t,
                                     kern::RowScales>(hd, out);
}
