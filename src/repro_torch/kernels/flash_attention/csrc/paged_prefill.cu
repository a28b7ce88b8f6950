// Paged chunked-prefill attention for Hopper (sm_90a): T query tokens per
// slot attend causally over the slot's KV pages through its page table.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention
// (body _flash_kernel) in the paged form the serving engine's mixed
// prefill+decode steps need.  Query t of slot b sits at position
// lengths[b] + t and attends to the keys at logical positions
// kpos <= lengths[b] + t (kpos < P * bs), read from physical row
// page_table[b][kpos / bs] * bs + kpos % bs of the shared pool — exactly
// the mask of repro/models/attention.py::paged_attention.  Query rows past
// a slot's valid tokens compute whatever the pool holds there and the
// caller discards them, as in the reference.  Query head h reads KV head
// h / G.  Blockwise online softmax in f32 with -1e30 masking and a
// max(l, 1e-30) denominator, as in _flash_kernel.
//
// What bounds it on the card: at the engine's chunk of 32 tokens, bytes.
// Each key is used by at most G * T query rows of its slot: 4 * G * T * hd
// operations (two products, multiply and add) against its K and V rows of
// 4 * hd bytes in bf16, i.e. at most G * T = 96 operations per byte for
// G = 3, T = 32 — below the H100's ~295 bf16 operations per byte.
// Design: one thread block per (slot, KV head, tile of kQTile query
// tokens) holds all G heads of those tokens (kQTile * G rows), so a K/V
// tile read into shared memory serves every query row of the group; the
// block walks the pages only up to its last row's position, and reads the
// engine's (nb, bs, KV, hd) layout in place, 16 bytes per load.  Scores,
// the softmax update and P.V run on CUDA cores in f32.  Later work: wgmma tiles, TMA loads,
// and a split of long key ranges across blocks.
//
// Rounding follows the reference: q is scaled in its own type, and the
// probabilities are rounded to the K/V type before the P.V product.  The
// output has the K/V type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQTile = 8;    // query tokens per block
constexpr int kKeyTile = 32; // keys per shared-memory tile (one per lane)
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// One 16-byte chunk of a K/V row (4 f32 or 8 bf16 values), widened to
// f32.  Rows start at multiples of hd elements and the wrapper requires
// hd % 8 == 0, so every chunk is 16-byte aligned.
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* src, float* dst) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* src,
                                              float* dst) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};

size_t smem_bytes(int G, int hd) {
  const int R = kQTile * G;  // query rows per block
  // q, acc: R*hd; K tile: kKeyTile*(hd+1); V tile: kKeyTile*hd;
  // probabilities: R*kKeyTile; m, l, correction: 3*R; row limits: R ints
  return sizeof(float) * (size_t)(2 * R * hd + kKeyTile * (hd + 1) +
                                  kKeyTile * hd + R * kKeyTile + 4 * R);
}

template <typename Tq, typename Tkv>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const Tq* __restrict__ q,          // (B, T, H, hd)
                     const Tkv* __restrict__ k_pool,    // (nb, bs, KV, hd)
                     const Tkv* __restrict__ v_pool,    // (nb, bs, KV, hd)
                     const int* __restrict__ page_table,  // (B, P)
                     const int* __restrict__ lengths,     // (B,) cached
                     Tkv* __restrict__ out,               // (B, T, H, hd)
                     int T, int H, int KV, int hd, int bs, int P,
                     float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, t0 = blockIdx.z * kQTile;
  const int tid = threadIdx.x;
  const int G = H / KV, R = kQTile * G;
  const int ld = hd + 1;
  float* q_s = smem;
  float* acc = q_s + R * hd;
  float* k_s = acc + R * hd;
  float* v_s = k_s + kKeyTile * ld;
  float* p_s = v_s + kKeyTile * hd;
  float* m_s = p_s + R * kKeyTile;
  float* l_s = m_s + R;
  float* c_s = l_s + R;
  int* lim_s = (int*)(c_s + R);

  const int n_tok = min(kQTile, T - t0);
  const int len = lengths[b];
  const int n_pos = P * bs;
  // row r = tq * G + g is query token t0 + tq of head kvh * G + g; its last
  // visible key is lim_s[r] (-1: a padding row past T, never written)
  for (int r = tid; r < R; r += kThreads) {
    const int tq = r / G;
    lim_s[r] = tq < n_tok ? min(len + t0 + tq, n_pos - 1) : -1;
    m_s[r] = kNeg;
    l_s[r] = 0.f;
  }
  for (int i = tid; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const int tq = r / G, g = r - tq * G;
    float x = 0.f;
    if (tq < n_tok)
      x = round_to<Tq>(
          to_f32(q[(((size_t)b * T + t0 + tq) * H + (size_t)kvh * G + g) *
                       hd + d]) * scale);
    q_s[i] = x;
    acc[i] = 0.f;
  }
  __syncthreads();

  const int n_keys = min(len + t0 + n_tok, n_pos);
  const int* pt = page_table + (size_t)b * P;
  const int warp = tid / 32, lane = tid % 32;
  for (int k0 = 0; k0 < n_keys; k0 += kKeyTile) {
    const int nk = min(kKeyTile, n_keys - k0);
    // 16-byte loads, all of a thread's chunks issued before they are used
    constexpr int N = Chunk<Tkv>::N;
    const int cpr = hd / N;  // chunks per row
#pragma unroll 4
    for (int i = tid; i < nk * cpr; i += kThreads) {
      const int j = i / cpr, d = (i - j * cpr) * N;
      const int pos = k0 + j;
      const size_t row = ((size_t)pt[pos / bs] * bs + pos % bs) * KV + kvh;
      float kf[N], vf[N];
      Chunk<Tkv>::load(k_pool + row * hd + d, kf);
      Chunk<Tkv>::load(v_pool + row * hd + d, vf);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        k_s[j * ld + d + e] = kf[e];
        v_s[j * hd + d + e] = vf[e];
      }
    }
    __syncthreads();

    for (int i = tid; i < R * kKeyTile; i += kThreads) {
      const int r = i / kKeyTile, j = i - r * kKeyTile;
      float s = kNeg;
      if (j < nk && k0 + j <= lim_s[r]) {
        const float* qr = q_s + r * hd;
        const float* kr = k_s + j * ld;
        s = 0.f;
        for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
      }
      p_s[i] = s;
    }
    __syncthreads();

    for (int r = warp; r < R; r += kWarps) {
      float* sr = p_s + r * kKeyTile;
      float mx = sr[lane];
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_s[r], mx);
      const float p = expf(sr[lane] - m_new);  // masked: exp(-1e30) = 0
      sr[lane] = round_to<Tkv>(p);
      float sum = p;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_s[r] - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    for (int i = tid; i < R * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      const float* pr = p_s + r * kKeyTile;
      float a = acc[i] * c_s[r];
      for (int j = 0; j < nk; ++j) a = fmaf(pr[j], v_s[j * hd + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const int tq = r / G, g = r - tq * G;
    if (tq < n_tok)
      out[(((size_t)b * T + t0 + tq) * H + (size_t)kvh * G + g) * hd + d] =
          from_f32<Tkv>(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename Tq, typename Tkv>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_table, const void* lengths, void* out, int B,
           int T, int H, int KV, int hd, int bs, int P, float scale,
           void* stream) {
  const size_t smem = smem_bytes(H / KV, hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel<Tq, Tkv>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B, KV, (T + kQTile - 1) / kQTile);
  paged_prefill_kernel<Tq, Tkv><<<grid, kThreads, smem,
                                  (cudaStream_t)stream>>>(
      (const Tq*)q, (const Tkv*)k_pool, (const Tkv*)v_pool,
      (const int*)page_table, (const int*)lengths, (Tkv*)out, T, H, KV, hd,
      bs, P, scale);
  return (int)cudaGetLastError();
}

}  // namespace

#define PAGED_PREFILL_ENTRY(NAME, TQ, TKV)                                    \
  extern "C" int NAME(const void* q, const void* k_pool, const void* v_pool,  \
                      const void* page_table, const void* lengths,            \
                      void* out, int B, int T, int H, int KV, int hd, int bs, \
                      int P, float scale, void* stream) {                     \
    return launch<TQ, TKV>(q, k_pool, v_pool, page_table, lengths, out, B, T, \
                           H, KV, hd, bs, P, scale, stream);                  \
  }

PAGED_PREFILL_ENTRY(paged_prefill_attention_f32_f32, float, float)
PAGED_PREFILL_ENTRY(paged_prefill_attention_f32_bf16, float, __nv_bfloat16)
PAGED_PREFILL_ENTRY(paged_prefill_attention_bf16_bf16, __nv_bfloat16,
                    __nv_bfloat16)

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
