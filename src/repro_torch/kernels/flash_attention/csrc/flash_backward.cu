// The gradient of contiguous flash attention (B2) for Hopper (sm_90a):
// from q (B, S, H, hd), k (B, T, KV, hd), v (B, T, KV, hdv), the forward's
// out and the incoming dout (B, S, H, hdv), it computes dq, dk and dv in
// the input type (f32 or bf16).
//
// Replaces no TPU kernel: the JAX package differentiates attention through
// XLA (models/attention.py::naive_attention, chunked_attention above 2048
// tokens), and src/repro/kernels/flash_attention/kernel.py::flash_attention
// has no backward.  It is the backward that training on the card needs,
// because the port's forward is the hand-written B2 (flash_prefill.cu),
// whose output torch cannot differentiate.  The plain version is
// flash_attention/ops.py::flash_attention_backward_plain: torch.autograd
// of naive_attention.
//
// The masks are B2's: query s (at position s) sees key kpos iff kpos < T,
// kpos <= s (causal) and kpos > s - window (window > 0); without the
// causal mask every key, and S may exceed T.  A query row that sees no key
// has a zero output and gets zero gradients.  GQA: query head h reads KV
// head h / G, and dk/dv sum the group's heads inside the kernel.
//
// Three bodies, picked by the wrapper (ops.py::flash_backward_entry) from
// dtypes and head dims alone, as the forward's are:
//   flash_attention_backward_bf16_mma (bf16, hd = hdv = 64, 128 or 192)
//   and
//   flash_attention_backward_mla_bf16_mma (bf16, DeepSeek-V3's MLA
//   operands: q/k 192 = 128 + 64 with one rope key a token shared by every
//   head, V 128) run backward_mma.cuh: FlashAttention-2's backward on the
//   tensor cores (mma.sync bf16, f32 accumulators, a cp.async ring), from
//   the row logsumexp that the forward's *_lse entries store.  Four
//   kernels: delta = rowsum(dout * out); dk/dv per 64-key tile, the
//   group's heads walked inside the block (at 192 a pair of warps to 16
//   keys, each with half of dK's and dV's columns); MLA's rope key
//   gradient summed over head groups in a fixed order; dq per 64 packed
//   GQA rows (128 at 192).  MLA's K tile is
//   assembled in shared memory from k_nope and the rope key, as the MLA
//   forward does: no (B, T, H, 192) K or dk is built.  What bounds them is
//   in backward_mma.cuh.
//   flash_attention_backward_f32_tf32 (f32, hd = hdv = 64 or 128) runs
//   backward_tf32.cuh: the same three passes (delta; dk/dv per 128 keys,
//   the group's heads walked inside the block; dq per 128 packed GQA
//   rows), every product in split TF32 on the tensor cores (three
//   mma.sync tf32 products per f32 product, both operands split), from
//   the logsumexp flash_attention_f32_tf32_lse stores.  What bounds it is
//   in backward_tf32.cuh.
//   flash_attention_backward_f32 and _bf16 (f32 at any head dim but 64
//   and 128: 16, 48, 192 among them; bf16 where the tensor-core body does
//   not take the head dims: 16, 48, 192 with V 128) run the first design,
//   below, on CUDA cores: three passes, each a kernel on the caller's stream,
//   accumulators in f32:
//   prep  one block per (64-query tile, head, row): each row's logsumexp
//         lse over its visible keys (recomputed: the CUDA-core forward
//         bodies do not store it) and delta = rowsum(dout * out);
//   dq    one block per (64-query tile, head, row): over the visible key
//         tiles, P = exp(s - lse), dS = P * (dout . v - delta) and
//         dq += scale * dS k;
//   dk/dv one block per (64-key tile, KV head, row): over the group's
//         heads and the query tiles that see the key tile, dv += P^T dout
//         and dk += dS^T (scale * q).
// No atomics in any body: every output element is written by one
// block, so the result is deterministic (training's --remat run gives the
// plain run's losses bit for bit).
//
// What bounds the CUDA-core body: about 2.5 times the forward's
// operations (five S x T x hd products a head against the forward's two)
// against reading q, k, v, out, dout and writing dq, dk, dv once; in f32
// the operations (~0.15 ms at smollm-360m's training shape against 67
// TFLOP/s).  It runs its f32 products from shared memory, 4 x 4 register
// tiles a thread (two 16-byte shared loads per 16 multiply-adds), one
// block of 256 threads per tile, at ~10 TFLOP/s; split TF32 on the tensor
// cores (backward_tf32.cuh) is its redesign at 64 and 128.  Its blocks do
// not grow with G, so f32 at 192 (nemotron-4-340b's heads) stays on it.
//
// Rounding (every body) follows B2's forward: q * scale rounded to the
// input type and the scores rounded to it before the exponent; the CUDA-
// core and split-TF32 bodies keep everything after in f32, the bf16
// tensor-core body rounds P and dS to bf16 as operands of its products;
// the gradients are rounded to the input type once, at the end.

#include "../../csrc/common.cuh"
#include "backward_mma.cuh"
#include "backward_tf32.cuh"

namespace kern {
namespace flash_bwd {

constexpr int kThreads = 256;      // 16 x 16 threads over a 64 x 64 tile
constexpr int kTile = 64;          // query rows / keys per tile
constexpr int kPad = 4;            // f32 row padding: rows stay 16-byte
                                   // aligned and a quarter-warp's float4
                                   // reads of 8 rows hit 8 bank groups
constexpr int kLdP = kTile + kPad; // row stride of the P / dS tile
constexpr int kMaxSmem = 232448;   // an H100 block's shared memory

__host__ __device__ inline int ld(int n) { return n + kPad; }

struct Shape {
  int B, S, T, H, KV, hd, hdv, causal, window;
  float scale;
};

__device__ __forceinline__ bool visible(const Shape& p, int s, int kpos) {
  return s < p.S && kpos < p.T && (!p.causal || kpos <= s) &&
         (p.window <= 0 || kpos > s - p.window);
}

// The keys any of the query rows q0 .. q0 + n_q - 1 can see: from the
// first row's window start to the last row's position.
__device__ __forceinline__ void key_range(const Shape& p, int q0, int n_q,
                                          int* lo, int* hi) {
  *lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  *hi = p.causal ? min(q0 + n_q - 1, p.T - 1) : p.T - 1;
}

// kTile rows of n values into dst [kTile][ld(n)] f32: row j from
// src + j * stride, rows past n_rows zero.  With `scale` (q) each value
// is multiplied and rounded to T, as the forward rounds q * scale.
template <typename T>
__device__ void load_rows(float* dst, const T* src, size_t stride,
                          int n_rows, int n, float scale, bool scaled) {
  constexpr int N = Chunk<T>::N;
  const int cpr = n / N, l = ld(n);
  for (int i = threadIdx.x; i < kTile * cpr; i += kThreads) {
    const int j = i / cpr, d = (i - j * cpr) * N;
    float x[N];
    if (j < n_rows) {
      Chunk<T>::load(src + j * stride + d, x);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e)
      dst[j * l + d + e] = scaled ? round_to<T>(x[e] * scale) : x[e];
  }
}

// acc[a][c] = sum_d A[ty + 16a][d] * B[tx + 16c][d], d < n (n % 4 == 0);
// A, B: [kTile][ld(n)].  A quarter-warp shares ty: its A reads broadcast.
__device__ __forceinline__ void nt_tile(const float* A, const float* B,
                                        int n, int ty, int tx,
                                        float acc[4][4]) {
  const int l = ld(n);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
  for (int d = 0; d < n; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      av[a] = *reinterpret_cast<const float4*>(A + (ty + 16 * a) * l + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bv[c] = *reinterpret_cast<const float4*>(B + (tx + 16 * c) * l + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = acc[a][c];
        s = fmaf(av[a].x, bv[c].x, s);
        s = fmaf(av[a].y, bv[c].y, s);
        s = fmaf(av[a].z, bv[c].z, s);
        s = fmaf(av[a].w, bv[c].w, s);
        acc[a][c] = s;
      }
  }
}

// The 4 x 4 tiles of a (kTile, n) output a thread owns: tile m is
// threadIdx.x + kThreads * m of the 16 * n / 4 tiles (rows 4 * (tile /
// (n/4)), columns 4 * (tile % (n/4))).  MT = ceil(n / 64) covers n.
__device__ __forceinline__ bool owned_tile(int m, int n, int* r0, int* c0) {
  const int groups = n / 4, t = threadIdx.x + kThreads * m;
  *r0 = 4 * (t / groups);
  *c0 = 4 * (t - (t / groups) * groups);
  return t < 16 * groups;
}

// acc[m][r][c] += sum_i A[i][r0 + r] * B[i][c0 + c], i < kTile, over the
// thread's tiles: C (kTile x n) += A^T B, A [kTile][kLdP], B [kTile][ld(n)].
template <int MT>
__device__ __forceinline__ void tn_acc(const float* A, const float* B, int n,
                                       float acc[MT][4][4]) {
  const int l = ld(n);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    int r0, c0;
    if (!owned_tile(m, n, &r0, &c0)) continue;
    for (int i = 0; i < kTile; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(A + i * kLdP + r0);
      const float4 b = *reinterpret_cast<const float4*>(B + i * l + c0);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[m][r][c] = fmaf(av[r], bv[c], acc[m][r][c]);
    }
  }
}

// Write a thread's tiles of a (kTile, n) f32 accumulator, times `mul`,
// to rows row0 + r (r < n_rows) of a (rows, heads, n) tensor at `dst`.
template <typename T, int MT>
__device__ __forceinline__ void store_tiles(T* dst, size_t stride, int n,
                                            int n_rows, float mul,
                                            const float acc[MT][4][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    int r0, c0;
    if (!owned_tile(m, n, &r0, &c0)) continue;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (r0 + r < n_rows)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dst[(r0 + r) * stride + c0 + c] = from_f32<T>(acc[m][r][c] * mul);
  }
}

// One tile's probabilities from the score tile s (rows ty + 16a at query
// q0, columns tx + 16c at key k0): exp(s - lse) where visible, else 0.
template <typename T>
__device__ __forceinline__ void probs(const Shape& p, int q0, int k0, int ty,
                                      int tx, const float* lse_s,
                                      float s[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      s[a][c] = visible(p, q0 + i, k0 + tx + 16 * c)
                    ? expf(round_to<T>(s[a][c]) - lse_s[i])
                    : 0.f;
  }
}

// lse and delta of rows q0 .. q0 + n_q - 1 into shared memory (rows past
// them: lse = +inf, so their probabilities are 0)
__device__ __forceinline__ void load_row_stats(const Shape& p, int b, int h,
                                               int q0, int n_q,
                                               const float* lse,
                                               const float* delta,
                                               float* lse_s, float* dl_s) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const size_t at = ((size_t)b * p.H + h) * p.S + q0 + i;
    lse_s[i] = i < n_q ? lse[at] : INFINITY;
    dl_s[i] = i < n_q ? delta[at] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
prep_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ out, const T* __restrict__ dout,
            float* __restrict__ lse, float* __restrict__ delta, Shape p) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV), n_q = min(kTile, p.S - q0);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float* q_s = smem;
  float* k_s = q_s + kTile * ld(p.hd);
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < n_q; r += kThreads / 32) {
    const size_t off = (((size_t)b * p.S + q0 + r) * p.H + h) * p.hdv;
    float s = 0.f;
    for (int e = lane; e < p.hdv; e += 32)
      s = fmaf(to_f32(dout[off + e]), to_f32(out[off + e]), s);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) delta[((size_t)b * p.H + h) * p.S + q0 + r] = s;
  }
  load_rows(q_s, q + (((size_t)b * p.S + q0) * p.H + h) * p.hd,
            (size_t)p.H * p.hd, n_q, p.hd, p.scale, true);
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNeg;
    l[a] = 0.f;
  }
  int k_lo, k_hi;
  key_range(p, q0, n_q, &k_lo, &k_hi);
  for (int k0 = k_lo; k0 <= k_hi; k0 += kTile) {
    __syncthreads();
    load_rows(k_s, k + (((size_t)b * p.T + k0) * p.KV + kvh) * p.hd,
              (size_t)p.KV * p.hd, min(kTile, p.T - k0), p.hd, 1.f, false);
    __syncthreads();
    float s[4][4];
    nt_tile(q_s, k_s, p.hd, ty, tx, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + ty + 16 * a;
      bool vis[4];
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        vis[c] = visible(p, row, k0 + tx + 16 * c);
        s[a][c] = round_to<T>(s[a][c]);
        if (vis[c]) mx = fmaxf(mx, s[a][c]);
      }
      // the 16 threads of a row are lanes 0-15 or 16-31 of one warp
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[a], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (vis[c]) sum += expf(s[a][c] - m_new);
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[a] = l[a] * expf(m[a] - m_new) + sum;
      m[a] = m_new;
    }
  }
  if (tx == 0)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + ty + 16 * a;
      if (row < p.S)
        lse[((size_t)b * p.H + h) * p.S + row] =
            l[a] > 0.f ? m[a] + logf(l[a]) : INFINITY;
    }
}

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, Shape p) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV), n_q = min(kTile, p.S - q0);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float* q_s = smem;
  float* do_s = q_s + kTile * ld(p.hd);
  float* k_s = do_s + kTile * ld(p.hdv);
  float* v_s = k_s + kTile * ld(p.hd);
  float* ds_s = v_s + kTile * ld(p.hdv);  // dS^T: [key][query]
  float* lse_s = ds_s + kTile * kLdP;
  float* dl_s = lse_s + kTile;
  const size_t q_at = (((size_t)b * p.S + q0) * p.H + h);
  load_rows(q_s, q + q_at * p.hd, (size_t)p.H * p.hd, n_q, p.hd, p.scale,
            true);
  load_rows(do_s, dout + q_at * p.hdv, (size_t)p.H * p.hdv, n_q, p.hdv, 1.f,
            false);
  load_row_stats(p, b, h, q0, n_q, lse, delta, lse_s, dl_s);
  float acc[MT][4][4] = {};
  int k_lo, k_hi;
  key_range(p, q0, n_q, &k_lo, &k_hi);
  for (int k0 = k_lo; k0 <= k_hi; k0 += kTile) {
    __syncthreads();
    const size_t k_at = ((size_t)b * p.T + k0) * p.KV + kvh;
    const int n_k = min(kTile, p.T - k0);
    load_rows(k_s, k + k_at * p.hd, (size_t)p.KV * p.hd, n_k, p.hd, 1.f,
              false);
    load_rows(v_s, v + k_at * p.hdv, (size_t)p.KV * p.hdv, n_k, p.hdv, 1.f,
              false);
    __syncthreads();
    float s[4][4], dp[4][4];
    nt_tile(q_s, k_s, p.hd, ty, tx, s);
    nt_tile(do_s, v_s, p.hdv, ty, tx, dp);
    probs<T>(p, q0, k0, ty, tx, lse_s, s);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = ty + 16 * a;
        ds_s[(tx + 16 * c) * kLdP + i] = s[a][c] * (dp[a][c] - dl_s[i]);
      }
    __syncthreads();
    tn_acc<MT>(ds_s, k_s, p.hd, acc);
  }
  store_tiles<T, MT>(dq + q_at * p.hd, (size_t)p.H * p.hd, p.hd, n_q,
                     p.scale, acc);
}

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, Shape p) {
  extern __shared__ float smem[];
  const int k0 = blockIdx.x * kTile, kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KV, n_k = min(kTile, p.T - k0);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float* k_s = smem;
  float* v_s = k_s + kTile * ld(p.hd);
  float* q_s = v_s + kTile * ld(p.hdv);
  float* do_s = q_s + kTile * ld(p.hd);
  float* pb = do_s + kTile * ld(p.hdv);  // P, then dS: [query][key]
  float* lse_s = pb + kTile * kLdP;
  float* dl_s = lse_s + kTile;
  const size_t k_at = ((size_t)b * p.T + k0) * p.KV + kvh;
  load_rows(k_s, k + k_at * p.hd, (size_t)p.KV * p.hd, n_k, p.hd, 1.f, false);
  load_rows(v_s, v + k_at * p.hdv, (size_t)p.KV * p.hdv, n_k, p.hdv, 1.f,
            false);
  float dk_acc[MT][4][4] = {}, dv_acc[MT][4][4] = {};
  // the query rows that see a key of this tile
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi = p.window > 0 ? min(p.S - 1, k0 + n_k - 1 + p.window - 1)
                                : p.S - 1;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int q0 = q_lo; q0 <= q_hi; q0 += kTile) {
      const int n_q = min(kTile, p.S - q0);
      const size_t q_at = ((size_t)b * p.S + q0) * p.H + h;
      __syncthreads();
      load_rows(q_s, q + q_at * p.hd, (size_t)p.H * p.hd, n_q, p.hd, p.scale,
                true);
      load_rows(do_s, dout + q_at * p.hdv, (size_t)p.H * p.hdv, n_q, p.hdv,
                1.f, false);
      load_row_stats(p, b, h, q0, n_q, lse, delta, lse_s, dl_s);
      __syncthreads();
      float s[4][4], dp[4][4];
      nt_tile(q_s, k_s, p.hd, ty, tx, s);
      nt_tile(do_s, v_s, p.hdv, ty, tx, dp);
      probs<T>(p, q0, k0, ty, tx, lse_s, s);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          pb[(ty + 16 * a) * kLdP + tx + 16 * c] = s[a][c];
      __syncthreads();
      tn_acc<MT>(pb, do_s, p.hdv, dv_acc);
      __syncthreads();
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ty + 16 * a;
          pb[i * kLdP + tx + 16 * c] = s[a][c] * (dp[a][c] - dl_s[i]);
        }
      __syncthreads();
      tn_acc<MT>(pb, q_s, p.hd, dk_acc);
    }
  }
  store_tiles<T, MT>(dk + k_at * p.hd, (size_t)p.KV * p.hd, p.hd, n_k, 1.f,
                     dk_acc);
  store_tiles<T, MT>(dv + k_at * p.hdv, (size_t)p.KV * p.hdv, p.hdv, n_k, 1.f,
                     dv_acc);
}

inline size_t prep_smem(const Shape& p) {
  return sizeof(float) * 2 * kTile * ld(p.hd);
}

// dq and dk/dv: two (kTile, hd) and two (kTile, hdv) tiles, the P/dS tile
// and two rows of row statistics
inline size_t grad_smem(const Shape& p) {
  return sizeof(float) * (kTile * (2 * ld(p.hd) + 2 * ld(p.hdv)) +
                          kTile * kLdP + 2 * kTile);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int MT>
int launch_mt(const void* q, const void* k, const void* v, const void* out,
              const void* dout, void* dq, void* dk, void* dv, float* lse,
              float* delta, const Shape& p, cudaStream_t st) {
  const size_t ps = prep_smem(p), gs = grad_smem(p);
  if (gs > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = allow_smem(prep_kernel<T>, ps)) != cudaSuccess) return (int)e;
  if ((e = allow_smem(dq_kernel<T, MT>, gs)) != cudaSuccess) return (int)e;
  if ((e = allow_smem(dkdv_kernel<T, MT>, gs)) != cudaSuccess) return (int)e;
  const dim3 q_grid((p.S + kTile - 1) / kTile, p.H, p.B);
  const dim3 k_grid((p.T + kTile - 1) / kTile, p.KV, p.B);
  const T* qt = (const T*)q;
  const T* kt = (const T*)k;
  const T* vt = (const T*)v;
  const T* dot = (const T*)dout;
  prep_kernel<T><<<q_grid, kThreads, ps, st>>>(qt, kt, (const T*)out, dot,
                                               lse, delta, p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dq_kernel<T, MT><<<q_grid, kThreads, gs, st>>>(qt, kt, vt, dot, lse, delta,
                                                 (T*)dq, p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dkdv_kernel<T, MT><<<k_grid, kThreads, gs, st>>>(
      qt, kt, vt, dot, lse, delta, (T*)dk, (T*)dv, p);
  return (int)cudaGetLastError();
}

// MT = ceil(max(hd, hdv) / 64): each thread's accumulator tiles
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, void* dq, void* dk, void* dv, void* lse,
           void* delta, const Shape& p, void* stream) {
  const int n = max(p.hd, p.hdv);
  auto st = (cudaStream_t)stream;
  auto* ls = (float*)lse;
  auto* dl = (float*)delta;
  if (n <= 64)
    return launch_mt<T, 1>(q, k, v, out, dout, dq, dk, dv, ls, dl, p, st);
  if (n <= 128)
    return launch_mt<T, 2>(q, k, v, out, dout, dq, dk, dv, ls, dl, p, st);
  if (n <= 192)
    return launch_mt<T, 3>(q, k, v, out, dout, dq, dk, dv, ls, dl, p, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash_bwd
}  // namespace kern

// q (B, S, H, hd), k (B, T, KV, hd), v (B, T, KV, hdv), out and dout
// (B, S, H, hdv) -> dq, dk, dv of the same shapes; lse and delta: (B, H, S)
// f32 scratch.  hd and hdv multiples of 8, at most 192.
#define FLASH_BACKWARD_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const void* out, const void* dout, void* dq, void* dk, \
                      void* dv, void* lse, void* delta, int B, int S, int T_, \
                      int H, int KV, int hd, int hdv, int causal, int window, \
                      float scale, void* stream) {                           \
    const kern::flash_bwd::Shape p{B,  S,  T_,     H,      KV,              \
                                   hd, hdv, causal, window, scale};         \
    return kern::flash_bwd::launch<T>(q, k, v, out, dout, dq, dk, dv, lse,  \
                                      delta, p, stream);                    \
  }

FLASH_BACKWARD_ENTRY(flash_attention_backward_f32, float)
FLASH_BACKWARD_ENTRY(flash_attention_backward_bf16, __nv_bfloat16)

// bf16 at hd = hdv = 64, 128 or 192 on the tensor cores: the operands as
// above, lse (B, H, S) the forward's (an input here), delta (B, H, S) f32
// scratch; any other head dim is refused (cudaErrorInvalidValue), the
// wrapper never sends one.  Blocks of 4 warps, rings of 3 stages at hd
// 64 and 2 at 128; at 192 blocks of 8 warps (dq: 128 rows, 205 KB of
// shared memory; dk/dv: 64 keys, two warps to 16 keys, 173 KB), 2 stages.
extern "C" int flash_attention_backward_bf16_mma(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int B, int S, int T_, int H, int KV, int hd, int hdv, int causal,
    int window, float scale, void* stream) {
  namespace bm = kern::bwd_mma;
  using bf16 = __nv_bfloat16;
  auto st = (cudaStream_t)stream;
  if (hd != hdv) return (int)cudaErrorInvalidValue;
  if (hd == 64) {
    const bm::Args<64, 64, 0> p{(const bf16*)q, (const bf16*)k, nullptr,
                                (const bf16*)v, (const bf16*)dout,
                                (const float*)lse, nullptr, S, T_, H, KV,
                                causal, window, scale};
    return bm::launch<64, 64, 0, 3, 4>(p, B, out, (float*)delta, dq, dk, dv,
                                       nullptr, nullptr, st);
  }
  if (hd == 128) {
    const bm::Args<128, 128, 0> p{(const bf16*)q, (const bf16*)k, nullptr,
                                  (const bf16*)v, (const bf16*)dout,
                                  (const float*)lse, nullptr, S, T_, H, KV,
                                  causal, window, scale};
    return bm::launch<128, 128, 0, 2, 4>(p, B, out, (float*)delta, dq, dk,
                                         dv, nullptr, nullptr, st);
  }
  if (hd == 192) {
    const bm::Args<192, 192, 0> p{(const bf16*)q, (const bf16*)k, nullptr,
                                  (const bf16*)v, (const bf16*)dout,
                                  (const float*)lse, nullptr, S, T_, H, KV,
                                  causal, window, scale};
    return bm::launch<192, 192, 0, 2, 8>(p, B, out, (float*)delta, dq, dk,
                                         dv, nullptr, nullptr, st);
  }
  return (int)cudaErrorInvalidValue;
}

// f32 at hd = hdv = 64 or 128 in split TF32 on the tensor cores: the
// operands as above, lse (B, H, S) the forward's (an input here, from
// flash_attention_f32_tf32_lse), delta (B, H, S) f32 scratch; any other
// head dim is refused (cudaErrorInvalidValue), the wrapper never sends
// one.  Blocks of 8 warps (dk/dv: 128 keys; dq: 128 packed rows), 2-stage
// rings of 32-row tiles: 198 KB of shared memory at 128, 103 KB at 64.
extern "C" int flash_attention_backward_f32_tf32(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int B, int S, int T_, int H, int KV, int hd, int hdv, int causal,
    int window, float scale, void* stream) {
  namespace bt = kern::bwd_tf32;
  auto st = (cudaStream_t)stream;
  const bt::Args p{(const float*)q, (const float*)k,    (const float*)v,
                   (const float*)dout, (const float*)lse, nullptr,
                   S, T_, H, KV, causal, window, scale};
  if (hd != hdv) return (int)cudaErrorInvalidValue;
  if (hd == 64)
    return bt::launch<64>(p, B, (const float*)out, (float*)delta,
                          (float*)dq, (float*)dk, (float*)dv, st);
  if (hd == 128)
    return bt::launch<128>(p, B, (const float*)out, (float*)delta,
                           (float*)dq, (float*)dk, (float*)dv, st);
  return (int)cudaErrorInvalidValue;
}

// MLA's operands (common.cuh's MlaDims: nope 128, rope 64, V 128), causal:
// q (B, S, H, 192), k_nope (B, T, H, 128), k_rope (B, T, 64), v and out
// (B, T|S, H, 128), dout (B, S, H, 128), lse (B, H, S) the forward's ->
// dq (B, S, H, 192), dk_nope (B, T, H, 128), d_rope (B, T, 64), dv (B, T,
// H, 128); delta (B, H, S) and rope_part (B, T, ceil(H / 8), 64) f32
// scratch (it may be dq's storage: dq is written last).  Blocks of 8 warps (dq: 128 rows; dk/dv: 128 keys), one an SM
// by shared memory (dq 172 KB, dk/dv 205 KB), 2-stage rings.
extern "C" int flash_attention_backward_mla_bf16_mma(
    const void* q, const void* k_nope, const void* k_rope, const void* v,
    const void* out, const void* dout, void* lse, void* dq, void* dk_nope,
    void* d_rope, void* dv, void* delta, void* rope_part, int B, int S,
    int T_, int H, float scale, void* stream) {
  namespace bm = kern::bwd_mma;
  using bf16 = __nv_bfloat16;
  using D = kern::MlaDims;
  constexpr int kHd = D::kNope + D::kRope;
  const bm::Args<kHd, D::kVd, D::kRope> p{
      (const bf16*)q, (const bf16*)k_nope, (const bf16*)k_rope,
      (const bf16*)v, (const bf16*)dout, (const float*)lse, nullptr, S, T_,
      H, H, 1, 0, scale};
  return bm::launch<kHd, D::kVd, D::kRope, 2, 8>(
      p, B, out, (float*)delta, dq, dk_nope, dv, d_rope, (float*)rope_part,
      (cudaStream_t)stream);
}
