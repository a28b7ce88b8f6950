// The gradient of the unmasked selective scan (B5') for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package differentiates its scan through
// XLA (src/repro/models/mamba.py::selective_scan, chunks under
// jax.checkpoint), and src/repro/kernels/ssm_scan/kernel.py::
// selective_scan_kernel has no backward.  It is the backward that
// training on the card needs, because the port's forward is the
// hand-written B5 (selective_scan.cu), whose output torch cannot
// differentiate.  The plain version is ssm_scan/ops.py::
// selective_scan_backward_plain.
//
// The forward, per (row b, channel d, state n):
//     h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t ,  y_t = C_t . h_t + D x_t
// from h0, every row valid for all T steps.  With g_t the gradient that
// reaches h_t (from dh_last, the incoming gradient of the last state,
// back to the first step):
//     g_t   = dy_t C_t + exp(dt_{t+1} A) g_{t+1}
//     dC_t  = sum_d dy_t h_t            dB_t = sum_d g_t dt_t x_t
//     ddt_t = sum_n g_t (A exp(dt_t A) h_{t-1} + x_t B_t)
//     dx_t  = dt_t sum_n g_t B_t + D dy_t
//     dA    = sum_{b,t} g_t exp(dt_t A) h_{t-1} dt_t
//     dD    = sum_{b,t} dy_t x_t        dh0 = exp(dt_1 A) g_1
// Inputs: dt, x (B, T, di) and B, C (B, T, N) in the model type (f32 or
// bf16; B and C through the forward's row stride ldbc, so the split views
// of the x_proj output go in as they are), A (di, N), D (di,), the states
// the forward's checkpointing entry stored (B, ceil(T / 16), di, N) f32,
// dy (B, T, di) f32 and dh_last (B, di, N) f32 or null (zero).  Outputs:
// ddt, dx in the model type; dB, dC contiguous (B, T, N) in the model
// type; dA (di, N), dD (di,) and dh0 (B, di, N) f32.
//
// Two kernels on the caller's stream:
//   * scan_backward_kernel: the forward's ownership, one thread per (row,
//     channel, a quad of n), 128 threads a block.  Chunks of kChunk = 16
//     steps run from the last to the first.  A block stages the chunk's
//     dt, x, dy, B and C in shared memory (widened to f32; a ragged
//     chunk's missing steps as dt = 0, the identity), loaded into
//     registers while the chunk before it was walked; each thread
//     recomputes its quad's 16 states from the stored one into registers
//     (the same arithmetic as the forward, so the same bits), then walks
//     them in reverse with g in registers.  dA and dD accumulate over t in
//     registers; ddt and dx sum the channel's lanes by shuffles in a fixed
//     order; dB and dC, which sum over all di channels, are summed over
//     the warp's channels by a reduce-scatter butterfly (7 shuffles for
//     the 8 values of a quad at N = 16), over the block's 4 warps in
//     shared memory, and written as the block's partial (B, T, n_blocks,
//     N); dA and dD as each row's partial (B, di, N) and (B, di).
//   * scan_backward_reduce: sums the partials over the channel blocks (dB,
//     dC) and over the rows (dA, dD) in a fixed order.
// No atomics: every output is written by one thread, the result is
// deterministic (training's --remat run gives the plain run's losses bit
// for bit).
//
// What bounds it at jamba's training shape (B 8, T 512, di 8192, N 16,
// bf16): 537M state values, each needing its decay exp and ~20 f32
// operations (the states themselves, then g, the four gradient terms and
// the carry): ~10.7 GFLOP, 0.16 ms at 67 TFLOP/s; its bytes (dt, x and dy
// read, ddt and dx written: 12 a (row, step, channel); 403 MB) 0.12 ms.
// This first design takes ~7x that (1.11 ms on an H100 80GB HBM3 at
// 700 W; PERF.md §6).  Where it goes:
//   * each block's own latency: 32 chunks of a recompute and a reverse
//     walk whose steps wait on shuffles and the g chain (the B = 1 row,
//     256 blocks, takes a fifth of B = 8's 2048), and 168 registers a
//     thread (the 64 of the chunk's states among them) leave room for 3
//     blocks an SM, so B = 8 runs ~5 waves of them;
//   * a second exp per state value: the reverse walk recomputes the decay
//     rather than keeping 16 more registers a step;
//   * the partials of dB and dC: 256 channel blocks x (B, T, N) x 2 in
//     f32, 268 MB written and read again; wider blocks would shrink them.
// All arithmetic is f32; the decays are ex2.approx of A log2(e) dt, as in
// the forward.

#include "../../csrc/common.cuh"

namespace {

using kern::exp2_ftz;
using kern::from_f32;
using kern::to_f32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// steps a chunk: the stored states' spacing (selective_scan.cu's
// kCkptSteps, ssm_scan/ops.py's CKPT_STEPS)
constexpr int kChunk = 16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// L lanes a channel, kCh channels a block, each lane a quad of the state
// (padded to kNP = 4L values a channel).
template <int L> struct Smem {
  static constexpr int kCh = kThreads / L;
  static constexpr int kNP = 4 * L;
  float dt[kChunk][kCh];
  float x[kChunk][kCh];
  float dy[kChunk][kCh];
  alignas(16) float b[kChunk][kNP];
  alignas(16) float c[kChunk][kNP];
  float ddt[kChunk][kCh];               // the channel's ddt
  float dx[kChunk][kCh];                // the channel's dx
  float wb[kWarps][kChunk][kNP];        // each warp's channel sum of dB
  float wc[kWarps][kChunk][kNP];        // and of dC
  float dd[kCh];                        // D
};

// a quad of an f32 row (n0..n0+3 of N values), zeros past N or for a
// missing row
__device__ __forceinline__ void load_quad(const float* row, int n0, int N,
                                          float* o) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = row != nullptr && n0 + i < N ? row[n0 + i] : 0.f;
}
__device__ __forceinline__ void store_quad(float* row, int n0, int N,
                                           const float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (n0 + i < N) row[n0 + i] = v[i];
}

// One chunk's inputs, a thread's share of the block's, in registers: the
// next chunk's are loaded while this one is walked, so a block waits on
// device memory only where a chunk takes less time than a load.  Raw
// values (the model type; widened when stored to shared memory), so no
// instruction needs them before then.  Steps past the chunk's end (a
// ragged last chunk) load as zeros: dt = 0 makes a step the identity
// (decay 1, no drive) and every gradient term of it 0, so the walks need
// no per-step branch.
template <typename T, int L> struct Ahead {
  static constexpr int kCh = kThreads / L, kNP = 4 * L;
  static constexpr int kPer = kChunk * kCh / kThreads;  // (step, channel)s
  static constexpr int kPerBC = (kChunk * kNP + kThreads - 1) / kThreads;
  T dt[kPer], x[kPer], b[kPerBC], c[kPerBC];
  float dy[kPer], hs[4];  // hs: the state before the chunk's first step

  __device__ __forceinline__ void load(const T* dt_, const T* x_,
                                       const T* Bc, const T* Cc,
                                       const float* dy_, const float* ckpt,
                                       int row, int ch, int n_chunks,
                                       int n_steps, int di, int N, int ldbc,
                                       int d0, int n0, bool live, int d) {
    const int t0 = ch * kChunk, nt = min(kChunk, n_steps - t0);
    const size_t row0 = (size_t)row * n_steps + t0;
    const T zero = from_f32<T>(0.f);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads, j = i / kCh, cc = i % kCh;
      const bool ok = j < nt && d0 + cc < di;
      const size_t off = (row0 + j) * di + d0 + cc;
      dt[k] = ok ? dt_[off] : zero;
      x[k] = ok ? x_[off] : zero;
      dy[k] = ok ? dy_[off] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kPerBC; ++k) {
      const int i = threadIdx.x + k * kThreads, j = i / kNP, n = i % kNP;
      const bool ok = i < kChunk * kNP && j < nt && n < N;
      const size_t off = (row0 + j) * ldbc + n;
      b[k] = ok ? Bc[off] : zero;
      c[k] = ok ? Cc[off] : zero;
    }
    load_quad(live ? ckpt + ((row * (size_t)n_chunks + ch) * di + d) * N
                   : nullptr, n0, N, hs);
  }

  template <typename S>
  __device__ __forceinline__ void store(S& s) const {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads, j = i / kCh, cc = i % kCh;
      s.dt[j][cc] = to_f32(dt[k]);
      s.x[j][cc] = to_f32(x[k]);
      s.dy[j][cc] = dy[k];
    }
#pragma unroll
    for (int k = 0; k < kPerBC; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < kChunk * kNP) {
        s.b[i / kNP][i % kNP] = to_f32(b[k]);
        s.c[i / kNP][i % kNP] = to_f32(c[k]);
      }
    }
  }
};

// Sum v[0..8) over the warp's channels (lane bits L, 2L, ...): a
// reduce-scatter butterfly that halves the values a lane carries at each
// of the first three stages, then sums its one value over the remaining
// bits.  A lane ends with the channel sum of value index
// k = 4 [lane & L] + 2 [lane & 2L] + [lane & 4L]; lanes that differ only
// in higher bits hold the same sum.  Fixed order: deterministic.
template <int L>
__device__ __forceinline__ float channel_sum8(float* v, int lane) {
#pragma unroll
  for (int h = 4, o = L; h >= 1; h >>= 1, o <<= 1) {
    const bool upper = lane & o;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = upper ? v[i] : v[i + h];
      const float keep = upper ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
#pragma unroll
  for (int o = 8 * L; o < 32; o <<= 1) v[0] += __shfl_xor_sync(kFull, v[0], o);
  return v[0];
}

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
scan_backward_kernel(const T* __restrict__ dt,        // (B, T, di)
                     const T* __restrict__ x,         // (B, T, di)
                     const T* __restrict__ Bc,        // (B, T, N), ldbc
                     const T* __restrict__ Cc,        // (B, T, N), ldbc
                     const float* __restrict__ A,     // (di, N)
                     const float* __restrict__ D,     // (di,)
                     const float* __restrict__ ckpt,  // (B, n_chunks, di, N)
                     const float* __restrict__ dy,    // (B, T, di)
                     const float* __restrict__ dh_last,  // (B, di, N) or null
                     T* __restrict__ d_dt,            // (B, T, di)
                     T* __restrict__ d_x,             // (B, T, di)
                     float* __restrict__ dh0,         // (B, di, N)
                     float* __restrict__ ws_b,        // (B, T, n_blk, N)
                     float* __restrict__ ws_c,        // (B, T, n_blk, N)
                     float* __restrict__ ws_a,        // (B, di, N)
                     float* __restrict__ ws_d,        // (B, di)
                     int n_steps, int di, int N, int ldbc) {
  using S = Smem<L>;
  constexpr int kCh = S::kCh, kNP = S::kNP;
  __shared__ S s;
  const int b = blockIdx.y, blk = blockIdx.x, n_blk = gridDim.x;
  const int c = threadIdx.x / L, q = threadIdx.x % L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d0 = blk * kCh, d = d0 + c, n0 = 4 * q;
  const bool live = d < di;
  const size_t slab = (size_t)di * N;
  const size_t row0 = (size_t)b * n_steps;
  const int n_chunks = (n_steps + kChunk - 1) / kChunk;

  // A (natural and scaled by log2 e), the carried gradient g (starts at
  // dh_last) and dA, a quad each; pad lanes and dead channels hold zeros
  // and contribute exactly 0
  float an[4], a2[4], g[4], da[4] = {0.f, 0.f, 0.f, 0.f};
  load_quad(live ? A + (size_t)d * N : nullptr, n0, N, an);
  load_quad(live && dh_last ? dh_last + b * slab + (size_t)d * N : nullptr,
            n0, N, g);
#pragma unroll
  for (int i = 0; i < 4; ++i) a2[i] = an[i] * kLog2e;
  float dd_acc = 0.f;  // sum_t dy x of the channel (lane 0)
  for (int i = threadIdx.x; i < kCh; i += kThreads)
    s.dd[i] = d0 + i < di ? D[d0 + i] : 0.f;

  Ahead<T, L> ahead;
  const auto load = [&](int ch) {
    ahead.load(dt, x, Bc, Cc, dy, ckpt, b, ch, n_chunks, n_steps, di, N,
               ldbc, d0, n0, live, d);
  };
  if (n_chunks > 0) load(n_chunks - 1);

  for (int ch = n_chunks - 1; ch >= 0; --ch) {
    const int t0 = ch * kChunk, nt = min(kChunk, n_steps - t0);
    __syncthreads();  // the last chunk's shared values are consumed
    ahead.store(s);
    const float hs[4] = {ahead.hs[0], ahead.hs[1], ahead.hs[2],
                         ahead.hs[3]};
    __syncthreads();
    if (ch > 0) load(ch - 1);  // in flight while this chunk is walked

    // the chunk's states, recomputed as the forward computes them:
    // hist[j] = the state after step t0 + j
    float hist[kChunk][4];
    {
      float h[4] = {hs[0], hs[1], hs[2], hs[3]};
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float dtv = s.dt[j][c], drive = dtv * s.x[j][c];
        const float4 bq = *reinterpret_cast<const float4*>(&s.b[j][n0]);
        h[0] = fmaf(exp2_ftz(dtv * a2[0]), h[0], drive * bq.x);
        h[1] = fmaf(exp2_ftz(dtv * a2[1]), h[1], drive * bq.y);
        h[2] = fmaf(exp2_ftz(dtv * a2[2]), h[2], drive * bq.z);
        h[3] = fmaf(exp2_ftz(dtv * a2[3]), h[3], drive * bq.w);
#pragma unroll
        for (int i = 0; i < 4; ++i) hist[j][i] = h[i];
      }
    }

    // the reverse walk: straight-line code over the chunk (no per-step
    // branch), so the steps' shuffles and loads overlap
#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      const float dtv = s.dt[j][c], xv = s.x[j][c], dyv = s.dy[j][c];
      const float4 b4 = *reinterpret_cast<const float4*>(&s.b[j][n0]);
      const float4 c4 = *reinterpret_cast<const float4*>(&s.c[j][n0]);
      const float bq[4] = {b4.x, b4.y, b4.z, b4.w};
      const float cq[4] = {c4.x, c4.y, c4.z, c4.w};
      const float dtx = dtv * xv;
      float pdt = 0.f, pdx = 0.f, v[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float hp = j > 0 ? hist[j > 0 ? j - 1 : 0][i] : hs[i];
        const float e = exp2_ftz(dtv * a2[i]);
        const float gi = fmaf(dyv, cq[i], g[i]);
        const float ah = e * hp;
        pdt = fmaf(gi, fmaf(an[i], ah, xv * bq[i]), pdt);
        pdx = fmaf(gi, bq[i], pdx);
        da[i] = fmaf(gi * ah, dtv, da[i]);
        v[i] = gi * dtx;                 // dB's term
        v[4 + i] = dyv * hist[j][i];     // dC's term
        g[i] = e * gi;
      }
      // the channel's lanes, in a fixed order
#pragma unroll
      for (int o = 1; o < L; o <<= 1) {
        pdt += __shfl_xor_sync(kFull, pdt, o);
        pdx += __shfl_xor_sync(kFull, pdx, o);
      }
      if (q == 0) {
        s.ddt[j][c] = pdt;
        s.dx[j][c] = fmaf(dtv, pdx, s.dd[c] * dyv);
        dd_acc = fmaf(dyv, xv, dd_acc);
      }
      const float sum = channel_sum8<L>(v, lane);
      if (lane < 8 * L) {
        const int k = (lane & L ? 4 : 0) + (lane & (2 * L) ? 2 : 0) +
                      (lane & (4 * L) ? 1 : 0);
        (k < 4 ? s.wb : s.wc)[warp][j][n0 + (k & 3)] = sum;
      }
    }
    __syncthreads();  // the chunk's ddt, dx and warp sums are in
    for (int i = threadIdx.x; i < nt * kCh; i += kThreads) {
      const int j = i / kCh, cc = i % kCh;
      if (d0 + cc < di) {
        const size_t off = (row0 + t0 + j) * di + d0 + cc;
        d_dt[off] = from_f32<T>(s.ddt[j][cc]);
        d_x[off] = from_f32<T>(s.dx[j][cc]);
      }
    }
    // the block's partial of dB and dC: its warps' sums in a fixed order
    for (int i = threadIdx.x; i < nt * N; i += kThreads) {
      const int j = i / N, n = i % N;
      float sb = s.wb[0][j][n], sc = s.wc[0][j][n];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        sb += s.wb[w][j][n];
        sc += s.wc[w][j][n];
      }
      const size_t off = ((row0 + t0 + j) * n_blk + blk) * N + n;
      ws_b[off] = sb;
      ws_c[off] = sc;
    }
  }

  if (!live) return;
  store_quad(dh0 + b * slab + (size_t)d * N, n0, N, g);
  store_quad(ws_a + b * slab + (size_t)d * N, n0, N, da);
  if (q == 0) ws_d[(size_t)b * di + d] = dd_acc;
}

// dB, dC: the channel blocks' partials summed in block order; dA, dD: the
// rows' partials summed in row order.
template <typename T>
__global__ void scan_backward_reduce(const float* __restrict__ ws_b,
                                     const float* __restrict__ ws_c,
                                     const float* __restrict__ ws_a,
                                     const float* __restrict__ ws_d,
                                     T* __restrict__ d_B,
                                     T* __restrict__ d_C,
                                     float* __restrict__ dA,
                                     float* __restrict__ dD, int B,
                                     int n_steps, int di, int N, int n_blk) {
  const size_t n_bc = (size_t)B * n_steps * N, n_a = (size_t)di * N;
  const size_t total = n_bc + n_a + di;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    if (i < n_bc) {
      const size_t base = i / N * n_blk * N + i % N;
      float sb = 0.f, sc = 0.f;
      for (int k = 0; k < n_blk; ++k) {
        sb += ws_b[base + (size_t)k * N];
        sc += ws_c[base + (size_t)k * N];
      }
      d_B[i] = from_f32<T>(sb);
      d_C[i] = from_f32<T>(sc);
    } else if (i < n_bc + n_a) {
      const size_t j = i - n_bc;
      float sa = 0.f;
      for (int r = 0; r < B; ++r) sa += ws_a[r * n_a + j];
      dA[j] = sa;
    } else {
      const size_t j = i - n_bc - n_a;
      float sd = 0.f;
      for (int r = 0; r < B; ++r) sd += ws_d[(size_t)r * di + j];
      dD[j] = sd;
    }
  }
}

template <typename T, int L>
int launch_l(const void* dt, const void* x, const void* Bc, const void* Cc,
             const void* A, const void* D, const void* ckpt, const void* dy,
             const void* dh_last, void* d_dt, void* d_x, void* d_B,
             void* d_C, void* dA, void* dD, void* dh0, void* ws_bc,
             void* ws_a, void* ws_d, int B, int n_steps, int di, int N,
             int ldbc, cudaStream_t stream) {
  constexpr int kCh = Smem<L>::kCh;
  const int n_blk = (di + kCh - 1) / kCh;
  float* ws_b = (float*)ws_bc;
  float* ws_c = ws_b + (size_t)B * n_steps * n_blk * N;
  scan_backward_kernel<T, L><<<dim3(n_blk, B), kThreads, 0, stream>>>(
      (const T*)dt, (const T*)x, (const T*)Bc, (const T*)Cc,
      (const float*)A, (const float*)D, (const float*)ckpt,
      (const float*)dy, (const float*)dh_last, (T*)d_dt, (T*)d_x,
      (float*)dh0, ws_b, ws_c, (float*)ws_a, (float*)ws_d, n_steps, di, N,
      ldbc);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const size_t total = (size_t)B * n_steps * N + (size_t)di * N + di;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                      : 4096);
  scan_backward_reduce<T><<<blocks, 256, 0, stream>>>(
      ws_b, ws_c, (const float*)ws_a, (const float*)ws_d, (T*)d_B, (T*)d_C,
      (float*)dA, (float*)dD, B, n_steps, di, N, n_blk);
  return (int)cudaGetLastError();
}

}  // namespace

// ws_bc: (2, B, T, n_blk, N) f32 with n_blk = ceil(di / (128 / L)), L = 1,
// 2 or 4 as N <= 4, 8, 16 (ops.py::backward_blocks); ws_a (B, di, N) and
// ws_d (B, di) f32.
#define SELECTIVE_SCAN_BACKWARD_ENTRY(NAME, T)                               \
  extern "C" int NAME(const void* dt, const void* x, const void* Bc,        \
                      const void* Cc, const void* A, const void* D,         \
                      const void* ckpt, const void* dy,                     \
                      const void* dh_last, void* d_dt, void* d_x,           \
                      void* d_B, void* d_C, void* dA, void* dD, void* dh0,  \
                      void* ws_bc, void* ws_a, void* ws_d, int B,           \
                      int n_steps, int di, int N, int ldbc, void* stream) { \
    if (N < 1 || N > 16 || ldbc < N || B < 1 || di < 1 || n_steps < 1)     \
      return (int)cudaErrorInvalidValue;                                     \
    const cudaStream_t st = (cudaStream_t)stream;                            \
    if (N <= 4)                                                              \
      return launch_l<T, 1>(dt, x, Bc, Cc, A, D, ckpt, dy, dh_last, d_dt,   \
                            d_x, d_B, d_C, dA, dD, dh0, ws_bc, ws_a, ws_d,  \
                            B, n_steps, di, N, ldbc, st);                    \
    if (N <= 8)                                                              \
      return launch_l<T, 2>(dt, x, Bc, Cc, A, D, ckpt, dy, dh_last, d_dt,   \
                            d_x, d_B, d_C, dA, dD, dh0, ws_bc, ws_a, ws_d,  \
                            B, n_steps, di, N, ldbc, st);                    \
    return launch_l<T, 4>(dt, x, Bc, Cc, A, D, ckpt, dy, dh_last, d_dt,     \
                          d_x, d_B, d_C, dA, dD, dh0, ws_bc, ws_a, ws_d, B, \
                          n_steps, di, N, ldbc, st);                         \
  }

SELECTIVE_SCAN_BACKWARD_ENTRY(selective_scan_backward_f32, float)
SELECTIVE_SCAN_BACKWARD_ENTRY(selective_scan_backward_bf16, __nv_bfloat16)
