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
// the forward's checkpointing entry stored (B, ceil(T / 8), di, N) f32,
// dy (B, T, di) f32 and dh_last (B, di, N) f32 or null (zero).  Outputs:
// ddt, dx in the model type; dB, dC contiguous (B, T, N) in the model
// type; dA (di, N), dD (di,) and dh0 (B, di, N) f32.
//
// The work at jamba's training shape (B 8, T 512, di 8192, N 16, bf16):
// 537M state values, each needing its decay exp and ~20 f32 operations
// (the state, g, the four gradient terms, the carry): ~10.7 GFLOP, 0.16
// ms at 67 TFLOP/s; its bytes (dt, x and dy read, ddt and dx written: 12
// a (row, step, channel), 403 MB) 0.12 ms, and the stored states 268 MB
// more.
//
// This design: one thread per (row, channel, a quad of n), 128 threads a
// block (L = 1, 2 or 4 lanes a channel as N <= 4, 8, 16; 128 / L
// channels a block), blocks in clusters of 8 along the channels.  A
// chunk is kChunk = 8 steps, the stored states' spacing
// (selective_scan.cu's kCkptSteps, ops.py's CKPT_STEPS); chunks run from
// the last to the first, each in three passes:
//   * the recompute (forward; the forward's arithmetic, so its bits):
//     each step's decay exp, once, into registers (8 x 4 a thread), the
//     state before it into the thread's own shared-memory slots, and dC's
//     terms dy_t h_t summed over the warp's channels;
//   * the carry (backward): g and every gradient term of a step, from the
//     kept decays and states; only g carries from step to step.  A
//     step's ddt and sum_n g B are summed over the channel's lanes, and
//     its dB terms replace its decays in registers;
//   * the dB sums over the warp's channels, each step on its own.
// A warp's channel sums (channel_sum) halve the quad at the two lowest
// channel bits and add the last value over the rest: 4 shuffles a quad.
// The next chunk's dt, x, dy, B, C and stored state land in shared
// memory by cp.async while a chunk runs; dt, x, dy are widened once for
// all lanes, B and C read raw.  The warps' sums meet in shared memory;
// the 8 blocks of a cluster add theirs in distributed shared memory, in
// block-rank order, one cluster barrier every kExch = 4 chunks, and a
// cluster writes one partial (16.8 MB at jamba's shape, 8x less than a
// partial a block); scan_backward_reduce then sums the clusters'
// partials (dB, dC) and the rows' (dA, dD) in a fixed order.  Launched
// for 5 blocks an SM (__launch_bounds__: 96 registers; ptxas keeps 5
// loop-invariant values in local memory, reloaded in the staging).
//
// What bounds it (PERF.md §6: chip_smoke.py phase 3 logs the time, the
// registers and the passes' instruction mix from the compiled code):
// instruction issue and the shared-memory and shuffle pipe, not bytes or
// the exps.  Beside the ~12 f32 operations a state value, a lane's step
// spends ~2 more a state value on each channel sum (shuffles, adds and
// the selects that pick the half it keeps), plus unpacking B and C from
// bf16 and the loads.  Tried during development and slower on the card, so not
// kept: B and C staged in the 4 lane orders so that the sums need no
// select (faster for bf16, slower for f32), ddt and dx stored by the
// lanes, 2 state values a thread in blocks of 256, and 4 blocks an SM at
// 128 registers.
// No atomics: every output is written by one thread in a fixed order, so
// two launches give the same bits (training's --remat run gives the
// plain run's losses bit for bit).  All arithmetic is f32; the decays
// are ex2.approx of A log2(e) dt, as in the forward.  A ragged last chunk
// loads its missing steps as zeros (dt = 0: decay 1, no drive, every
// gradient term 0), so the passes need no per-step branch; the grid is
// padded to whole clusters with blocks that hold no channel.

#include "../../csrc/common.cuh"

#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;
using kern::cp_async16;
using kern::cp_async4;
using kern::cp_async_commit;
using kern::cp_async_wait;
using kern::exp2_ftz;
using kern::from_f32;
using kern::smem_addr;
using kern::to_f32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 5;  // resident blocks an SM the launch asks for
// state values a thread, a quad: L = kNP / kV lanes a channel
constexpr int kV = 4;
// steps a chunk: the stored states' spacing (selective_scan.cu's
// kCkptSteps), and blocks a cluster.  selective_scan_backward_layout()
// reports both, with the channels a block and the clusters a launch;
// ssm_scan/ops.py holds them to its CKPT_STEPS, BACKWARD_CLUSTER and
// backward_workspace_shape when it loads the library.
constexpr int kChunk = 8;
constexpr int kCluster = 8;
// chunks whose dB/dC sums a cluster exchanges at one barrier
constexpr int kExch = 4;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

// which loads may go 16 bytes at a time (host-checked)
enum : int { kVecDx = 1, kVecDy = 2, kVecBc = 4, kVecState = 8 };

// L lanes a channel, kCh channels a block, each lane kV values of the
// state (padded to kNP = kV L a channel).  The raw chunk is double
// buffered (chunk i - 1 lands while chunk i is walked); the widened
// chunk, the outputs and the warps' sums are single buffered, the
// block's sums double buffered by exchange (the cluster reads them).
template <typename T, int L> struct Smem {
  static constexpr int kCh = kThreads / L;
  static constexpr int kNP = kV * L;
  alignas(16) T dt[2][kChunk][kCh];
  alignas(16) T x[2][kChunk][kCh];
  alignas(16) float dy[2][kChunk][kCh];
  alignas(16) T b[2][kChunk][kNP];
  alignas(16) T c[2][kChunk][kNP];
  alignas(16) float h[2][kCh * kNP];  // the stored state before the chunk
  alignas(16) float4 op[kChunk][kCh];  // dt, dt x, dy, x
  // each thread's states before each step of the chunk (its own slots)
  alignas(16) float4 hs[kChunk][kThreads];
  float red[kChunk][kCh][2];  // a channel's ddt and sum_n g B
  float dd[kCh];              // D
  float w[kWarps][kChunk][2][kNP];   // a warp's channel sums of dB, dC
  // the block's, [dB, dC][chunk of the exchange][step][n], double
  // buffered by exchange parity
  float part[2][2][kExch][kChunk][kNP];
};

// one element of a raw chunk: f32 by a 4-byte cp.async (zero-filled when
// !ok), bf16 by a plain load
__device__ __forceinline__ void stage1(float* dst, const float* src,
                                      bool ok) {
  cp_async4(smem_addr(dst), src, ok);
}
__device__ __forceinline__ void stage1(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, bool ok) {
  *dst = ok ? *src : __float2bfloat16(0.f);
}

// f(i) for i in [0, kN), spread over the block's threads in a fixed
// number of rounds (no loop when kN is a multiple of the block)
template <int kN, typename F>
__device__ __forceinline__ void for_block(const F& f) {
#pragma unroll
  for (int k = 0; k < (kN + kThreads - 1) / kThreads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (kN % kThreads == 0 || i < kN) f(i);
  }
}

// Stage a chunk (nt of kChunk steps) of this block's dt, x, dy columns
// (from dt0, x0, dy0: its first step and channel), B and C (from b0, c0)
// and the stored state before it (from h0: the block's kCh rows of N f32,
// contiguous) into raw buffer buf: 16-byte cp.async copies where the
// flags allow, else element by element.  Steps past nt, dead channels and
// pad states are zeros (so a ragged chunk's missing steps are dt = 0).
template <typename T, int L>
__device__ __forceinline__ void stage(Smem<T, L>& s, int buf, const T* dt0,
                                      const T* x0, const float* dy0,
                                      const T* b0, const T* c0,
                                      const float* h0, int nt, int dleft,
                                      int N, int di, int ldbc, int flags) {
  constexpr int kCh = Smem<T, L>::kCh, kNP = Smem<T, L>::kNP;
  constexpr int kPer = 16 / sizeof(T);
  if (flags & kVecDx) {  // di and the bases in whole 16-byte chunks
    constexpr int kChunks = kCh / kPer;
    for_block<kChunk * kChunks>([&](int i) {
      const int j = i / kChunks, cc = i % kChunks * kPer;
      const bool ok = j < nt && cc < dleft;
      const int off = ok ? j * di + cc : 0;
      cp_async16(smem_addr(&s.dt[buf][j][cc]), dt0 + off, ok);
      cp_async16(smem_addr(&s.x[buf][j][cc]), x0 + off, ok);
    });
  } else {
    for_block<kChunk * kCh>([&](int i) {
      const int j = i / kCh, cc = i % kCh;
      const bool ok = j < nt && cc < dleft;
      const int off = ok ? j * di + cc : 0;
      stage1(&s.dt[buf][j][cc], dt0 + off, ok);
      stage1(&s.x[buf][j][cc], x0 + off, ok);
    });
  }
  if (flags & kVecDy) {
    for_block<kChunk * kCh / 4>([&](int i) {
      const int j = i / (kCh / 4), cc = i % (kCh / 4) * 4;
      const bool ok = j < nt && cc < dleft;
      cp_async16(smem_addr(&s.dy[buf][j][cc]), dy0 + (ok ? j * di + cc : 0),
                 ok);
    });
  } else {
    for_block<kChunk * kCh>([&](int i) {
      const int j = i / kCh, cc = i % kCh;
      const bool ok = j < nt && cc < dleft;
      cp_async4(smem_addr(&s.dy[buf][j][cc]), dy0 + (ok ? j * di + cc : 0),
                ok);
    });
  }
  constexpr int kBcChunks = kNP * (int)sizeof(T) / 16;  // 0: no 16-byte rows
  if (kBcChunks > 0 && (flags & kVecBc)) {  // N == kNP, 16-byte rows
    constexpr int kChunks = kBcChunks > 0 ? kBcChunks : 1;
    for_block<kChunk * kChunks>([&](int i) {
      const int j = i / kChunks, cc = i % kChunks * kPer;
      const bool ok = j < nt;
      const int off = ok ? j * ldbc + cc : 0;
      cp_async16(smem_addr(&s.b[buf][j][cc]), b0 + off, ok);
      cp_async16(smem_addr(&s.c[buf][j][cc]), c0 + off, ok);
    });
  } else {
    for_block<kChunk * kNP>([&](int i) {
      const int j = i / kNP, n = i % kNP;
      const bool ok = j < nt && n < N;
      const int off = ok ? j * ldbc + n : 0;
      stage1(&s.b[buf][j][n], b0 + off, ok);
      stage1(&s.c[buf][j][n], c0 + off, ok);
    });
  }
  if (flags & kVecState) {  // N == kNP and a 16-byte base
    for_block<kCh * kNP / 4>([&](int i) {
      const bool ok = i * 4 / kNP < dleft;
      cp_async16(smem_addr(&s.h[buf][i * 4]), h0 + (ok ? i * 4 : 0), ok);
    });
  } else {
    for_block<kCh * kNP>([&](int i) {
      const int cc = i / kNP, n = i % kNP;
      const bool ok = cc < dleft && n < N;
      cp_async4(smem_addr(&s.h[buf][i]), h0 + (ok ? cc * N + n : 0), ok);
    });
  }
}

// The landed raw chunk's channel values widened once for all lanes: op =
// (dt, dt x, dy, x) a (step, channel) in f32.  The lanes read B and C
// raw.
template <typename T, int L>
__device__ __forceinline__ void widen(Smem<T, L>& s, int buf) {
  constexpr int kCh = Smem<T, L>::kCh, kNP = Smem<T, L>::kNP;
  for_block<kChunk * kCh>([&](int i) {
    const int j = i / kCh, cc = i % kCh;
    const float dv = to_f32(s.dt[buf][j][cc]), xv = to_f32(s.x[buf][j][cc]);
    s.op[j][cc] = make_float4(dv, dv * xv, s.dy[buf][j][cc], xv);
  });
}

// v[0..4), a lane's quad of terms (value i is state n0 + i), summed over
// the warp's channels.  The two lowest channel bits halve the quad: a
// lane keeps the half its bit selects and adds its partner's; further
// bits add the one value left.  v[0] ends with the warp's sum for state
// n0 + m (sum_state).  Fixed order: deterministic.
template <int L> __device__ __forceinline__ void channel_sum(float* v,
                                                             int m) {
  const bool hi = m & 2, odd = m & 1;
  const float k0 = (hi ? v[2] : v[0])
                   + __shfl_xor_sync(kFull, hi ? v[0] : v[2], L);
  const float k1 = (hi ? v[3] : v[1])
                   + __shfl_xor_sync(kFull, hi ? v[1] : v[3], L);
  v[0] = (odd ? k1 : k0) + __shfl_xor_sync(kFull, odd ? k0 : k1, 2 * L);
#pragma unroll
  for (int o = 4 * L; o < 32; o <<= 1) v[0] += __shfl_xor_sync(kFull, v[0], o);
}
// m, the state (less n0) whose warp sum channel_sum leaves with a lane:
// bit 0 of the lane's channel in its warp is bit 1 of m.
template <int L> __device__ __forceinline__ int sum_state(int lane) {
  const int cw = lane / L;
  return ((cw & 1) << 1) | ((cw >> 1) & 1);
}

// A lane's quad of a raw B or C row in f32: 16 bytes of f32, or 8 bytes
// of bf16 widened in registers (half the shared-memory bytes).
__device__ __forceinline__ void load_quad(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load_quad(const __nv_bfloat16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(v.x << 16);
  o[1] = __uint_as_float(v.x & 0xffff0000u);
  o[2] = __uint_as_float(v.y << 16);
  o[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T, int L>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
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
                     float* __restrict__ ws_b,        // (B, T, n_grp, N)
                     float* __restrict__ ws_c,        // (B, T, n_grp, N)
                     float* __restrict__ ws_a,        // (B, di, N)
                     float* __restrict__ ws_d,        // (B, di)
                     int n_steps, int di, int N, int ldbc, int flags) {
  using S = Smem<T, L>;
  constexpr int kCh = S::kCh, kNP = S::kNP;
  // this block's share of an exchange's cluster sums
  constexpr int kShare = 2 * kExch * kChunk * kNP / kCluster;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& s = *reinterpret_cast<S*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y, grp = blockIdx.x / kCluster;
  const int n_grp = gridDim.x / kCluster;
  const int c = threadIdx.x / L, q = threadIdx.x % L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = sum_state<L>(lane);  // the state a warp sum lands on
  const int d0 = blockIdx.x * kCh, d = d0 + c, n0 = kV * q;
  const bool live = d < di;
  // 32-bit offsets (fewer registers across the loop), widened where a
  // product may pass 2^31
  const int slab = di * N, row0 = b * n_steps;
  const int n_chunks = (n_steps + kChunk - 1) / kChunk;

  const auto stage_chunk = [&](int buf, int ch) {
    const size_t off = (size_t)(row0 + ch * kChunk) * di + d0;
    const size_t bc = (size_t)(row0 + ch * kChunk) * ldbc;
    stage<T, L>(s, buf, dt + off, x + off, dy + off, Bc + bc, Cc + bc,
                ckpt + ((size_t)b * n_chunks + ch) * slab + d0 * N,
                min(kChunk, n_steps - ch * kChunk), di - d0, N, di, ldbc,
                flags);
  };
  stage_chunk(0, n_chunks - 1);
  cp_async_commit();

  // A scaled by log2 e, the carried gradient g (from dh_last) and dA,
  // kV values each; pad values and dead channels hold zeros and
  // contribute exactly 0
  float a2[kV], g[kV], da[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int n = n0 + i;
    da[i] = 0.f;
    const bool ok = live && n < N;
    a2[i] = ok ? A[(size_t)d * N + n] * kLog2e : 0.f;
    g[i] = ok && dh_last ? dh_last[(size_t)b * slab + d * N + n] : 0.f;
  }
  for_block<kCh>([&](int i) { s.dd[i] = d0 + i < di ? D[d0 + i] : 0.f; });
  float dd_acc = 0.f;  // sum_t dy x of the channel

  for (int it = 0; it < n_chunks; ++it) {
    const int ch = n_chunks - 1 - it, buf = it & 1;
    const int t0 = ch * kChunk, nt = min(kChunk, n_steps - t0);
    if (ch > 0) {
      stage_chunk(buf ^ 1, ch - 1);  // in flight while this one is walked
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk ch has landed
    widen<T, L>(s, buf);
    __syncthreads();

    // the recompute (the forward's arithmetic, so the forward's bits):
    // each step's decay in registers, the state before it in the
    // thread's shared-memory slots, and dC's terms dy_t h_t summed over
    // the warp's channels on the way
    float e[kChunk][kV];
    {
      float h[kV];
#pragma unroll
      for (int i = 0; i < kV; ++i) h[i] = s.h[buf][c * kNP + n0 + i];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float4 o = s.op[j][c];  // dt, dt x, dy, x
        float bq[kV], vc[kV];
        load_quad(&s.b[buf][j][n0], bq);
        s.hs[j][threadIdx.x] = make_float4(h[0], h[1], h[2], h[3]);
#pragma unroll
        for (int i = 0; i < kV; ++i) {
          e[j][i] = exp2_ftz(o.x * a2[i]);
          h[i] = fmaf(e[j][i], h[i], o.y * bq[i]);
          vc[i] = o.z * h[i];
        }
        channel_sum<L>(vc, m);
        s.w[warp][j][1][n0 + m] = vc[0];
      }
    }
    // the carry, from the chunk's end back to its start: g and the step's
    // gradient terms (only g carries; dA and dD sum).  ddt and sum_n g B
    // are summed over the channel's lanes on the way (even lanes keep
    // ddt, odd lanes the other); each step's decay registers take its dB
    // terms g dt x.
#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      const float4 o = s.op[j][c];  // dt, dt x, dy, x
      const float4 h4 = s.hs[j][threadIdx.x];
      const float hq[kV] = {h4.x, h4.y, h4.z, h4.w};
      float bq[kV], cq[kV];
      load_quad(&s.b[buf][j][n0], bq);
      load_quad(&s.c[buf][j][n0], cq);
      float pa = 0.f, px = 0.f;
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const float gi = fmaf(o.z, cq[i], g[i]);
        g[i] = e[j][i] * gi;
        const float t1 = g[i] * hq[i];  // g_t exp(dt_t A) h_{t-1}
        pa = fmaf(a2[i], t1, pa);
        px = fmaf(gi, bq[i], px);
        da[i] = fmaf(t1, o.x, da[i]);
        e[j][i] = gi * o.y;  // dB's term
      }
      dd_acc = fmaf(o.z, o.w, dd_acc);
      const float pt = fmaf(o.w, px, kLn2 * pa);  // the lane's ddt share
      if constexpr (L == 1) {
        s.red[j][c][0] = pt;
        s.red[j][c][1] = px;
      } else {
        const bool odd = q & 1;
        float keep = (odd ? px : pt)
                     + __shfl_xor_sync(kFull, odd ? pt : px, 1);
#pragma unroll
        for (int k = 2; k < L; k <<= 1) keep += __shfl_xor_sync(kFull, keep, k);
        s.red[j][c][q & 1] = keep;
      }
    }
    // each step's dB terms summed over the warp's channels, every step on
    // its own
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      channel_sum<L>(e[j], m);
      s.w[warp][j][0][n0 + m] = e[j][0];
    }
    __syncthreads();  // the chunk's channel and warp sums are in

    // the block's sums of dB and dC: its warps in a fixed order, into the
    // chunk's slot of the exchange
    const int slot = it % kExch, par = it / kExch & 1;
    for_block<2 * kChunk * kNP>([&](int i) {
      const int wh = i / (kChunk * kNP), j = i / kNP % kChunk, n = i % kNP;
      float v = s.w[0][j][wh][n];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += s.w[w][j][wh][n];
      s.part[par][wh][slot][j][n] = v;
    });
    const bool exchange = slot == kExch - 1 || ch == 0;
    if (exchange) cluster_arrive();  // the block's sums are in
    {
      T* const ddt1 = d_dt + (size_t)(row0 + t0) * di + d0;
      T* const dx1 = d_x + (size_t)(row0 + t0) * di + d0;
      for_block<kChunk * kCh>([&](int i) {
        const int j = i / kCh, cc = i % kCh;
        if (j < nt && d0 + cc < di) {
          const float4 o = s.op[j][cc];
          ddt1[j * di + cc] = from_f32<T>(s.red[j][cc][0]);
          dx1[j * di + cc] =
              from_f32<T>(fmaf(o.x, s.red[j][cc][1], s.dd[cc] * o.z));
        }
      });
    }
    if (exchange) {
      cluster_wait();  // every block's sums are in
      // this block's share of the cluster's sums, in block-rank order
      for_block<kShare>([&](int k) {
        const int i = rank * kShare + k;
        const int wh = i / (kExch * kChunk * kNP);
        const int sl = i / (kChunk * kNP) % kExch;
        const int j = i / kNP % kChunk, n = i % kNP;
        const int c_sl = ch + slot - sl;  // the chunk of slot sl
        const int t = c_sl * kChunk + j;
        if (sl <= slot && t < n_steps && n < N) {
          const float* p = &s.part[par][wh][sl][j][n];
          float v = *cluster.map_shared_rank(p, 0);
#pragma unroll
          for (int r = 1; r < kCluster; ++r)
            v += *cluster.map_shared_rank(p, r);
          (wh ? ws_c : ws_b)[((size_t)(row0 + t) * n_grp + grp) * N + n] =
              v;
        }
      });
    }
  }
  // no block leaves while another reads its sums
  cluster_arrive();
  cluster_wait();

  if (!live) return;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int n = n0 + i;
    if (n < N) {
      dh0[(size_t)b * slab + d * N + n] = g[i];
      ws_a[(size_t)b * slab + d * N + n] = da[i];
    }
  }
  if (q == 0) ws_d[(size_t)b * di + d] = dd_acc;
}

// dB, dC: the clusters' partials summed in cluster order; dA, dD: the
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
                                     int n_steps, int di, int N, int n_grp) {
  const size_t n_bc = (size_t)B * n_steps * N, n_a = (size_t)di * N;
  const size_t total = n_bc + n_a + di;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    if (i < n_bc) {
      const size_t base = i / N * n_grp * N + i % N;
      float sb = 0.f, sc = 0.f;
      for (int k = 0; k < n_grp; ++k) {
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

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// lanes a channel at N states: 1, 2 or 4 as N <= 4, 8, 16
constexpr int lanes_for(int N) { return N <= 4 ? 1 : N <= 8 ? 2 : 4; }

// clusters along di of a launch at N states: kThreads / L channels a
// block, kCluster blocks a cluster, one partial of d_Bc/d_Cc a cluster
int clusters_for(int di, int N) {
  const int ch = kThreads / lanes_for(N);
  return ((di + ch - 1) / ch + kCluster - 1) / kCluster;
}

// The cluster launch of scan_backward_kernel<T, L>: the grid's x padded
// to whole clusters, the shared memory dynamic (the f32 1-lane layout
// passes 48 KB).
template <typename T, int L>
cudaLaunchConfig_t launch_config(int n_grp, int B, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_grp * kCluster, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sizeof(Smem<T, L>);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int L> int set_smem() {
  return (int)cudaFuncSetAttribute(
      scan_backward_kernel<T, L>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem<T, L>));
}

template <typename T, int L>
int launch_l(const void* dt, const void* x, const void* Bc, const void* Cc,
             const void* A, const void* D, const void* ckpt, const void* dy,
             const void* dh_last, void* d_dt, void* d_x, void* d_B,
             void* d_C, void* dA, void* dD, void* dh0, void* ws_bc,
             void* ws_a, void* ws_d, int B, int n_steps, int di, int N,
             int ldbc, cudaStream_t stream) {
  constexpr int kNP = Smem<T, L>::kNP;
  static_assert(Smem<T, L>::kCh == kThreads / L, "channels a block");
  if (lanes_for(N) != L) return (int)cudaErrorInvalidValue;
  const int n_grp = clusters_for(di, N);
  float* ws_b = (float*)ws_bc;
  float* ws_c = ws_b + (size_t)B * n_steps * n_grp * N;
  constexpr int kPer = 16 / sizeof(T);
  int flags = 0;
  if (di % kPer == 0 && aligned16(dt) && aligned16(x)) flags |= kVecDx;
  if (di % 4 == 0 && aligned16(dy)) flags |= kVecDy;
  if (N == kNP && (ldbc * sizeof(T)) % 16 == 0 && aligned16(Bc) &&
      aligned16(Cc))
    flags |= kVecBc;
  if (N == kNP && aligned16(ckpt)) flags |= kVecState;
  int rc = set_smem<T, L>();
  if (rc != 0) return rc;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<T, L>(n_grp, B, stream, &attr);
  rc = (int)cudaLaunchKernelEx(
      &cfg, scan_backward_kernel<T, L>, (const T*)dt, (const T*)x,
      (const T*)Bc, (const T*)Cc, (const float*)A, (const float*)D,
      (const float*)ckpt, (const float*)dy, (const float*)dh_last, (T*)d_dt,
      (T*)d_x, (float*)dh0, ws_b, ws_c, (float*)ws_a, (float*)ws_d,
      n_steps, di, N, ldbc, flags);
  if (rc != 0) return rc;
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const size_t total = (size_t)B * n_steps * N + (size_t)di * N + di;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                      : 4096);
  scan_backward_reduce<T><<<blocks, 256, 0, stream>>>(
      ws_b, ws_c, (const float*)ws_a, (const float*)ws_d, (T*)d_B, (T*)d_C,
      (float*)dA, (float*)dD, B, n_steps, di, N, n_grp);
  return (int)cudaGetLastError();
}

// What the card makes of scan_backward_kernel<T, L>: out[0] registers a
// thread, out[1] local (spill) bytes a thread, out[2] shared bytes a
// block, out[3] resident blocks an SM, out[4] resident clusters on the
// card.
template <typename T, int L> int occupancy(int* out) {
  int rc = set_smem<T, L>();
  if (rc != 0) return rc;
  cudaFuncAttributes fa;
  rc = (int)cudaFuncGetAttributes(&fa, scan_backward_kernel<T, L>);
  if (rc != 0) return rc;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)sizeof(Smem<T, L>);
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], scan_backward_kernel<T, L>, kThreads, sizeof(Smem<T, L>));
  if (rc != 0) return rc;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<T, L>(64, 1, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      &out[4], scan_backward_kernel<T, L>, &cfg);
}

}  // namespace

// ws_bc: (2, B, T, n_grp, N) f32 with n_grp = clusters_for(di, N)
// (ops.py::backward_workspace_shape); ws_a (B, di, N) and ws_d (B, di)
// f32.
#define SELECTIVE_SCAN_BACKWARD_ENTRY(NAME, T)                               \
  extern "C" int NAME(const void* dt, const void* x, const void* Bc,        \
                      const void* Cc, const void* A, const void* D,         \
                      const void* ckpt, const void* dy,                     \
                      const void* dh_last, void* d_dt, void* d_x,           \
                      void* d_B, void* d_C, void* dA, void* dD, void* dh0,  \
                      void* ws_bc, void* ws_a, void* ws_d, int B,           \
                      int n_steps, int di, int N, int ldbc, void* stream) { \
    if (N < 1 || N > 16 || ldbc < N || B < 1 || B > 65535 || di < 1 ||     \
        n_steps < 1)                                                         \
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

// registers, spills, shared memory and residency of the kernel that
// serves (N, the model type): see occupancy() above
extern "C" int selective_scan_backward_occupancy(int N, int f32, int* out) {
  if (N < 1 || N > 16) return (int)cudaErrorInvalidValue;
  const int l = lanes_for(N);
  if (f32)
    return l == 1 ? occupancy<float, 1>(out)
           : l == 2 ? occupancy<float, 2>(out) : occupancy<float, 4>(out);
  return l == 1 ? occupancy<__nv_bfloat16, 1>(out)
         : l == 2 ? occupancy<__nv_bfloat16, 2>(out)
                  : occupancy<__nv_bfloat16, 4>(out);
}

// the layout a launch at (di, N) takes: out[0] steps a chunk (the stored
// states' spacing), out[1] blocks a cluster, out[2] channels a block,
// out[3] state values a thread, out[4] clusters along di (one partial
// of d_Bc/d_Cc each)
extern "C" int selective_scan_backward_layout(int di, int N, int* out) {
  if (N < 1 || N > 16 || di < 1) return (int)cudaErrorInvalidValue;
  out[0] = kChunk;
  out[1] = kCluster;
  out[2] = kThreads / lanes_for(N);
  out[3] = kV;
  out[4] = clusters_for(di, N);
  return 0;
}
