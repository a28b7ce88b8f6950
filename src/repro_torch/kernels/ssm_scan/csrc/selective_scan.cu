// Selective scan (Mamba S6) for Hopper (sm_90a), carried state and
// per-row valid lengths.
//
// Replaces src/repro/kernels/ssm_scan/kernel.py::selective_scan_kernel
// (body _ssm_kernel), the TPU scan
//     h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t ,   y_t = C_t . h_t + D x_t
// over dt, x (B, T, di) and B, C (B, T, N), extended with two inputs the
// paged serving step needs (the TPU op is cold-start only):
//   * h0 (B, di, N) f32, the row's state slab (the TPU kernel starts at 0);
//   * t_valid (B,) int32: step t of row b advances h only if
//     t < t_valid[b].  y_t is computed from the advanced state at every t
//     (the reference's masked scan in models/mamba.py::mamba_paged_step
//     does the same; rows past t_valid are ignored by the caller).
// With h0 = 0 and t_valid = T it is the TPU kernel.  Outputs: y (B, T, di)
// f32 with D x folded in, and h_last (B, di, N) f32.
//
// What bounds it on the card: bytes at T = 1, bytes and exps alike at
// T > 1.  At T = 1 (decode) the state h0/h_last, 2 x 4N bytes per
// channel, is most of the traffic.  Per further (row, step, channel) it
// reads one dt and one x value (bf16: 4 bytes) and writes one f32 y,
// against ~7N f32 operations (exp, the products, the state update, the C
// dot product): at N = 16 about 14 operations per byte, under the ~20
// per byte at which the CUDA cores (67 TFLOP/s f32) rather than the
// memory (3.35 TB/s) would set the time; but the N exps run on the SFUs
// at a fraction of the FMA rate, which brings the two close.
//
// Design: one thread per (row, channel) keeps its N <= 16 state values
// and A row in registers for the whole time loop, so the state crosses
// device memory once in and once out (the TPU kernel kept it in VMEM
// scratch across its sequential time grid).  Threads of a block are
// neighbouring channels of one row: each step's dt and x loads and y
// stores are coalesced along di.  The row's B_t and C_t (2N values per
// step, shared by all channels) are staged in shared memory kTileT steps
// at a time.  Inputs are the model dtype (f32 or bf16), widened in
// registers; all arithmetic is f32, as in the reference (which casts to
// f32 before its scan).
// Later work: split the time loop into chunks across blocks (a two-pass
// scan) when B * di / kThreads leaves SMs idle at long T.

#include "../../csrc/common.cuh"

namespace {

using kern::to_f32;

constexpr int kThreads = 128;
constexpr int kMaxN = 16;
constexpr int kTileT = 32;  // steps of B_t / C_t staged per shared tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ dt,      // (B, T, di)
                      const T* __restrict__ x,       // (B, T, di)
                      const T* __restrict__ Bc,      // (B, T, N)
                      const T* __restrict__ Cc,      // (B, T, N)
                      const float* __restrict__ A,   // (di, N)
                      const float* __restrict__ D,   // (di,)
                      const float* __restrict__ h0,  // (B, di, N)
                      const int* __restrict__ t_valid,  // (B,)
                      float* __restrict__ y,            // (B, T, di)
                      float* __restrict__ h_last,       // (B, di, N)
                      int n_steps, int di, int N) {
  __shared__ float b_s[kTileT * kMaxN];
  __shared__ float c_s[kTileT * kMaxN];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < di;
  const int tv = t_valid[b];
  const size_t state = ((size_t)b * di + d) * N;

  float h[kMaxN], a[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    h[n] = (live && n < N) ? h0[state + n] : 0.f;
    a[n] = (live && n < N) ? A[(size_t)d * N + n] : 0.f;
  }
  const float dd = live ? D[d] : 0.f;

  for (int t0 = 0; t0 < n_steps; t0 += kTileT) {
    const int nt = min(kTileT, n_steps - t0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < nt * N; i += kThreads) {
      const int j = i / N, n = i - j * N;
      const size_t src = ((size_t)b * n_steps + t0 + j) * N + n;
      b_s[j * kMaxN + n] = to_f32(Bc[src]);
      c_s[j * kMaxN + n] = to_f32(Cc[src]);
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < nt; ++j) {
      const int t = t0 + j;
      const size_t off = ((size_t)b * n_steps + t) * di + d;
      const float dtv = to_f32(dt[off]);
      const float xv = to_f32(x[off]);
      const float drive = dtv * xv;
      const bool advance = t < tv;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        if (n < N) {
          const float hn =
              expf(dtv * a[n]) * h[n] + drive * b_s[j * kMaxN + n];
          acc = fmaf(hn, c_s[j * kMaxN + n], acc);
          if (advance) h[n] = hn;
        }
      }
      y[off] = acc + dd * xv;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < kMaxN; ++n)
      if (n < N) h_last[state + n] = h[n];
  }
}

template <typename T>
int launch(const void* dt, const void* x, const void* Bc, const void* Cc,
           const void* A, const void* D, const void* h0, const void* t_valid,
           void* y, void* h_last, int B, int n_steps, int di, int N,
           void* stream) {
  if (N < 1 || N > kMaxN) return (int)cudaErrorInvalidValue;
  const dim3 grid((di + kThreads - 1) / kThreads, B);
  selective_scan_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)dt, (const T*)x, (const T*)Bc, (const T*)Cc,
      (const float*)A, (const float*)D, (const float*)h0,
      (const int*)t_valid, (float*)y, (float*)h_last, n_steps, di, N);
  return (int)cudaGetLastError();
}

}  // namespace

#define SELECTIVE_SCAN_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const void* dt, const void* x, const void* Bc,       \
                      const void* Cc, const void* A, const void* D,        \
                      const void* h0, const void* t_valid, void* y,        \
                      void* h_last, int B, int n_steps, int di, int N,     \
                      void* stream) {                                       \
    return launch<T>(dt, x, Bc, Cc, A, D, h0, t_valid, y, h_last, B,       \
                     n_steps, di, N, stream);                               \
  }

SELECTIVE_SCAN_ENTRY(selective_scan_f32, float)
SELECTIVE_SCAN_ENTRY(selective_scan_bf16, __nv_bfloat16)
