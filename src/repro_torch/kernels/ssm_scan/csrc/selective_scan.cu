// Selective scan (Mamba S6) for Hopper (sm_90a): carried state, per-row
// valid lengths, and a slab entry that reads and writes the serving
// engine's state pool in place.
//
// Replaces src/repro/kernels/ssm_scan/kernel.py::selective_scan_kernel
// (body _ssm_kernel), the TPU scan
//     h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t ,   y_t = C_t . h_t + D x_t
// over dt, x (B, T, di) and B, C (B, T, N), extended with two inputs the
// paged serving step needs (the TPU op is cold-start only):
//   * h0 (B, di, N) f32, the row's starting state (the TPU kernel starts
//     at 0);
//   * t_valid (B,) int32: step t of row b advances h only if
//     t < t_valid[b].  y_t is computed from the advanced state at every t
//     (the reference's masked scan in models/mamba.py::mamba_paged_step
//     does the same; rows past t_valid are ignored by the caller).
// With h0 = 0 and t_valid = T it is the TPU kernel.  Outputs: y (B, T, di)
// f32 with D x folded in, and the last state (B, di, N) f32.  B and C
// are addressed through a row stride: element (b, t, n) lies at
// (b T + t) ldbc + n, so the strided views that torch.split makes of the
// x_proj output (B, T, dt_rank + 2N) go in as they are.
//
// Three entries share one body, which differs only in where a row's state
// comes from and goes to (the State policy):
//   * selective_scan_*: h0 in, h_last out (RowState);
//   * selective_scan_ckpt_* (training's forward): the same, unmasked
//     (every row valid for all T steps), and the body's kCkpt flag also
//     stores each row's state before steps 0, kCkptSteps, 2 kCkptSteps,
//     ... into ckpt (B, ceil(T / kCkptSteps), di, N) f32, from which the
//     backward (selective_scan_backward.cu) recomputes one chunk at a
//     time.  y and h_last equal the served entry's bit for bit (the same
//     arithmetic; the stores are extra).  kCkptSteps = 8: the backward
//     keeps a chunk's decays in registers so that each decay is one exp,
//     and 8 steps of a quad is what fits beside 5 resident blocks an SM.
//     At jamba's training shape (B 8, T 512, di 8192, N 16) that is 268
//     MB a layer, written here once and read by the backward once (~0.08
//     ms each way at 3.35 TB/s); a state every 16 steps (134 MB) would
//     cost the backward a second exp per state value (~0.13 ms on the
//     special-function units) or twice the registers;
//   * selective_scan_slab_*: the engine's pool (n_slabs, di, N), updated
//     in place (SlabState).  Row b starts from pool[read_rows[b]] (a
//     negative row: from zero, a sequence that starts this step) and
//     leaves its state in pool[write_rows[b]]; null row arrays mean row
//     b.  This folds the per-layer gather, zeroing and scatter of the
//     state slab into the scan.  Precondition, which the engine keeps:
//     rows that write a slab other than the dump row (live rows) hold
//     distinct slabs and read only their own.  An idle row (t_valid 0)
//     may read a slab a live row is rewriting (a stale slot id), but it
//     writes only the dump row and its outputs are ignored, so the race
//     changes nothing the caller reads.  Rows outside [0, n_slabs) are
//     neither read (zero state) nor written.
//
// What bounds it on the card (B = 8, di = 8192, N = 16, bf16 inputs):
//   * bytes.  At T = 1 (decode) the state, 4N bytes per channel in and
//     out, is ~90% of the traffic: 8.4 MB, 2.5 us at 3.35 TB/s.  Per
//     further (row, step, channel) it reads dt and x (4 bytes) and writes
//     one f32 y: at T = 32 7.7 us, at T = 512 80 us (y is most of it).
//   * the exps.  N per (row, step, channel) on the special-function
//     units (16 results per clock per SM): at T = 32 33.5M of them,
//     ~8-9 us at 132 SMs and ~1.9 GHz, level with the byte bound.  The
//     rest is 4 f32 operations per state value on the CUDA cores (8x the
//     SFU rate).
// What the design does about each:
//   * A state quad per thread.  A thread owns (row, channel, 4
//     consecutive n): a quad of h and of A in registers for the whole
//     time loop, so the state crosses device memory once each way.  The
//     L = ceil(N/4) lanes of a channel (rounded up to 1, 2 or 4) are
//     adjacent, so h0, A and the last state move as 16-byte accesses of
//     neighbouring threads to neighbouring addresses (fully coalesced).
//     Pad lanes hold A = 0, B = 0, h = 0 and contribute exactly 0.  At
//     B = 8, di = 8192 that is 262k threads, enough to hide the load
//     latency that one thread per channel (65k) could not.
//   * Staged tiles.  A block (32 channels x 4 lanes at N = 16) stages
//     kSteps = 16 steps of its dt and x columns (model dtype) and of B_t
//     and C_t into shared memory with 16-byte cp.async copies, double
//     buffered: tile i + 1 loads while tile i is scanned.  Shapes whose
//     rows are not 16-byte aligned (odd di, N or B/C stride) stage
//     element by element instead.  Once landed, the tile is widened to
//     f32 once for all lanes (dt, dt x, D x, B, C), so the serial loop
//     reads f32 from shared memory and does no conversions.
//   * No shuffles in the loop.  Each lane writes its C . h_t partial to
//     shared memory; after the tile, one thread per (step, channel) adds
//     the channel's L partials in a fixed order (deterministic) and D x,
//     and a warp stores 32 consecutive y values.  Steps past t_valid run
//     in a second loop that leaves h alone (no per-step predicate).
//   * The exps are one ex2.approx per state value: A is scaled by log2(e)
//     once per thread.  Error: ex2.approx is within 2 ulp, and the
//     rounding of A log2(e) and of dt A' shifts the exponent by
//     ~|dt A| 2^-23, a relative error of ~1e-5 only where the decay is
//     already below 2^-60; outputs stay within the scan tolerance (1e-4,
//     chip_smoke.py's SCAN_TOL) of the plain version's torch.exp.
// What it still loses (PERF.md §6): a block's timeline is the first
// tile's load (at kernel start, when every resident block asks at once),
// then per tile a widening pass, the steps and the y stores between
// three barriers; the steps keep the SFUs busy, the rest of the tile
// does not.  A persistent grid that prefetched the next row's tile
// across rows measured slower (its staged state cost a resident block
// per SM).
// Inputs are the model dtype (f32 or bf16), widened once per tile; all
// arithmetic is f32, as in the reference (which casts to f32 before its
// scan).
// Not done: splitting the time loop across blocks (a two-pass scan).
// At B = 1 and T = 512 the grid is 256 blocks, two per SM, and each
// block walks all 512 steps; chip_smoke.py measures that row
// (PERF.md §6).

#include "../../csrc/common.cuh"

namespace {

using kern::cp_async16;
using kern::cp_async_commit;
using kern::cp_async_wait;
using kern::exp2_ftz;
using kern::from_f32;
using kern::smem_addr;
using kern::to_f32;

constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
// steps between two stored states of the checkpointing entry (it divides
// every staged tile's kSteps); reported by selective_scan_ckpt_steps(),
// which ssm_scan/ops.py holds to its CKPT_STEPS when it loads the library
constexpr int kCkptSteps = 8;

// which loads may go 16 bytes at a time (host-checked)
enum : int { kVecDx = 1, kVecBc = 2, kVecState = 4 };

// Where a row's state comes from and where its last state goes.
struct RowState {
  const float* h0;  // (B, di, N)
  float* h_last;    // (B, di, N)
  __device__ const float* src(int b, size_t slab) const {
    return h0 + b * slab;
  }
  __device__ float* dst(int b, size_t slab) const { return h_last + b * slab; }
};
struct SlabState {
  float* pool;                // (n_slabs, di, N), read and written in place
  const int64_t* read_rows;   // (B,) or null (row b reads slab b)
  const int64_t* write_rows;  // (B,) or null (row b writes slab b)
  int n_slabs;
  __device__ const float* src(int b, size_t slab) const {
    const int64_t r = read_rows ? read_rows[b] : b;
    return r >= 0 && r < n_slabs ? pool + r * slab : nullptr;
  }
  __device__ float* dst(int b, size_t slab) const {
    const int64_t r = write_rows ? write_rows[b] : b;
    return r >= 0 && r < n_slabs ? pool + r * slab : nullptr;
  }
};

// L lanes per channel, kCh channels per block, state padded to 4L,
// kSteps steps per staged tile.  The raw tiles are double buffered (the
// cp.async copies of tile i + 1 land there while tile i is scanned); the
// widened tile, the lanes' partial outputs and D x are single buffered.
template <typename T, int L> struct Smem {
  static constexpr int kCh = kThreads / L;
  static constexpr int kNP = 4 * L;
  static constexpr int kSteps = L == 1 ? 8 : 16;
  alignas(16) T dt[2][kSteps][kCh];
  alignas(16) T x[2][kSteps][kCh];
  alignas(16) T b[2][kSteps][kNP];
  alignas(16) T c[2][kSteps][kNP];
  alignas(16) float dtf[kSteps][kCh];      // dt
  alignas(16) float drive[kSteps][kCh];    // dt x
  alignas(16) float dx[kSteps][kCh];       // D x
  alignas(16) float bf[kSteps][kNP];
  alignas(16) float cf[kSteps][kNP];
  alignas(16) float part[kSteps][kThreads];  // each lane's C . h
  float dd[kCh];                           // D
};
static_assert(Smem<float, 1>::kSteps % kCkptSteps == 0 &&
                  Smem<float, 4>::kSteps % kCkptSteps == 0,
              "a stored state falls on a step of a staged tile");

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// A quad of a (di, N) f32 row set (h0 or A) into registers; zeros past N
// or for a missing row.
__device__ __forceinline__ void load_quad(const float* row, int n0, int N,
                                          bool vec, float* o) {
  if (row != nullptr && vec && n0 < N) {
    load4(row + n0, o);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = row != nullptr && n0 + i < N ? row[n0 + i] : 0.f;
}

// Store a lane's state quad to row (f32, N values), 16 bytes at once
// where the flag allows.
__device__ __forceinline__ void store_quad(float* row, int n0, int N,
                                           bool vec, const float* h) {
  if (vec) {
    if (n0 < N) *reinterpret_cast<float4*>(row + n0) =
        make_float4(h[0], h[1], h[2], h[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (n0 + i < N) row[n0 + i] = h[i];
  }
}

// Stage steps [row0, row0 + nt) of this block's dt / x columns and of
// B / C into buffer buf.  16-byte cp.async copies where the flags allow
// (a chunk past di zero-fills), else plain loads; both leave zeros in
// the pad values and dead channels.
template <typename T, int L>
__device__ __forceinline__ void stage(Smem<T, L>& s, int buf,
                                      const T* __restrict__ dt,
                                      const T* __restrict__ x,
                                      const T* __restrict__ Bc,
                                      const T* __restrict__ Cc, size_t row0,
                                      int nt, int di, int d0, int N, int ldbc,
                                      int flags) {
  constexpr int kCh = Smem<T, L>::kCh, kNP = Smem<T, L>::kNP;
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte chunk
  const T zero = from_f32<T>(0.f);
  if (flags & kVecDx) {
    constexpr int kChunks = kCh / kPer;
    for (int i = threadIdx.x; i < nt * kChunks; i += kThreads) {
      const int j = i / kChunks, cc = i % kChunks * kPer;
      const bool ok = d0 + cc < di;
      const size_t off = ok ? (row0 + j) * di + d0 + cc : 0;
      cp_async16(smem_addr(&s.dt[buf][j][cc]), dt + off, ok);
      cp_async16(smem_addr(&s.x[buf][j][cc]), x + off, ok);
    }
  } else {
    for (int i = threadIdx.x; i < nt * kCh; i += kThreads) {
      const int j = i / kCh, cc = i % kCh;
      const bool ok = d0 + cc < di;
      const size_t off = (row0 + j) * di + d0 + cc;
      s.dt[buf][j][cc] = ok ? dt[off] : zero;
      s.x[buf][j][cc] = ok ? x[off] : zero;
    }
  }
  constexpr int kBcChunks = kNP * (int)sizeof(T) / 16;  // 0: no 16-byte rows
  if (kBcChunks > 0 && (flags & kVecBc)) {  // N == kNP and 16-byte rows
    constexpr int kChunks = kBcChunks > 0 ? kBcChunks : 1;
    for (int i = threadIdx.x; i < nt * kChunks; i += kThreads) {
      const int j = i / kChunks, cc = i % kChunks * kPer;
      const size_t off = (row0 + j) * ldbc + cc;
      cp_async16(smem_addr(&s.b[buf][j][cc]), Bc + off, true);
      cp_async16(smem_addr(&s.c[buf][j][cc]), Cc + off, true);
    }
  } else {
    for (int i = threadIdx.x; i < nt * kNP; i += kThreads) {
      const int j = i / kNP, n = i % kNP;
      const size_t off = (row0 + j) * ldbc + n;
      s.b[buf][j][n] = n < N ? Bc[off] : zero;
      s.c[buf][j][n] = n < N ? Cc[off] : zero;
    }
  }
}

// Steps [j0, j1) of the staged tile from the lane's state quad h; each
// lane's C . h_t goes to part[j][lane].  With kAdvance the state moves
// on (t < t_valid), else h stays and only the outputs are computed.
template <bool kAdvance, int L, typename S>
__device__ __forceinline__ void scan_steps(S& s, int j0, int j1,
                                           const float* a, float* h) {
  const int c = threadIdx.x / L, q = threadIdx.x % L;
#pragma unroll 4
  for (int j = j0; j < j1; ++j) {
    const float dtv = s.dtf[j][c], drive = s.drive[j][c];
    float bq[4], cq[4];
    load4(&s.bf[j][4 * q], bq);
    load4(&s.cf[j][4 * q], cq);
    float hn[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      hn[i] = fmaf(exp2_ftz(dtv * a[i]), h[i], drive * bq[i]);
    float acc = hn[0] * cq[0];
#pragma unroll
    for (int i = 1; i < 4; ++i) acc = fmaf(hn[i], cq[i], acc);
    if (kAdvance) {
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = hn[i];
    }
    s.part[j][threadIdx.x] = acc;
  }
}

// the sum of a channel's L partials, in a fixed order
template <int L> __device__ __forceinline__ float lane_sum(const float* p) {
  if constexpr (L == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    return (v.x + v.y) + (v.z + v.w);
  } else if constexpr (L == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    return v.x + v.y;
  } else {
    return p[0];
  }
}

template <typename T, int L, typename State, bool kCkpt>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ dt,      // (B, T, di)
                      const T* __restrict__ x,       // (B, T, di)
                      const T* __restrict__ Bc,      // (B, T, N), stride ldbc
                      const T* __restrict__ Cc,      // (B, T, N), stride ldbc
                      const float* __restrict__ A,   // (di, N)
                      const float* __restrict__ D,   // (di,)
                      State state,
                      const int* __restrict__ t_valid,  // (B,)
                      float* __restrict__ y,            // (B, T, di)
                      float* __restrict__ ckpt,  // kCkpt: (B, n_ckpt, di, N)
                      int n_steps, int di, int N, int ldbc, int flags) {
  using S = Smem<T, L>;
  constexpr int kCh = S::kCh, kNP = S::kNP, kSteps = S::kSteps;
  __shared__ __align__(16) unsigned char smem_raw[sizeof(S)];
  S& s = *reinterpret_cast<S*>(smem_raw);
  const int b = blockIdx.y;
  const int c = threadIdx.x / L, q = threadIdx.x % L;
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + c;
  const bool live = d < di;
  const size_t slab = (size_t)di * N;
  const size_t row0 = (size_t)b * n_steps;
  const int n_tiles = (n_steps + kSteps - 1) / kSteps;

  if (n_tiles > 0)
    stage<T, L>(s, 0, dt, x, Bc, Cc, row0, min(kSteps, n_steps), di, d0, N,
                ldbc, flags);
  cp_async_commit();

  // the state quad and A quad (A scaled by log2 e) while tile 0 lands
  const bool vec = flags & kVecState;
  const float* src = state.src(b, slab);
  float h[4], a[4];
  load_quad(live && src ? src + (size_t)d * N : nullptr, 4 * q, N, vec, h);
  load_quad(live ? A + (size_t)d * N : nullptr, 4 * q, N, vec, a);
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] *= kLog2e;
  for (int i = threadIdx.x; i < kCh; i += kThreads)
    s.dd[i] = d0 + i < di ? D[d0 + i] : 0.f;
  const int tv = kCkpt ? n_steps : t_valid[b];

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * kSteps, nt = min(kSteps, n_steps - t0);
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      stage<T, L>(s, buf ^ 1, dt, x, Bc, Cc, row0 + t0 + kSteps,
                  min(kSteps, n_steps - t0 - kSteps), di, d0, N, ldbc, flags);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it has landed; the last y tile is stored
    // widen the tile once for all lanes: dt, dt x, D x, B and C in f32
    for (int i = threadIdx.x; i < nt * kCh; i += kThreads) {
      const int j = i / kCh, cc = i % kCh;
      const float dv = to_f32(s.dt[buf][j][cc]), xv = to_f32(s.x[buf][j][cc]);
      s.dtf[j][cc] = dv;
      s.drive[j][cc] = dv * xv;
      s.dx[j][cc] = s.dd[cc] * xv;
    }
    for (int i = threadIdx.x; i < nt * kNP; i += kThreads) {
      const int j = i / kNP, n = i % kNP;
      s.bf[j][n] = to_f32(s.b[buf][j][n]);
      s.cf[j][n] = to_f32(s.c[buf][j][n]);
    }
    __syncthreads();
    if constexpr (kCkpt) {
      // every step advances h; the state before steps t0, t0 +
      // kCkptSteps, ... is stored on the way (the same steps as below)
      const size_t n_ckpt = (n_steps + kCkptSteps - 1) / kCkptSteps;
      for (int j0 = 0; j0 < nt; j0 += kCkptSteps) {
        if (live)
          store_quad(ckpt + ((b * n_ckpt + (t0 + j0) / kCkptSteps) * di + d)
                                * N, 4 * q, N, vec, h);
        scan_steps<true, L>(s, j0, min(nt, j0 + kCkptSteps), a, h);
      }
    } else {
      const int n_adv = max(0, min(nt, tv - t0));  // steps that advance h
      scan_steps<true, L>(s, 0, n_adv, a, h);
      scan_steps<false, L>(s, n_adv, nt, a, h);
    }
    __syncthreads();  // every lane's partials are in
    for (int i = threadIdx.x; i < nt * kCh; i += kThreads) {
      const int j = i / kCh, cc = i % kCh;
      if (d0 + cc < di)
        y[(row0 + t0 + j) * di + d0 + cc] =
            lane_sum<L>(&s.part[j][cc * L]) + s.dx[j][cc];
    }
  }

  float* dst = state.dst(b, slab);
  if (!live || dst == nullptr) return;
  store_quad(dst + (size_t)d * N, 4 * q, N, vec, h);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T, int L, bool kCkpt, typename State>
int launch_l(const void* dt, const void* x, const void* Bc, const void* Cc,
             const void* A, const void* D, State state, const void* t_valid,
             void* y, void* ckpt, int B, int n_steps, int di, int N,
             int ldbc, int flags, void* stream) {
  constexpr int kCh = Smem<T, L>::kCh;
  const dim3 grid((di + kCh - 1) / kCh, B);
  selective_scan_kernel<T, L, State, kCkpt>
      <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          (const T*)dt, (const T*)x, (const T*)Bc, (const T*)Cc,
          (const float*)A, (const float*)D, state, (const int*)t_valid,
          (float*)y, (float*)ckpt, n_steps, di, N, ldbc, flags);
  return (int)cudaGetLastError();
}

// state_in / state_out: the f32 state arrays the State reads and writes
// (for the 16-byte state flag); ckpt: the stored states (kCkpt) or null
template <typename T, bool kCkpt = false, typename State>
int launch(const void* dt, const void* x, const void* Bc, const void* Cc,
           const void* A, const void* D, State state, const void* state_in,
           const void* state_out, const void* t_valid, void* y, int B,
           int n_steps, int di, int N, int ldbc, void* stream,
           void* ckpt = nullptr) {
  if (N < 1 || N > 16 || ldbc < N || B < 1 || di < 1 || n_steps < 0)
    return (int)cudaErrorInvalidValue;
  const int L = N <= 4 ? 1 : N <= 8 ? 2 : 4;
  const int per = 16 / (int)sizeof(T);
  int flags = 0;
  if (aligned16(dt) && aligned16(x) && di % per == 0) flags |= kVecDx;
  if (aligned16(Bc) && aligned16(Cc) && N == 4 * L && N % per == 0 &&
      ldbc % per == 0)
    flags |= kVecBc;
  if (N % 4 == 0 && aligned16(A) && aligned16(state_in) &&
      aligned16(state_out) && (ckpt == nullptr || aligned16(ckpt)))
    flags |= kVecState;
  switch (L) {
    case 1:
      return launch_l<T, 1, kCkpt>(dt, x, Bc, Cc, A, D, state, t_valid, y,
                                   ckpt, B, n_steps, di, N, ldbc, flags,
                                   stream);
    case 2:
      return launch_l<T, 2, kCkpt>(dt, x, Bc, Cc, A, D, state, t_valid, y,
                                   ckpt, B, n_steps, di, N, ldbc, flags,
                                   stream);
    default:
      return launch_l<T, 4, kCkpt>(dt, x, Bc, Cc, A, D, state, t_valid, y,
                                   ckpt, B, n_steps, di, N, ldbc, flags,
                                   stream);
  }
}

}  // namespace

#define SELECTIVE_SCAN_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const void* dt, const void* x, const void* Bc,       \
                      const void* Cc, const void* A, const void* D,        \
                      const void* h0, const void* t_valid, void* y,        \
                      void* h_last, int B, int n_steps, int di, int N,     \
                      int ldbc, void* stream) {                             \
    const RowState st{(const float*)h0, (float*)h_last};                    \
    return launch<T>(dt, x, Bc, Cc, A, D, st, h0, h_last, t_valid, y, B,   \
                     n_steps, di, N, ldbc, stream);                         \
  }

#define SELECTIVE_SCAN_SLAB_ENTRY(NAME, T)                                  \
  extern "C" int NAME(const void* dt, const void* x, const void* Bc,       \
                      const void* Cc, const void* A, const void* D,        \
                      void* pool, const void* read_rows,                    \
                      const void* write_rows, const void* t_valid, void* y, \
                      int B, int n_steps, int di, int N, int ldbc,          \
                      int n_slabs, void* stream) {                          \
    const SlabState st{(float*)pool, (const int64_t*)read_rows,             \
                       (const int64_t*)write_rows, n_slabs};                \
    return launch<T>(dt, x, Bc, Cc, A, D, st, pool, pool, t_valid, y, B,   \
                     n_steps, di, N, ldbc, stream);                         \
  }

#define SELECTIVE_SCAN_CKPT_ENTRY(NAME, T)                                  \
  extern "C" int NAME(const void* dt, const void* x, const void* Bc,       \
                      const void* Cc, const void* A, const void* D,        \
                      const void* h0, void* y, void* h_last, void* ckpt,   \
                      int B, int n_steps, int di, int N, int ldbc,          \
                      void* stream) {                                       \
    const RowState st{(const float*)h0, (float*)h_last};                    \
    return launch<T, true>(dt, x, Bc, Cc, A, D, st, h0, h_last, nullptr,   \
                           y, B, n_steps, di, N, ldbc, stream, ckpt);       \
  }

SELECTIVE_SCAN_ENTRY(selective_scan_f32, float)
SELECTIVE_SCAN_ENTRY(selective_scan_bf16, __nv_bfloat16)
SELECTIVE_SCAN_SLAB_ENTRY(selective_scan_slab_f32, float)
SELECTIVE_SCAN_SLAB_ENTRY(selective_scan_slab_bf16, __nv_bfloat16)
SELECTIVE_SCAN_CKPT_ENTRY(selective_scan_ckpt_f32, float)
SELECTIVE_SCAN_CKPT_ENTRY(selective_scan_ckpt_bf16, __nv_bfloat16)

// the checkpointing entry's spacing of stored states
extern "C" int selective_scan_ckpt_steps(void) { return kCkptSteps; }
