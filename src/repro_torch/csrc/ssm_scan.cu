// Selective scan of the SSM family (Mamba-1), with its D skip: for every
// batch row b and channel d, over the time steps t = 0 .. S - 1,
//
//   h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t      (n states)
//   y_t = C_t . h_t + D x_t
//
// dt and x are (B, S, DI), B_t and C_t rows of (B, S, N), A (DI, N), D
// (DI,), the start state h0 and the final state (B, DI, N), y (B, S, DI);
// all float32 and contiguous.
//
// Replaces no Pallas kernel: src/repro/models/ssm.py::ssm_scan computes
// the recurrence in jnp, chunks of 256 steps each run as a first-order
// lax.associative_scan over (B, 256, DI, N) float32 tensors (decays,
// inputs, their running products and sums, the states), then
// y = einsum(states, C).  At Falcon-Mamba-7B's prefill (B 4, S 2048, DI
// 8192, N 16) each such tensor is 537 MB and a layer writes and reads
// several of them per chunk.  This kernel keeps the states in registers
// instead and moves only its inputs and outputs.
//
// Bound, at that shape: dt and x read once (268 MB each), y written once
// (268 MB), B, C, A, D and the two states 3 MB: 0.81 GB, 0.24 ms at
// 3.35 TB/s.  The decays are B S DI N = 1.07e9 exponentials, one MUFU.EX2
// each, and the H100's 132 SMs issue 16 a clock each: 0.26 ms at 1.98 GHz.
// So the two bounds nearly meet; the MUFU's is the larger.  A warp's
// MUFU.EX2 holds its scheduler's MUFU 8 clocks, and each state-step also
// needs two FMULs, two FMAs and half a 16-byte load of B and C, issued on
// the same scheduler at one instruction a clock: about 6 issue clocks
// for every 8 MUFU clocks, so the schedule has little slack.
//
// Design.
// * Lanes.  L = 1, 2, 4 or 8 neighbouring threads share a (b, channel);
//   lane l holds states [l N/L, (l + 1) N/L) in registers with its slice
//   of A's row pre-scaled by log2(e).  Each state runs
//   h = fma(ex2(dt a2), h, u b) with u = dt x, the same instructions
//   whatever L, so the final states do not depend on L.  The host picks
//   L (kernels/ssm_scan.py::scan_plan): one thread a channel leaves
//   Hymba-1.5B's 3200 channels (12,800 threads) one warp on 400 of the
//   card's 528 schedulers and none on the rest; every further lane adds
//   loads and a shuffle round to each state-step.
// * ex2.approx.ftz: one MUFU.EX2 a decay.  exp2f adds a range test and
//   two scalings a call to keep subnormal results; here a decay below
//   2^-126 is 0, which changes h by less than 2^-126 |h|.
// * y.  A lane sums its states' C h in one chain of FMAs (two at 16
//   states a lane), then the L lanes reduce-scatter L consecutive steps'
//   partial sums with __shfl_xor_sync (log2 L rounds, L - 1 shuffles for
//   L steps): lane l ends with step l's sum, adds D x and stores it, so
//   every lane stores and none idles.  The store's address moves by a
//   running pointer, one add a group of L steps.
// * Staging.  Tiles of 16 steps of dt and x (the block's 128 / L
//   channels) and of B and C (the row's 16 N values, read by each lane as
//   a broadcast of its slice) go through a three-stage ring in dynamic
//   shared memory by 16-byte cp.async.cg, two tiles in flight while one
//   is scanned, one __syncthreads a tile; a tile's 16 steps are unrolled
//   whole, so every shared-memory read has a constant offset.  When a row
//   of dt is not 16-byte aligned (DI not a multiple of 4, or an offset
//   pointer) every copy takes 4 bytes instead.  Steps past S are staged
//   as zeros: there the decay is exp2(0) = 1 and the input 0, so h stays
//   as it is and every tile runs whole; their y is not stored.
// * Checkpoints.  When autograd records (models/ssm.py's _KernelScan),
//   ssm_scan_ckpt_kernel, the same scan, also writes the state at the
//   start of every 16-step tile, h before step 16 j, into ckpt (B, ceil(S
//   / 16), DI, N): 1/16 of all the states, from which
//   csrc/ssm_scan_bwd.cu recomputes a tile's states and walks them in
//   reverse (the state cannot be recovered from the next one: exp(dt A)
//   underflows).  Serving passes no buffer and runs ssm_scan_kernel,
//   which has no checkpoint code.
// Sums run in another order than the reference's associative tree:
// float32 rounding apart.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SCAN_THREADS = 128;   // a block: channels x lanes
constexpr int SCAN_STEPS = 16;      // time steps a staged tile
constexpr int SCAN_STAGES = 3;      // tiles in the ring
constexpr float LOG2E = 1.4426950408889634f;

// The launch at L lanes a channel and N states.  Offsets of a ring
// stage are in floats: dt[16][CH], x[16][CH], b[16][N], c[16][N].
template <int L, int N_>
struct Shape {
  static constexpr int N = N_;
  static constexpr int CH = SCAN_THREADS / L;          // channels a block
  static constexpr int SL = N / L;                     // states a lane
  static constexpr int ACC = SL >= 16 ? 2 : 1;         // y chains a lane
  static constexpr int LOG2L = L == 8 ? 3 : L == 4 ? 2 : L == 2 ? 1 : 0;
  static constexpr int DT = 0;
  static constexpr int X = SCAN_STEPS * CH;
  static constexpr int B = 2 * SCAN_STEPS * CH;
  static constexpr int C = B + SCAN_STEPS * N;
  static constexpr int STAGE = C + SCAN_STEPS * N;
  static constexpr int SMEM = SCAN_STAGES * STAGE * 4;  // bytes
  static_assert(SL >= 2 && SL % 2 == 0, "a lane holds 2 states or more");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, bypassing L1; zero-filled when
// `valid` is false (the source is then never read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// One float, likewise.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(K) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Steps t0 .. t0 + 15 of row `b` into ring stage `s`: the block's CH
// channels of dt and x from channel ch0, and the row's B and C, spread
// over the block; steps past S and channels past DI are zeros.
template <class Sh>
__device__ __forceinline__ void stage(float* s, const float* dt,
                                      const float* x, const float* bm,
                                      const float* cm, int b, int t0, int S,
                                      int DI, int ch0, bool vec) {
  constexpr int CH = Sh::CH, N = Sh::N;
  const long long row0 = (long long)b * S + t0;
  if (vec) {
    constexpr int Q = CH / 4;                      // 16-byte chunks a row
    constexpr int ROWS = SCAN_STEPS * Q, BC = SCAN_STEPS * N / 4;
#pragma unroll
    for (int k = 0; k < (ROWS + SCAN_THREADS - 1) / SCAN_THREADS; ++k) {
      const int q = threadIdx.x + k * SCAN_THREADS;
      if (ROWS % SCAN_THREADS == 0 || q < ROWS) {
        const int r = q / Q, c = (q % Q) * 4;
        const bool in = t0 + r < S && ch0 + c < DI;
        const long long off = in ? (row0 + r) * DI + ch0 + c : 0;
        cp_async16(s + Sh::DT + r * CH + c, dt + off, in);
        cp_async16(s + Sh::X + r * CH + c, x + off, in);
      }
    }
    if (threadIdx.x < BC) {
      const int q = threadIdx.x;
      const bool in = t0 + q * 4 / N < S;
      const long long off = in ? row0 * N + q * 4 : 0;
      cp_async16(s + Sh::B + q * 4, bm + off, in);
      cp_async16(s + Sh::C + q * 4, cm + off, in);
    }
  } else {
    for (int e = threadIdx.x; e < SCAN_STEPS * CH; e += SCAN_THREADS) {
      const int r = e / CH, c = e % CH;
      const bool in = t0 + r < S && ch0 + c < DI;
      const long long off = in ? (row0 + r) * DI + ch0 + c : 0;
      cp_async4(s + Sh::DT + e, dt + off, in);
      cp_async4(s + Sh::X + e, x + off, in);
    }
    for (int e = threadIdx.x; e < SCAN_STEPS * N; e += SCAN_THREADS) {
      const bool in = t0 + e / N < S;
      const long long off = in ? row0 * N + e : 0;
      cp_async4(s + Sh::B + e, bm + off, in);
      cp_async4(s + Sh::C + e, cm + off, in);
    }
  }
  cp_async_commit();
}

// SL floats of shared memory into registers, 16 or 8 bytes a load.
template <int SL>
__device__ __forceinline__ void load_slice(float (&v)[SL], const float* p) {
  if constexpr (SL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < SL; i += 4) {
      const float4 w = *reinterpret_cast<const float4*>(p + i);
      v[i] = w.x; v[i + 1] = w.y; v[i + 2] = w.z; v[i + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < SL; i += 2) {
      const float2 w = *reinterpret_cast<const float2*>(p + i);
      v[i] = w.x; v[i + 1] = w.y;
    }
  }
}

// The L lanes of a channel hold partial sums p[k] of steps k = 0 .. L-1;
// returns, in lane l, the sum over the lanes of step l (a butterfly: in
// each round a lane keeps the half of its steps that holds its own and
// sends the other half to its partner).
template <int L, int LOG2L>
__device__ __forceinline__ float reduce_scatter(float (&p)[L], int lane) {
#pragma unroll
  for (int round = 0; round < LOG2L; ++round) {
    const int half = L >> (round + 1);
    const bool upper = lane & half;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float send = upper ? p[k] : p[k + half];
      const float keep = upper ? p[k + half] : p[k];
      p[k] = keep + __shfl_xor_sync(0xffffffffu, send, half);
    }
  }
  return p[0];
}

template <int L, int N, bool CKPT>
__device__ __forceinline__ void scan(
    const float* __restrict__ dt, const float* __restrict__ x,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, const float* __restrict__ dskip,
    const float* __restrict__ h0, float* __restrict__ y,
    float* __restrict__ h_out, float* __restrict__ ckpt, int S, int DI,
    int vec) {
  using Sh = Shape<L, N>;
  constexpr int CH = Sh::CH, SL = Sh::SL, ACC = Sh::ACC;
  extern __shared__ __align__(16) float ring[];
  const int b = blockIdx.y;
  const int ch0 = blockIdx.x * CH;
  const int cl = threadIdx.x / L;          // channel in the block
  const int lane = threadIdx.x % L;        // lane in the channel
  const int ch = ch0 + cl;
  const bool live = ch < DI;
  const long long state0 = ((long long)b * DI + ch) * N + lane * SL;

  float a2[SL], h[SL];
#pragma unroll
  for (int i = 0; i < SL; ++i) {
    a2[i] = live ? a[(long long)ch * N + lane * SL + i] * LOG2E : 0.f;
    h[i] = live ? h0[state0 + i] : 0.f;
  }
  const float dsk = live ? dskip[ch] : 0.f;
  // This lane's output in each group of L steps: step `lane` of the
  // group; `left` steps of its own remain.
  float* yp = y + ((long long)b * S + lane) * DI + ch;
  const long long y_group = (long long)L * DI;
  int left = live ? S - lane : 0;

  const int n_tiles = (S + SCAN_STEPS - 1) / SCAN_STEPS;
  // SCAN_STAGES - 1 tiles in flight before the first is scanned; an
  // empty group stands for a tile past the end, so the wait below counts
  // alike.
  for (int j = 0; j < SCAN_STAGES - 1; ++j) {
    if (j < n_tiles)
      stage<Sh>(ring + j * Sh::STAGE, dt, x, bm, cm, b, j * SCAN_STEPS, S,
                DI, ch0, vec);
    else
      cp_async_commit();
  }
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<SCAN_STAGES - 2>();   // tile j has landed
    __syncthreads();               // ... for every thread; tile j - 1 read
    const int next = j + SCAN_STAGES - 1;
    if (next < n_tiles)
      stage<Sh>(ring + next % SCAN_STAGES * Sh::STAGE, dt, x, bm, cm, b,
                next * SCAN_STEPS, S, DI, ch0, vec);
    else
      cp_async_commit();
    const float* s = ring + j % SCAN_STAGES * Sh::STAGE;
    if (CKPT && live) {
      float* cp = ckpt + (((long long)b * n_tiles + j) * DI + ch) * N
                  + lane * SL;
#pragma unroll
      for (int i = 0; i < SL; ++i) cp[i] = h[i];
    }
#pragma unroll
    for (int g = 0; g < SCAN_STEPS; g += L) {
      float p[L];
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const int r = g + k;
        const float dtv = s[Sh::DT + r * CH + cl];
        const float u = dtv * s[Sh::X + r * CH + cl];
        float bv[SL], cv[SL];
        load_slice<SL>(bv, s + Sh::B + r * N + lane * SL);
        load_slice<SL>(cv, s + Sh::C + r * N + lane * SL);
        float acc[ACC];
#pragma unroll
        for (int q = 0; q < ACC; ++q) acc[q] = 0.f;
#pragma unroll
        for (int i = 0; i < SL; ++i) {
          h[i] = fmaf(ex2(dtv * a2[i]), h[i], u * bv[i]);
          acc[i % ACC] = fmaf(h[i], cv[i], acc[i % ACC]);
        }
        p[k] = ACC == 2 ? acc[0] + acc[ACC - 1] : acc[0];
      }
      const float sum = reduce_scatter<L, Sh::LOG2L>(p, lane);
      const float out = fmaf(s[Sh::X + (g + lane) * CH + cl], dsk, sum);
      if (left > 0) __stcs(yp, out);
      yp += y_group;
      left -= L;
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < SL; ++i) h_out[state0 + i] = h[i];
  }
}

template <int L, int N>
__global__ void __launch_bounds__(SCAN_THREADS, 4)
ssm_scan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a, const float* __restrict__ dskip,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_out, int S, int DI, int vec) {
  scan<L, N, false>(dt, x, bm, cm, a, dskip, h0, y, h_out, nullptr, S, DI,
                    vec);
}

template <int L, int N>
__global__ void __launch_bounds__(SCAN_THREADS, 4)
ssm_scan_ckpt_kernel(const float* __restrict__ dt,
                     const float* __restrict__ x,
                     const float* __restrict__ bm,
                     const float* __restrict__ cm,
                     const float* __restrict__ a,
                     const float* __restrict__ dskip,
                     const float* __restrict__ h0, float* __restrict__ y,
                     float* __restrict__ h_out, float* __restrict__ ckpt,
                     int S, int DI, int vec) {
  scan<L, N, true>(dt, x, bm, cm, a, dskip, h0, y, h_out, ckpt, S, DI, vec);
}

template <int L, int N>
int launch(const float* dt, const float* x, const float* bm, const float* cm,
           const float* a, const float* dskip, const float* h0, float* y,
           float* h_out, float* ckpt, int B, int S, int DI, bool vec,
           cudaStream_t stream) {
  using Sh = Shape<L, N>;
  if (Sh::SMEM > 48 * 1024) {
    const cudaError_t err =
        ckpt ? cudaFuncSetAttribute(
                   ssm_scan_ckpt_kernel<L, N>,
                   cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM)
             : cudaFuncSetAttribute(
                   ssm_scan_kernel<L, N>,
                   cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((DI + Sh::CH - 1) / Sh::CH, B);
  if (ckpt)
    ssm_scan_ckpt_kernel<L, N><<<grid, SCAN_THREADS, Sh::SMEM, stream>>>(
        dt, x, bm, cm, a, dskip, h0, y, h_out, ckpt, S, DI, vec ? 1 : 0);
  else
    ssm_scan_kernel<L, N><<<grid, SCAN_THREADS, Sh::SMEM, stream>>>(
        dt, x, bm, cm, a, dskip, h0, y, h_out, S, DI, vec ? 1 : 0);
  return (int)cudaGetLastError();
}

// The lane counts instantiated at N states (2 states a lane or more):
// the launch, or cudaErrorInvalidValue for another count.
template <int N>
int dispatch(int lanes, const float* dt, const float* x, const float* bm,
             const float* cm, const float* a, const float* dskip,
             const float* h0, float* y, float* h_out, float* ckpt, int B,
             int S, int DI, bool vec, cudaStream_t stream) {
  const bool empty = B == 0 || DI == 0;
  switch (lanes) {
    case 1:
      return empty ? 0 : launch<1, N>(dt, x, bm, cm, a, dskip, h0, y, h_out,
                                      ckpt, B, S, DI, vec, stream);
    case 2:
      return empty ? 0 : launch<2, N>(dt, x, bm, cm, a, dskip, h0, y, h_out,
                                      ckpt, B, S, DI, vec, stream);
    case 4:
      return empty ? 0 : launch<4, N>(dt, x, bm, cm, a, dskip, h0, y, h_out,
                                      ckpt, B, S, DI, vec, stream);
    case 8:
      if constexpr (N / 8 >= 2)
        return empty ? 0 : launch<8, N>(dt, x, bm, cm, a, dskip, h0, y,
                                        h_out, ckpt, B, S, DI, vec, stream);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of a launch at `lanes` and N states; 0 for a
// lane count with no instantiation.
template <int N>
int smem_bytes(int lanes) {
  switch (lanes) {
    case 1: return Shape<1, N>::SMEM;
    case 2: return Shape<2, N>::SMEM;
    case 4: return Shape<4, N>::SMEM;
    case 8:
      if constexpr (N / 8 >= 2) return Shape<8, N>::SMEM;
      return 0;
    default: return 0;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// The scan over B batch rows of S steps and DI channels with N states (8
// or 16) at `lanes` lanes a channel (1, 2, 4 or 8, at least 2 states a
// lane); another N or lane count -> cudaErrorInvalidValue.  ckpt: null, or
// a (B, ceil(S / 16), DI, N) float32 buffer for the state at the start of
// every 16-step tile.
extern "C" int ssm_scan_f32(const float* dt, const float* x, const float* bm,
                            const float* cm, const float* a,
                            const float* dskip, const float* h0, float* y,
                            float* h_out, float* ckpt, int B, int S, int DI,
                            int N, int lanes, cudaStream_t stream) {
  if (B < 0 || S < 0 || DI < 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies need every row of dt and x, and of B and C (N is a
  // multiple of 4), to start on a 16-byte boundary.
  const bool vec = DI % 4 == 0 && aligned16(dt) && aligned16(x) &&
                   aligned16(bm) && aligned16(cm);
  if (N == 8)
    return dispatch<8>(lanes, dt, x, bm, cm, a, dskip, h0, y, h_out, ckpt, B,
                       S, DI, vec, stream);
  if (N == 16)
    return dispatch<16>(lanes, dt, x, bm, cm, a, dskip, h0, y, h_out, ckpt,
                        B, S, DI, vec, stream);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a launch at `lanes` and N states, in bytes; 0
// where that pair has no instantiation.
extern "C" int ssm_scan_smem(int lanes, int N) {
  if (N == 8) return smem_bytes<8>(lanes);
  if (N == 16) return smem_bytes<16>(lanes);
  return 0;
}

extern "C" const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
