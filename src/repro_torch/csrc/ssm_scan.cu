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
// So the two bounds nearly meet; the MUFU's is the larger.
//
// Design.  One thread owns a (b, channel) and its N states, with A's row
// pre-scaled by log2(e) (decay = exp2(dt A log2 e)); a block takes 128
// channels of one batch row, so that the loads of a time step are
// coalesced 512-byte rows.  Tiles of 16 time steps of dt and x (the
// block's channels) and of B and C (the row's N values, read by every
// thread as broadcasts) are staged in shared memory with cp.async, two
// buffers deep, the next tile in flight while the current one is
// scanned.  y_t is written as it is made; the final state once at the
// end.  The N exponentials of a step are independent of the states, so
// the MUFU and the FMA chains overlap.  Sums run in another order than
// the reference's associative tree: float32 rounding apart.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SCAN_THREADS = 128;   // channels a block
constexpr int SCAN_STEPS = 16;      // time steps a staged tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One float from global to shared memory, zero-filled when `valid` is
// false (the source is then never read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <int N>
struct Tile {
  float dt[SCAN_STEPS][SCAN_THREADS];
  float x[SCAN_STEPS][SCAN_THREADS];
  __align__(16) float b[SCAN_STEPS][N];
  __align__(16) float c[SCAN_STEPS][N];
};

// Steps t0 .. t0 + SCAN_STEPS - 1 of row `b` into `tile`: this thread's
// channel of dt and x, and (spread over the block) the row's B and C;
// steps past S and channels past DI are zeros.
template <int N>
__device__ __forceinline__ void stage(Tile<N>& tile, const float* dt,
                                      const float* x, const float* bm,
                                      const float* cm, int b, int t0, int S,
                                      int DI, int ch) {
  const bool live = ch < DI;
  for (int r = 0; r < SCAN_STEPS; ++r) {
    const bool in = live && t0 + r < S;
    const long long off = in ? ((long long)b * S + t0 + r) * DI + ch : 0;
    cp_async4(&tile.dt[r][threadIdx.x], dt + off, in);
    cp_async4(&tile.x[r][threadIdx.x], x + off, in);
  }
  for (int e = threadIdx.x; e < SCAN_STEPS * N; e += SCAN_THREADS) {
    const int r = e / N, i = e % N;
    const bool in = t0 + r < S;
    const long long off = in ? ((long long)b * S + t0 + r) * N + i : 0;
    cp_async4(&tile.b[r][i], bm + off, in);
    cp_async4(&tile.c[r][i], cm + off, in);
  }
  cp_async_commit();
}

template <int N>
__global__ void __launch_bounds__(SCAN_THREADS)
ssm_scan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a, const float* __restrict__ dskip,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_out, int S, int DI) {
  __shared__ Tile<N> tiles[2];
  const int b = blockIdx.y;
  const int ch = blockIdx.x * SCAN_THREADS + threadIdx.x;
  const bool live = ch < DI;
  const long long state0 = ((long long)b * DI + ch) * N;

  float a2[N], h[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a2[i] = live ? a[(long long)ch * N + i] * LOG2E : 0.f;
    h[i] = live ? h0[state0 + i] : 0.f;
  }
  const float dsk = live ? dskip[ch] : 0.f;

  const int n_tiles = (S + SCAN_STEPS - 1) / SCAN_STEPS;
  if (n_tiles > 0) stage<N>(tiles[0], dt, x, bm, cm, b, 0, S, DI, ch);
  for (int j = 0; j < n_tiles; ++j) {
    Tile<N>& tile = tiles[j & 1];
    if (j + 1 < n_tiles) {
      stage<N>(tiles[(j + 1) & 1], dt, x, bm, cm, b, (j + 1) * SCAN_STEPS,
               S, DI, ch);
      cp_async_wait<1>();         // tile j has landed, j + 1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = j * SCAN_STEPS;
    const int steps = min(SCAN_STEPS, S - t0);
#pragma unroll 2
    for (int r = 0; r < steps; ++r) {
      const float dtv = tile.dt[r][threadIdx.x];
      const float xv = tile.x[r][threadIdx.x];
      const float u = dtv * xv;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 bv = *reinterpret_cast<const float4*>(&tile.b[r][i]);
        const float4 cv = *reinterpret_cast<const float4*>(&tile.c[r][i]);
        h[i] = fmaf(exp2f(dtv * a2[i]), h[i], u * bv.x);
        h[i + 1] = fmaf(exp2f(dtv * a2[i + 1]), h[i + 1], u * bv.y);
        h[i + 2] = fmaf(exp2f(dtv * a2[i + 2]), h[i + 2], u * bv.z);
        h[i + 3] = fmaf(exp2f(dtv * a2[i + 3]), h[i + 3], u * bv.w);
        acc = fmaf(h[i], cv.x, acc);
        acc = fmaf(h[i + 1], cv.y, acc);
        acc = fmaf(h[i + 2], cv.z, acc);
        acc = fmaf(h[i + 3], cv.w, acc);
      }
      if (live) y[((long long)b * S + t0 + r) * DI + ch] = fmaf(xv, dsk, acc);
    }
    __syncthreads();              // tile j is read before it is refilled
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < N; ++i) h_out[state0 + i] = h[i];
  }
}

template <int N>
int launch(const float* dt, const float* x, const float* bm, const float* cm,
           const float* a, const float* dskip, const float* h0, float* y,
           float* h_out, int B, int S, int DI, cudaStream_t stream) {
  const dim3 grid((DI + SCAN_THREADS - 1) / SCAN_THREADS, B);
  ssm_scan_kernel<N><<<grid, SCAN_THREADS, 0, stream>>>(
      dt, x, bm, cm, a, dskip, h0, y, h_out, S, DI);
  return (int)cudaGetLastError();
}

}  // namespace

// The scan over B batch rows of S steps and DI channels with N states
// (8 or 16; another N -> cudaErrorInvalidValue).
extern "C" int ssm_scan_f32(const float* dt, const float* x, const float* bm,
                            const float* cm, const float* a,
                            const float* dskip, const float* h0, float* y,
                            float* h_out, int B, int S, int DI, int N,
                            cudaStream_t stream) {
  if (B < 0 || S < 0 || DI < 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || DI == 0) return 0;
  switch (N) {
    case 8:
      return launch<8>(dt, x, bm, cm, a, dskip, h0, y, h_out, B, S, DI,
                       stream);
    case 16:
      return launch<16>(dt, x, bm, cm, a, dskip, h0, y, h_out, B, S, DI,
                        stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
