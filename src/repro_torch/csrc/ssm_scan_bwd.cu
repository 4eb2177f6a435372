// Gradient of the selective scan (csrc/ssm_scan.cu): for every batch row b
// and channel d, over t = 0 .. S - 1,
//
//   h_t = exp(dt_t A) h_{t-1} + u_t B_t,   u_t = dt_t x_t   (n states)
//   y_t = C_t . h_t + D x_t
//
// given dy (B, S, DI) and the final state's gradient dh_T (B, DI, N; absent
// means zero: training never reads the final state), this writes d(dt),
// dx (B, S, DI), dB, dC (B, S, N), dA (DI, N), dD (DI,) and dh0 (B, DI, N),
// all float32, from the reverse recurrence
//
//   g_t     = C_t dy_t + exp(dt_{t+1} A) g_{t+1}     (g_{S-1} adds dh_T)
//   dh0     = exp(dt_0 A) g_0
//   du_t    = g_t . B_t;    dx_t = du_t dt_t + D dy_t
//   d(dt)_t = du_t x_t + sum_n g_t A exp(dt_t A) h_{t-1}
//   dB_t    = sum_d u_t g_t;   dC_t = sum_d dy_t h_t
//   dA      = sum_{b,t} dt_t exp(dt_t A) g_t h_{t-1};   dD = sum_{b,t} dy x
//
// Replaces no Pallas kernel: the reference differentiates its jnp chunked
// associative scan (src/repro/models/ssm.py:69 ssm_scan) with JAX's
// autodiff.  On the card the port's forward is the hand-written scan, so
// its gradient is one too.
//
// Bound, at Falcon-Mamba-7B's training micro-batch (B 1, S 2048, DI 8192,
// N 16): dt, x and dy read once and dx, d(dt) written once, 5 x 67 MB; B,
// C, dB, dC, A, dA, the checkpoints and dh0 ~9 MB: 0.10 ms at 3.35 TB/s.
// The decays are recomputed twice (the tile's states forward, then each
// step in reverse): 2 B S DI N = 5.4e8 MUFU.EX2, 16 a clock on each of the
// 132 SMs, 0.13 ms at 1.98 GHz (kernels/ssm_scan_bwd.py bound, timing.py).
//
// Design.
// * States in reverse.  h_{t-1} cannot be recovered from h_t (exp(dt A)
//   underflows), so the forward writes the state at the start of every
//   16-step tile (ckpt, (B, ceil(S / 16), DI, N)) when autograd records.
//   A block walks its tiles last to first: it stages the tile's dt, x, dy
//   (its channels) and B, C (the row's) in shared memory, recomputes the
//   tile's 16 states from the checkpoint into a per-thread history in
//   shared memory (17 x N / L floats a thread, conflict-free: slot s of
//   thread i at s * 128 + i), then walks the 16 steps backwards.  A
//   segment of 16 steps fits shared memory at every lane count: 17 x 16
//   x 128 floats = 139 KB at one lane and 16 states, 35 KB at the plan's 4
//   lanes for Falcon-Mamba-7B, 8.7 KB at Hymba-1.5B's 8.
// * Lanes.  As the forward: L = 1, 2, 4 or 8 neighbouring threads share a
//   (b, channel), lane l holding states [l N/L, (l + 1) N/L) and their g.
//   du and the decay's share of d(dt) sum over a channel's lanes by
//   shuffles; lane 0 stores dx and d(dt).
// * Sums across threads, no atomics, so two runs give the same bits.  dB
//   and dC sum over channels: in a warp by shuffles over its 32 / L
//   channels, then the block's four warps in order through shared memory,
//   into a partial (gridDim.x, B, S, N) per block of channels; dA and dD
//   sum over batch rows into partials (B, DI, N) and (B, DI).  A second
//   launch (scan_bwd_sum) adds the partials in index order.
// Sums run in another order than autograd's through the plain chunked
// scan: float32 rounding apart.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;          // a block: channels x lanes
constexpr int STEPS = 16;             // a tile: the forward's checkpoints
constexpr int WARPS = THREADS / 32;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory at L lanes and N states, in floats: dt, x, dy [16][CH];
// B, C [16][N]; the history [17 N / L][128]; the warps' dB and dC sums
// [WARPS][2][16][N].
template <int L, int N_>
struct Shape {
  static constexpr int N = N_;
  static constexpr int CH = THREADS / L;               // channels a block
  static constexpr int SL = N / L;                     // states a lane
  static constexpr int DT = 0;
  static constexpr int X = STEPS * CH;
  static constexpr int DY = 2 * STEPS * CH;
  static constexpr int B = 3 * STEPS * CH;
  static constexpr int C = B + STEPS * N;
  static constexpr int HIST = C + STEPS * N;
  static constexpr int RED = HIST + (STEPS + 1) * SL * THREADS;
  static constexpr int SMEM = (RED + WARPS * 2 * STEPS * N) * 4;  // bytes
  static_assert(SL >= 2, "a lane holds 2 states or more");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int L, int N>
__global__ void __launch_bounds__(THREADS)
ssm_scan_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                    const float* __restrict__ bm, const float* __restrict__ cm,
                    const float* __restrict__ a,
                    const float* __restrict__ dskip,
                    const float* __restrict__ ckpt,
                    const float* __restrict__ dy,
                    const float* __restrict__ dh_last,
                    float* __restrict__ ddt, float* __restrict__ dx,
                    float* __restrict__ db_part, float* __restrict__ dc_part,
                    float* __restrict__ da_part, float* __restrict__ dd_part,
                    float* __restrict__ dh0, int S, int DI) {
  using Sh = Shape<L, N>;
  constexpr int CH = Sh::CH, SL = Sh::SL;
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.y, bx = blockIdx.x, nb = gridDim.y;
  const int ch0 = bx * CH;
  const int tid = threadIdx.x, warp = tid / 32, wl = tid % 32;
  const int cl = tid / L;                  // channel in the block
  const int lane = tid % L;                // lane in the channel
  const int ch = ch0 + cl;
  const bool live = ch < DI;
  const long long state0 = ((long long)b * DI + ch) * N + lane * SL;
  const int n_tiles = (S + STEPS - 1) / STEPS;

  float a2[SL], av[SL], carry[SL], da[SL];
#pragma unroll
  for (int i = 0; i < SL; ++i) {
    av[i] = live ? a[(long long)ch * N + lane * SL + i] : 0.f;
    a2[i] = av[i] * LOG2E;
    carry[i] = live && dh_last != nullptr ? dh_last[state0 + i] : 0.f;
    da[i] = 0.f;
  }
  const float dsk = live ? dskip[ch] : 0.f;
  float dd = 0.f;
  float* hist = sm + Sh::HIST + tid;       // slot s at hist[s * THREADS]
  float* red = sm + Sh::RED;               // [warp][dB, dC][step][n]

#pragma unroll 1
  for (int j = n_tiles - 1; j >= 0; --j) {
    const int t0 = j * STEPS;
    __syncthreads();                       // the last tile's sums are read
    for (int e = tid; e < STEPS * CH; e += THREADS) {
      const int r = e / CH, c = e % CH;
      const bool in = t0 + r < S && ch0 + c < DI;
      const long long off = in ? ((long long)b * S + t0 + r) * DI + ch0 + c
                               : 0;
      sm[Sh::DT + e] = in ? dt[off] : 0.f;
      sm[Sh::X + e] = in ? x[off] : 0.f;
      sm[Sh::DY + e] = in ? dy[off] : 0.f;
    }
    for (int e = tid; e < STEPS * N; e += THREADS) {
      const bool in = t0 + e / N < S;
      const long long off = in ? ((long long)b * S + t0) * N + e : 0;
      sm[Sh::B + e] = in ? bm[off] : 0.f;
      sm[Sh::C + e] = in ? cm[off] : 0.f;
    }
    __syncthreads();
    // The tile's states from its checkpoint, as the forward ran them
    // (steps past S have dt = 0 and u = 0: h stays).  Slot k holds h
    // before step t0 + k, slot 16 after the tile.
    float h[SL];
#pragma unroll
    for (int i = 0; i < SL; ++i) {
      h[i] = live ? ckpt[(((long long)b * n_tiles + j) * DI + ch) * N
                         + lane * SL + i] : 0.f;
      hist[i * THREADS] = h[i];
    }
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
      const float dtv = sm[Sh::DT + k * CH + cl];
      const float u = dtv * sm[Sh::X + k * CH + cl];
      const float* bk = sm + Sh::B + k * N + lane * SL;
#pragma unroll
      for (int i = 0; i < SL; ++i) {
        h[i] = fmaf(ex2(dtv * a2[i]), h[i], u * bk[i]);
        hist[((k + 1) * SL + i) * THREADS] = h[i];
      }
    }
    // Backwards over the tile.
#pragma unroll
    for (int k = STEPS - 1; k >= 0; --k) {
      const float dtv = sm[Sh::DT + k * CH + cl];
      const float xv = sm[Sh::X + k * CH + cl];
      const float dyv = sm[Sh::DY + k * CH + cl];
      const float u = dtv * xv;
      const float* bk = sm + Sh::B + k * N + lane * SL;
      const float* ck = sm + Sh::C + k * N + lane * SL;
      float du = 0.f, ddec = 0.f, gb[SL], hc[SL];
#pragma unroll
      for (int i = 0; i < SL; ++i) {
        const float g = fmaf(ck[i], dyv, carry[i]);
        const float dec = ex2(dtv * a2[i]);
        const float gdh = g * dec * hist[(k * SL + i) * THREADS];
        gb[i] = g * u;
        hc[i] = hist[((k + 1) * SL + i) * THREADS] * dyv;
        du = fmaf(g, bk[i], du);
        ddec = fmaf(gdh, av[i], ddec);
        da[i] = fmaf(gdh, dtv, da[i]);
        carry[i] = g * dec;
      }
#pragma unroll
      for (int off = 1; off < L; off *= 2) {
        du += __shfl_xor_sync(0xffffffffu, du, off);
        ddec += __shfl_xor_sync(0xffffffffu, ddec, off);
      }
      const int t = t0 + k;
      if (lane == 0 && live && t < S) {
        const long long o = ((long long)b * S + t) * DI + ch;
        dx[o] = fmaf(du, dtv, dsk * dyv);
        ddt[o] = fmaf(du, xv, ddec);
      }
      dd = fmaf(xv, dyv, dd);
      // dB and dC over the warp's channels (lanes of one index alike).
#pragma unroll
      for (int off = L; off < 32; off *= 2)
#pragma unroll
        for (int i = 0; i < SL; ++i) {
          gb[i] += __shfl_xor_sync(0xffffffffu, gb[i], off);
          hc[i] += __shfl_xor_sync(0xffffffffu, hc[i], off);
        }
      if (wl < L) {
#pragma unroll
        for (int i = 0; i < SL; ++i) {
          red[((warp * 2) * STEPS + k) * N + lane * SL + i] = gb[i];
          red[((warp * 2 + 1) * STEPS + k) * N + lane * SL + i] = hc[i];
        }
      }
    }
    __syncthreads();
    // The block's dB and dC of the tile: its warps' sums in order.
    for (int e = tid; e < 2 * STEPS * N; e += THREADS) {
      const int q = e / (STEPS * N), r = e % (STEPS * N);
      const int k = r / N;
      if (t0 + k < S) {
        float sum = red[q * STEPS * N + r];
#pragma unroll
        for (int w = 1; w < WARPS; ++w)
          sum += red[(w * 2 + q) * STEPS * N + r];
        float* part = q ? dc_part : db_part;
        part[(((long long)bx * nb + b) * S + t0) * N + r] = sum;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < SL; ++i) {
      dh0[state0 + i] = carry[i];
      da_part[state0 + i] = da[i];
    }
    if (lane == 0) dd_part[(long long)b * DI + ch] = dd;
  }
}

// out_q[e] = sum over p < parts_q of part_q[p n_q + e], in order of p, for
// the four sums q (blockIdx.y): dB and dC over the blocks of channels, dA
// and dD over the batch rows.
struct Sums {
  const float* part[4];
  float* out[4];
  long long n[4];
  int parts[4];
};

__global__ void __launch_bounds__(256)
scan_bwd_sum(const __grid_constant__ Sums s) {
  const int q = blockIdx.y;
  const long long n = s.n[q];
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int p = 0; p < s.parts[q]; ++p) sum += s.part[q][p * n + e];
    s.out[q][e] = sum;
  }
}

template <int L, int N>
int launch(const float* dt, const float* x, const float* bm, const float* cm,
           const float* a, const float* dskip, const float* ckpt,
           const float* dy, const float* dh_last, float* ddt, float* dx,
           float* db_part, float* dc_part, float* da_part, float* dd_part,
           float* dh0, int B, int S, int DI, cudaStream_t stream) {
  using Sh = Shape<L, N>;
  if (Sh::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssm_scan_bwd_kernel<L, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((DI + Sh::CH - 1) / Sh::CH, B);
  ssm_scan_bwd_kernel<L, N><<<grid, THREADS, Sh::SMEM, stream>>>(
      dt, x, bm, cm, a, dskip, ckpt, dy, dh_last, ddt, dx, db_part, dc_part,
      da_part, dd_part, dh0, S, DI);
  return (int)cudaGetLastError();
}

template <int N>
int dispatch(int lanes, const float* dt, const float* x, const float* bm,
             const float* cm, const float* a, const float* dskip,
             const float* ckpt, const float* dy, const float* dh_last,
             float* ddt, float* dx, float* db_part, float* dc_part,
             float* da_part, float* dd_part, float* dh0, int B, int S,
             int DI, cudaStream_t stream) {
#define SCAN_BWD_LAUNCH(L_)                                                 \
  launch<L_, N>(dt, x, bm, cm, a, dskip, ckpt, dy, dh_last, ddt, dx,        \
                db_part, dc_part, da_part, dd_part, dh0, B, S, DI, stream)
  switch (lanes) {
    case 1: return SCAN_BWD_LAUNCH(1);
    case 2: return SCAN_BWD_LAUNCH(2);
    case 4: return SCAN_BWD_LAUNCH(4);
    case 8:
      if constexpr (N / 8 >= 2) return SCAN_BWD_LAUNCH(8);
      return (int)cudaErrorInvalidValue;
  }
#undef SCAN_BWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <int N>
int smem_bytes(int lanes) {
  switch (lanes) {
    case 1: return Shape<1, N>::SMEM;
    case 2: return Shape<2, N>::SMEM;
    case 4: return Shape<4, N>::SMEM;
    case 8:
      if constexpr (N / 8 >= 2) return Shape<8, N>::SMEM;
      return 0;
  }
  return 0;
}

}  // namespace

// The scan's gradient over B batch rows of S steps and DI channels with N
// states (8 or 16) at `lanes` lanes a channel (1, 2, 4 or 8, at least 2
// states a lane; another -> cudaErrorInvalidValue).  ckpt: the forward's
// (B, ceil(S / 16), DI, N) states at the tiles' starts; dh_last: the final
// state's gradient (B, DI, N) or null for zeros.  Writes ddt, dx (B, S,
// DI), db, dc (B, S, N), da (DI, N), dd (DI), dh0 (B, DI, N); scratch:
// db_part and dc_part (ceil(DI / (128 / lanes)), B, S, N), da_part (B, DI,
// N), dd_part (B, DI).  Two launches: the walk, then the partials' sums.
extern "C" int ssm_scan_bwd_f32(
    const float* dt, const float* x, const float* bm, const float* cm,
    const float* a, const float* dskip, const float* ckpt, const float* dy,
    const float* dh_last, float* ddt, float* dx, float* db, float* dc,
    float* da, float* dd, float* dh0, float* db_part, float* dc_part,
    float* da_part, float* dd_part, int B, int S, int DI, int N, int lanes,
    cudaStream_t stream) {
  if (B <= 0 || S < 0 || DI <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  int rc;
  if (N == 8)
    rc = dispatch<8>(lanes, dt, x, bm, cm, a, dskip, ckpt, dy, dh_last, ddt,
                     dx, db_part, dc_part, da_part, dd_part, dh0, B, S, DI,
                     stream);
  else if (N == 16)
    rc = dispatch<16>(lanes, dt, x, bm, cm, a, dskip, ckpt, dy, dh_last,
                      ddt, dx, db_part, dc_part, da_part, dd_part, dh0, B, S,
                      DI, stream);
  else
    return (int)cudaErrorInvalidValue;
  if (rc) return rc;
  const int blocks_x = (DI + THREADS / lanes - 1) / (THREADS / lanes);
  const long long bsn = (long long)B * S * N;
  const Sums s{{db_part, dc_part, da_part, dd_part},
               {db, dc, da, dd},
               {bsn, bsn, (long long)DI * N, DI},
               {blocks_x, blocks_x, B, B}};
  long long most = bsn > (long long)DI * N ? bsn : (long long)DI * N;
  long long grid = (most + 255) / 256;
  if (grid > 1024) grid = 1024;
  if (grid < 1) grid = 1;
  scan_bwd_sum<<<dim3((unsigned)grid, 4), 256, 0, stream>>>(s);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the walk at `lanes` and N states, in bytes; 0
// where that pair has no instantiation.
extern "C" int ssm_scan_bwd_smem(int lanes, int N) {
  if (N == 8) return smem_bytes<8>(lanes);
  if (N == 16) return smem_bytes<16>(lanes);
  return 0;
}

extern "C" const char* ssm_scan_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
