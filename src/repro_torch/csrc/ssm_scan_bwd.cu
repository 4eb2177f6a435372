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
// The decays are B S DI N = 2.7e8 exponentials, one MUFU.EX2 each at 16 a
// clock on each of the 132 SMs: 0.064 ms at 1.98 GHz (timing.py's
// scan_bwd_work counts each decay once, as the forward's bound does).
// This kernel takes three for each: the chunks' pre-pass, the tile's
// states recomputed forward, then each step in reverse.
//
// Design.  Measured on an H100 before it (kernel_times.py --src a cut-down
// copy of a walk that took all 128 tiles of a (batch row, channel block)
// in series, 256 blocks of 4 warps at one batch row): twice the grid on
// halves of the sequence took 32-44 % off, no dB/dC shuffles 15-20 %, no
// tile loads 10-26 %.  So:
// * Chunks of the sequence.  The carry g_t exp(dt_t A) that leaves a step
//   for the one before is linear in the carry that enters it, so over a
//   chunk of steps [t0, t1)
//
//     carry_out(k) = local(k) + P(k) carry_in(k),   P(k) = prod exp(dt A)
//
//   state by state, local(k) being the outgoing carry from a zero incoming
//   one; carry_in of the last chunk is dh_T and carry_in(k) = carry_out(k
//   + 1).  The walk's grid is (channel blocks, chunks, B), chunks a
//   multiple of 16 steps (kernels/ssm_scan_bwd.py bwd_plan: about two
//   waves of blocks), after a pre-pass (scan_bwd_prepass) that runs g <-
//   C dy + exp(dt A) g over each chunk but the first from zero and writes
//   local and P (B, chunks, DI, N); it reads dt, dy and C, staged by
//   cp.async like the walk's tiles, not the states.  A walk block first
//   folds the later chunks' (local, P) into its incoming carry, last chunk
//   first: the same order in every block, so two runs give the same bits.
// * States in reverse.  h_{t-1} cannot be recovered from h_t (exp(dt A)
//   underflows), so the forward writes the state at the start of every
//   16-step tile (ckpt, (B, ceil(S / 16), DI, N)) when autograd records.
//   A block walks its chunk's tiles last to first, recomputes each tile's
//   16 states from its checkpoint by the forward's own instructions (bit
//   for bit the forward's states) into a per-thread history in registers
//   (16 steps x 4 states), then walks the 16 steps backwards.
// * Staging.  dt, x, dy (the block's channels) and B, C (the row's) of
//   the tile before go into the other half of a two-stage buffer by
//   16-byte cp.async (4-byte copies when rows are not 16-byte aligned)
//   while a tile is walked, and the next tile's checkpoint is loaded into
//   registers likewise; the pre-pass stages dt, dy and C by the same rule
//   (stage<Tile>).
// * Lanes.  L = N / 4 neighbouring threads share a (b, channel), lane l
//   holding states [4 l, 4 l + 4) and their g: the fewest lanes whose
//   history fits registers (4 at N = 16, 2 at N = 8; more lanes at N = 16
//   were slower on the H100: 8 lanes 0.2584 against 0.2298 ms at
//   Hymba-1.5B's micro-batch).  du and the decay's share of d(dt) are
//   reduce-scattered over the lanes for L steps at once (L - 1 shuffles
//   each for L steps), so lane l stores step l of each group of L.
// * dB and dC sum over channels.  A step's 2 N/L values of a thread (its
//   states' u g and h dy) are reduce-scattered over the warp's 32/L
//   channels by recursive halving: 2 N/L - 1 = 7 shuffles a step (an
//   all-reduce at 4 lanes takes 24), each thread ending with one sum (the
//   16 channels a warp at N = 8 take one more round).  The warps' sums go
//   to shared memory and, after the tile's second barrier, the block adds
//   them in warp order into a partial (gridDim.x, B, S, N) per block of
//   channels (each step lies in one chunk); dA and dD go into partials
//   (chunks, B, DI, N) and (chunks, B, DI).  A last launch (scan_bwd_sum) adds the
//   partials in index order: no atomics, two runs give the same bits.
// Sums run in another order than autograd's through the plain chunked
// scan: float32 rounding apart.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;          // a block: channels x lanes
constexpr int STEPS = 16;             // a tile: the forward's checkpoints
constexpr int WARPS = THREADS / 32;
constexpr int LANE_STATES = 4;        // states a walk lane: N / 4 lanes
constexpr int PRE_STATES = 8;         // states a pre-pass thread
constexpr float LOG2E = 1.4426950408889634f;

// One stage of a tile in shared memory, in floats: dt, dy and (XB) x
// [16][CH] of CH channels, then C and (XB) B [16][N] of the row.
template <int CH_, int N_, bool XB_>
struct Tile {
  static constexpr int CH = CH_, N = N_;
  static constexpr bool XB = XB_;
  static constexpr int DT = 0;
  static constexpr int DY = STEPS * CH;
  static constexpr int X = 2 * STEPS * CH;             // with XB
  static constexpr int C = (XB ? 3 : 2) * STEPS * CH;
  static constexpr int B = C + STEPS * N;              // with XB
  static constexpr int SIZE = C + (XB ? 2 : 1) * STEPS * N;
};

// The walk at N states, N / 4 lanes a channel, in floats of shared
// memory: two stages of a tile, then the warps' dB and dC sums
// [WARPS][2][16][N].
template <int N_>
struct Shape {
  static constexpr int N = N_;
  static constexpr int SL = LANE_STATES;               // states a lane
  static constexpr int L = N / SL;                     // lanes a channel
  static constexpr int CH = THREADS / L;               // channels a block
  static constexpr int LOG2L = L == 4 ? 2 : 1;
  static constexpr int M = 2 * SL;     // dB and dC values a thread a step
  static constexpr int P = 32 / L;     // channels a warp
  using Lay = Tile<CH, N, true>;
  static constexpr int RED = 2 * Lay::SIZE;
  static constexpr int SMEM = (RED + WARPS * 2 * STEPS * N) * 4;  // bytes
  static_assert(L == 2 || L == 4, "N is 8 or 16");
  static_assert(M <= P, "a thread's dB and dC values fit its warp");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes (or one float) from global to shared memory, zero-filled when
// `valid` is false (the source is then never read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Steps t0 .. t0 + 15 of row `b` into stage `s` of layout T: T::CH
// channels of dt, dy and (T::XB) x from channel ch0, and the row's C and
// (T::XB) B; steps past S and channels past DI are zeros.  16-byte copies
// where `vec`, else 4-byte ones.
template <class T>
__device__ __forceinline__ void stage(float* s, const float* dt,
                                      const float* x, const float* dy,
                                      const float* bm, const float* cm,
                                      int b, int t0, int S, int DI, int ch0,
                                      bool vec) {
  constexpr int CH = T::CH, N = T::N;
  const long long row0 = (long long)b * S + t0;
  if (vec) {
    constexpr int Q = CH / 4;                      // 16-byte chunks a row
    constexpr int ROWS = STEPS * Q, BC = STEPS * N / 4;
#pragma unroll
    for (int k = 0; k < (ROWS + THREADS - 1) / THREADS; ++k) {
      const int q = threadIdx.x + k * THREADS;
      if (ROWS % THREADS == 0 || q < ROWS) {
        const int r = q / Q, c = (q % Q) * 4;
        const bool in = t0 + r < S && ch0 + c < DI;
        const long long off = in ? (row0 + r) * DI + ch0 + c : 0;
        cp_async16(s + T::DT + r * CH + c, dt + off, in);
        cp_async16(s + T::DY + r * CH + c, dy + off, in);
        if constexpr (T::XB) cp_async16(s + T::X + r * CH + c, x + off, in);
      }
    }
    if (threadIdx.x < BC) {
      const int q = threadIdx.x;
      const bool in = t0 + q * 4 / N < S;
      const long long off = in ? row0 * N + q * 4 : 0;
      cp_async16(s + T::C + q * 4, cm + off, in);
      if constexpr (T::XB) cp_async16(s + T::B + q * 4, bm + off, in);
    }
  } else {
    for (int e = threadIdx.x; e < STEPS * CH; e += THREADS) {
      const int r = e / CH, c = e % CH;
      const bool in = t0 + r < S && ch0 + c < DI;
      const long long off = in ? (row0 + r) * DI + ch0 + c : 0;
      cp_async4(s + T::DT + e, dt + off, in);
      cp_async4(s + T::DY + e, dy + off, in);
      if constexpr (T::XB) cp_async4(s + T::X + e, x + off, in);
    }
    for (int e = threadIdx.x; e < STEPS * N; e += THREADS) {
      const bool in = t0 + e / N < S;
      const long long off = in ? row0 * N + e : 0;
      cp_async4(s + T::C + e, cm + off, in);
      if constexpr (T::XB) cp_async4(s + T::B + e, bm + off, in);
    }
  }
  cp_async_commit();
}

// The L lanes of a channel hold partial sums p[q] of steps q = 0 .. L-1;
// returns, in lane l, the sum over the lanes of step l (the forward's
// butterfly: in each round a lane keeps the half of its steps that holds
// its own and sends the other half to its partner).
template <int L, int LOG2L>
__device__ __forceinline__ float lane_sum(float (&p)[L], int lane) {
#pragma unroll
  for (int round = 0; round < LOG2L; ++round) {
    const int half = L >> (round + 1);
    const bool upper = lane & half;
#pragma unroll
    for (int q = 0; q < half; ++q) {
      const float send = upper ? p[q] : p[q + half];
      const float keep = upper ? p[q + half] : p[q];
      p[q] = keep + __shfl_xor_sync(0xffffffffu, send, half);
    }
  }
  return p[0];
}

// One round of channel_sum's recursive halving and the rounds after it:
// each thread keeps the half of its HALF * 2 values that its bit HALF of
// cg selects and adds its partner's (L threads a channel apart) to them.
template <int L, int M, int HALF>
__device__ __forceinline__ void halve(float (&v)[M], int cg) {
  if constexpr (HALF >= 1) {
    const bool upper = cg & HALF;
#pragma unroll
    for (int q = 0; q < HALF; ++q) {
      const float send = upper ? v[q] : v[q + HALF];
      const float keep = upper ? v[q + HALF] : v[q];
      v[q] = keep + __shfl_xor_sync(0xffffffffu, send, HALF * L);
    }
    halve<L, M, HALF / 2>(v, cg);
  }
}

// The threads of one lane index in a warp, one a channel (cg = 0 .. P-1,
// P = 32 / L, L threads apart), hold M values v each; returns, in the
// thread at cg, value cg % M summed over the P channels: recursive halving
// over the low log2 M bits of cg, then an all-reduce over the rest.
template <int L, int M, int P>
__device__ __forceinline__ float channel_sum(float (&v)[M], int cg) {
  halve<L, M, M / 2>(v, cg);
#pragma unroll
  for (int o = M; o < P; o *= 2)
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], o * L);
  return v[0];
}

// Each chunk's outgoing carry from a zero incoming one (local) and the
// product of its decays (prod), states by PRE_STATES a thread, a warp 32
// neighbouring channels: block (x, k - 1, b) takes chunk k >= 1 of row b.
// Tiles of dt and dy (the block's PCH channels) and C (the row's) go
// through a two-stage buffer by cp.async, the tile before loading while a
// tile is run; steps past S are zeros (a decay of 1, no input: the carry
// stays).
template <int N>
__global__ void __launch_bounds__(THREADS)
scan_bwd_prepass(const float* __restrict__ dt, const float* __restrict__ cm,
                 const float* __restrict__ a, const float* __restrict__ dy,
                 float* __restrict__ local, float* __restrict__ prod, int S,
                 int DI, int chunk, int vec) {
  constexpr int G = N / PRE_STATES;        // threads a channel
  constexpr int PCH = THREADS / G;         // channels a block
  using Lay = Tile<PCH, N, false>;
  __shared__ __align__(16) float sm[2 * Lay::SIZE];
  const int k = blockIdx.y + 1, nk = gridDim.y + 1, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int s0 = (tid / 32) % G * PRE_STATES;
  const int ch = blockIdx.x * PCH + tid / (32 * G) * 32 + tid % 32;
  const int cl = ch - blockIdx.x * PCH;
  const bool live = ch < DI;
  const int ch0 = blockIdx.x * PCH;

  float a2[PRE_STATES], carry[PRE_STATES], p[PRE_STATES];
#pragma unroll
  for (int i = 0; i < PRE_STATES; ++i) {
    a2[i] = live ? a[(long long)ch * N + s0 + i] * LOG2E : 0.f;
    carry[i] = 0.f;
    p[i] = 1.f;
  }
  const int j_lo = k * (chunk / STEPS);
  const int j_hi = min(j_lo + chunk / STEPS, (S + STEPS - 1) / STEPS);
  stage<Lay>(sm + ((j_hi - 1) & 1) * Lay::SIZE, dt, nullptr, dy, nullptr,
             cm, b, (j_hi - 1) * STEPS, S, DI, ch0, vec);
#pragma unroll 1
  for (int j = j_hi - 1; j >= j_lo; --j) {
    cp_async_wait_all();
    __syncthreads();               // tile j landed; tile j + 1's stage read
    if (j > j_lo)
      stage<Lay>(sm + ((j - 1) & 1) * Lay::SIZE, dt, nullptr, dy, nullptr,
                 cm, b, (j - 1) * STEPS, S, DI, ch0, vec);
    const float* st = sm + (j & 1) * Lay::SIZE;
#pragma unroll
    for (int r = STEPS - 1; r >= 0; --r) {
      const float dtv = st[Lay::DT + r * PCH + cl];
      const float dyv = st[Lay::DY + r * PCH + cl];
      const float* cr = st + Lay::C + r * N + s0;
#pragma unroll
      for (int i = 0; i < PRE_STATES; ++i) {
        const float dec = ex2(dtv * a2[i]);
        const float g = fmaf(cr[i], dyv, carry[i]);
        carry[i] = g * dec;
        p[i] *= dec;
      }
    }
  }
  if (live) {
    const long long o = (((long long)b * nk + k) * DI + ch) * N + s0;
#pragma unroll
    for (int i = 0; i < PRE_STATES; ++i) {
      local[o + i] = carry[i];
      prod[o + i] = p[i];
    }
  }
}

template <int N>
__global__ void __launch_bounds__(THREADS)
ssm_scan_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                    const float* __restrict__ bm, const float* __restrict__ cm,
                    const float* __restrict__ a,
                    const float* __restrict__ dskip,
                    const float* __restrict__ ckpt,
                    const float* __restrict__ dy,
                    const float* __restrict__ dh_last,
                    const float* __restrict__ local,
                    const float* __restrict__ prod,
                    float* __restrict__ ddt, float* __restrict__ dx,
                    float* __restrict__ db_part, float* __restrict__ dc_part,
                    float* __restrict__ da_part, float* __restrict__ dd_part,
                    float* __restrict__ dh0, int S, int DI, int chunk,
                    int vec) {
  using Sh = Shape<N>;
  using Lay = typename Sh::Lay;
  constexpr int L = Sh::L, CH = Sh::CH, SL = Sh::SL, M = Sh::M, P = Sh::P;
  extern __shared__ __align__(16) float sm[];
  const int bx = blockIdx.x, k = blockIdx.y, nk = gridDim.y;
  const int b = blockIdx.z, nb = gridDim.z;
  const int ch0 = bx * CH;
  const int tid = threadIdx.x, warp = tid / 32;
  const int cl = tid / L;                  // channel in the block
  const int lane = tid % L;                // lane in the channel
  const int cg = cl % P;                   // channel in the warp
  const int ch = ch0 + cl;
  const bool live = ch < DI;
  const long long state0 = ((long long)b * DI + ch) * N + lane * SL;
  const int n_tiles = (S + STEPS - 1) / STEPS;
  const int j_lo = k * (chunk / STEPS);
  const int j_hi = min(j_lo + chunk / STEPS, n_tiles);

  // The carry into this chunk: dh_T through the later chunks, last first.
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

  // The warps' dB and dC of tile jt, in warp order, into this block's
  // partial.
  float* red = sm + Sh::RED;               // [warp][dB, dC][step][n]
  auto flush = [&](int jt) {
    const int t0 = jt * STEPS;
    for (int e = tid; e < 2 * STEPS * N; e += THREADS) {
      const int q = e / (STEPS * N), r = e % (STEPS * N);
      if (t0 + r / N < S) {
        float sum = red[q * STEPS * N + r];
#pragma unroll
        for (int w = 1; w < WARPS; ++w)
          sum += red[(w * 2 + q) * STEPS * N + r];
        float* part = q ? dc_part : db_part;
        part[(((long long)bx * nb + b) * S + t0) * N + r] = sum;
      }
    }
  };

  float hn[SL];                            // the next tile's checkpoint
  if (j_hi > j_lo) {
    stage<Lay>(sm + ((j_hi - 1) & 1) * Lay::SIZE, dt, x, dy, bm, cm, b,
               (j_hi - 1) * STEPS, S, DI, ch0, vec);
#pragma unroll
    for (int i = 0; i < SL; ++i)
      hn[i] = live ? ckpt[(((long long)b * n_tiles + j_hi - 1) * DI + ch)
                          * N + lane * SL + i] : 0.f;
  }
  if (live) {
    for (int q = nk - 1; q > k; --q) {
      const long long o = (((long long)b * nk + q) * DI + ch) * N + lane * SL;
#pragma unroll
      for (int i = 0; i < SL; ++i)
        carry[i] = fmaf(prod[o + i], carry[i], local[o + i]);
    }
  }
#pragma unroll 1
  for (int j = j_hi - 1; j >= j_lo; --j) {
    const int t0 = j * STEPS;
    cp_async_wait_all();
    __syncthreads();          // tile j landed; tile j + 1's sums read
    if (j > j_lo)
      stage<Lay>(sm + ((j - 1) & 1) * Lay::SIZE, dt, x, dy, bm, cm, b,
                 t0 - STEPS, S, DI, ch0, vec);
    const float* s = sm + (j & 1) * Lay::SIZE;
    // The tile's states from its checkpoint, as the forward ran them
    // (steps past S have dt = 0 and u = 0: h stays).  hs[r] holds h
    // before step t0 + r; h ends as the state after the tile.
    float h[SL], hs[STEPS][SL];
#pragma unroll
    for (int i = 0; i < SL; ++i) {
      h[i] = hn[i];
      if (j > j_lo)
        hn[i] = live ? ckpt[(((long long)b * n_tiles + j - 1) * DI + ch)
                            * N + lane * SL + i] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < STEPS; ++r) {
      const float dtv = s[Lay::DT + r * CH + cl];
      const float u = dtv * s[Lay::X + r * CH + cl];
      const float* br = s + Lay::B + r * N + lane * SL;
#pragma unroll
      for (int i = 0; i < SL; ++i) {
        hs[r][i] = h[i];
        h[i] = fmaf(ex2(dtv * a2[i]), h[i], u * br[i]);
      }
    }
    // Backwards over the tile, L steps a group: lane l stores step l.
#pragma unroll
    for (int g = STEPS - L; g >= 0; g -= L) {
      float pdu[L], pdec[L];
#pragma unroll
      for (int q = L - 1; q >= 0; --q) {
        const int r = g + q;
        const float dtv = s[Lay::DT + r * CH + cl];
        const float xv = s[Lay::X + r * CH + cl];
        const float dyv = s[Lay::DY + r * CH + cl];
        const float u = dtv * xv;
        const float* br = s + Lay::B + r * N + lane * SL;
        const float* cr = s + Lay::C + r * N + lane * SL;
        float du = 0.f, ddec = 0.f, v[M];
#pragma unroll
        for (int i = 0; i < SL; ++i) {
          const float hp = hs[r][i];
          const float gv = fmaf(cr[i], dyv, carry[i]);
          const float dec = ex2(dtv * a2[i]);
          const float gdh = gv * dec * hp;
          v[i] = gv * u;                   // dB's term
          v[SL + i] = h[i] * dyv;          // dC's term: h after step r
          du = fmaf(gv, br[i], du);
          ddec = fmaf(gdh, av[i], ddec);
          da[i] = fmaf(gdh, dtv, da[i]);
          carry[i] = gv * dec;
          h[i] = hp;
        }
        pdu[q] = du;
        pdec[q] = ddec;
        dd = fmaf(xv, dyv, dd);
        const int e = cg % M;              // this thread's dB / dC sum
        const float sum = channel_sum<L, M, P>(v, cg);
        if (cg < M)
          red[((warp * 2 + e / SL) * STEPS + r) * N + lane * SL + e % SL] =
              sum;
      }
      const float du = lane_sum<L, Sh::LOG2L>(pdu, lane);
      const float ddec = lane_sum<L, Sh::LOG2L>(pdec, lane);
      const int r = g + lane;
      if (live && t0 + r < S) {
        const long long o = ((long long)b * S + t0 + r) * DI + ch;
        const float dtv = s[Lay::DT + r * CH + cl];
        const float xv = s[Lay::X + r * CH + cl];
        const float dyv = s[Lay::DY + r * CH + cl];
        __stcs(dx + o, fmaf(du, dtv, dsk * dyv));
        __stcs(ddt + o, fmaf(du, xv, ddec));
      }
    }
    __syncthreads();                       // the tile's sums written
    flush(j);
  }
  if (live) {
    const long long p = ((long long)k * nb + b) * DI + ch;
#pragma unroll
    for (int i = 0; i < SL; ++i) {
      if (k == 0) dh0[state0 + i] = carry[i];
      da_part[p * N + lane * SL + i] = da[i];
    }
    if (lane == 0) dd_part[p] = dd;
  }
}

// out_q[e] = sum over p < parts_q of part_q[p n_q + e], in order of p, for
// the four sums q (blockIdx.y): dB and dC over the blocks of channels, dA
// and dD over the chunks and batch rows.
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
    // Eight partials loaded at a time, then added in order.
    float sum = 0.f;
    int p = 0;
    for (; p + 8 <= s.parts[q]; p += 8) {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = s.part[q][(p + i) * n + e];
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += v[i];
    }
    for (; p < s.parts[q]; ++p) sum += s.part[q][p * n + e];
    s.out[q][e] = sum;
  }
}

struct Args {
  const float *dt, *x, *bm, *cm, *a, *dskip, *ckpt, *dy, *dh_last;
  float *local, *prod, *ddt, *dx, *db_part, *dc_part, *da_part, *dd_part,
      *dh0;
  int B, S, DI, chunk, chunks;
  bool vec;
};

// The pre-pass (none at one chunk), then the walk.
template <int N>
int launch(const Args& g, cudaStream_t stream) {
  using Sh = Shape<N>;
  if (g.chunks > 1) {
    constexpr int PCH = THREADS / (N / PRE_STATES);
    const dim3 grid((g.DI + PCH - 1) / PCH, g.chunks - 1, g.B);
    scan_bwd_prepass<N><<<grid, THREADS, 0, stream>>>(
        g.dt, g.cm, g.a, g.dy, g.local, g.prod, g.S, g.DI, g.chunk,
        g.vec ? 1 : 0);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (Sh::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssm_scan_bwd_kernel<N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((g.DI + Sh::CH - 1) / Sh::CH, g.chunks, g.B);
  ssm_scan_bwd_kernel<N><<<grid, THREADS, Sh::SMEM, stream>>>(
      g.dt, g.x, g.bm, g.cm, g.a, g.dskip, g.ckpt, g.dy, g.dh_last, g.local,
      g.prod, g.ddt, g.dx, g.db_part, g.dc_part, g.da_part, g.dd_part, g.dh0,
      g.S, g.DI, g.chunk, g.vec ? 1 : 0);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// The scan's gradient over B batch rows of S steps and DI channels with N
// states (8 or 16; N / 4 lanes a channel, 128 / (N / 4) channels a walk
// block) in chunks of `chunk` steps (a positive multiple of 16); another
// -> cudaErrorInvalidValue.  ckpt: the forward's (B, ceil(S / 16), DI, N)
// states at the tiles' starts; dh_last: the final state's gradient (B,
// DI, N) or null for zeros.  Writes ddt, dx (B, S, DI), db, dc (B, S, N),
// da (DI, N), dd (DI), dh0 (B, DI, N); scratch, with K = max(1, ceil(S /
// chunk)) chunks: db_part and dc_part (ceil(DI / (512 / N)), B, S, N),
// da_part (K, B, DI, N), dd_part (K, B, DI), local and prod (B, K, DI,
// N).  Three launches: the chunks' pre-pass (none at one chunk), the
// walk, then the partials' sums.
extern "C" int ssm_scan_bwd_f32(
    const float* dt, const float* x, const float* bm, const float* cm,
    const float* a, const float* dskip, const float* ckpt, const float* dy,
    const float* dh_last, float* ddt, float* dx, float* db, float* dc,
    float* da, float* dd, float* dh0, float* db_part, float* dc_part,
    float* da_part, float* dd_part, float* local, float* prod, int B, int S,
    int DI, int N, int chunk, cudaStream_t stream) {
  if (B <= 0 || S < 0 || DI <= 0 || B > 65535 || chunk <= 0 ||
      chunk % STEPS)
    return (int)cudaErrorInvalidValue;
  const int chunks = S > chunk ? (S + chunk - 1) / chunk : 1;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  // 16-byte copies need every row of dt, x and dy, and of B and C (N is a
  // multiple of 4), to start on a 16-byte boundary.
  const bool vec = DI % 4 == 0 && aligned16(dt) && aligned16(x) &&
                   aligned16(dy) && aligned16(bm) && aligned16(cm);
  const Args g{dt, x, bm, cm, a, dskip, ckpt, dy, dh_last, local, prod,
               ddt, dx, db_part, dc_part, da_part, dd_part, dh0, B, S, DI,
               chunk, chunks, vec};
  int rc;
  if (N == 8)
    rc = launch<8>(g, stream);
  else if (N == 16)
    rc = launch<16>(g, stream);
  else
    return (int)cudaErrorInvalidValue;
  if (rc) return rc;
  const int channels = THREADS / (N / LANE_STATES);
  const int blocks_x = (DI + channels - 1) / channels;
  const long long bsn = (long long)B * S * N;
  const Sums s{{db_part, dc_part, da_part, dd_part},
               {db, dc, da, dd},
               {bsn, bsn, (long long)DI * N, DI},
               {blocks_x, blocks_x, chunks * B, chunks * B}};
  long long most = bsn > (long long)DI * N ? bsn : (long long)DI * N;
  long long grid = (most + 255) / 256;
  if (grid > 1024) grid = 1024;
  if (grid < 1) grid = 1;
  scan_bwd_sum<<<dim3((unsigned)grid, 4), 256, 0, stream>>>(s);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the walk at N states, in bytes; 0 where N has
// no instantiation.
extern "C" int ssm_scan_bwd_smem(int N) {
  if (N == 8) return Shape<8>::SMEM;
  if (N == 16) return Shape<16>::SMEM;
  return 0;
}

extern "C" const char* ssm_scan_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
