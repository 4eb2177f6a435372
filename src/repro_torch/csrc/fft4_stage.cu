// Radix-4 decimation-in-frequency FFT over rows: one butterfly stage
// (fft4_stage_f32) and the whole chain of a row in shared memory
// (fft4_fused_f32).
//
// The stage kernel replaces the Pallas kernel
// src/repro/kernels/fft4.py::fft4_stage (_stage_kernel), the OFDM
// demodulation stage of the 5G pipeline.  The fused kernel replaces the
// same kernel as src/repro/kernels/ops.py::fft4 chains it, log4(L)
// launches, with one.  Complex numbers travel as separate float32 re/im
// planes, as in the reference.  Both kernels run the butterfly below, so
// the fused chain equals the stage chain bit for bit.
//
// Layout: a row of length n holds n / (4q) sub-transforms of length 4q.
// Butterfly b of a row (j = b / q, k = b % q) reads the four points
// j*4q + s*q + k, s = 0..3, and writes y0..y3 to the same four
// positions: the reshape(rows, -1, 4, q) / stack(axis=2) layout of the
// reference kernel.  Twiddles are (3, q) planes holding W^k, W^2k, W^3k.
// After the last stage a row holds its spectrum in digit-reversed order.
//
// Stage kernel.  Bound: memory.  Each stage reads and writes every point
// once (16 bytes in, 16 bytes out per complex point) for about 8.5 flops
// a point.  One thread per butterfly keeps the loads of a warp on
// neighbouring k, so they coalesce when q >= 32.  It serves the leading
// stages of rows longer than a block's shared memory holds.
//
// Fused kernel.  A block holds R rows of length L <= 16384 (L_MAX: the
// largest power of 4 whose re/im planes, 8 L bytes, fit one block's
// dynamic shared memory; R L >= 4096, so short rows share a block) and
// runs all log4(L) stages.  Each pass takes two stages at once in
// registers: a thread holds the 16 points that one butterfly of stage s
// and the four of stage s + 1 touch.  The first pass reads the rows from
// device memory (neighbouring threads on neighbouring points), the last
// writes the digit-reversed rows back (16-byte stores where a group's
// points are contiguous), the passes between read and write shared memory
// in place: at L = 4096 three passes, two trips through shared memory.
// The __syncthreads between two passes is the block-local form of the
// paper's partial synchronisation between FFT stages (Fig. 3;
// src/repro/kernels/fft4.py:3-7): the PEs that share a sub-transform wait
// for each other, not the whole cluster.  Twiddles come from one table
// holding every stage's (3, q) planes back to back (L - 1 floats a
// plane), read through the read-only cache.  Bound: memory, the planes
// read once and written once: at (896, 4096) 58.7 MB, 0.0175 ms at
// 3.35 TB/s, where the stage chain moves 352 MB.
#include <cuda_runtime.h>

namespace {

// One butterfly on the four points (a, b, c, d) with twiddles W^k, W^2k,
// W^3k; the results overwrite the inputs.  Products are __fmul_rn, which
// the compiler never merges into an FMA, so every kernel that calls this
// rounds exactly as the plain version's separate multiplies and adds.
__device__ __forceinline__ void butterfly4(float& ar, float& ai, float& br,
                                           float& bi, float& cr, float& ci,
                                           float& dr, float& di, float w1r,
                                           float w1i, float w2r, float w2i,
                                           float w3r, float w3i) {
  const float t0r = ar + cr, t0i = ai + ci;
  const float t1r = ar - cr, t1i = ai - ci;
  const float t2r = br + dr, t2i = bi + di;
  const float t3r = bi - di, t3i = -(br - dr);   // -j * (b - d)

  const float u1r = t1r + t3r, u1i = t1i + t3i;
  const float u2r = t0r - t2r, u2i = t0i - t2i;
  const float u3r = t1r - t3r, u3i = t1i - t3i;

  ar = t0r + t2r;
  ai = t0i + t2i;
  br = __fmul_rn(u1r, w1r) - __fmul_rn(u1i, w1i);
  bi = __fmul_rn(u1r, w1i) + __fmul_rn(u1i, w1r);
  cr = __fmul_rn(u2r, w2r) - __fmul_rn(u2i, w2i);
  ci = __fmul_rn(u2r, w2i) + __fmul_rn(u2i, w2r);
  dr = __fmul_rn(u3r, w3r) - __fmul_rn(u3i, w3i);
  di = __fmul_rn(u3r, w3i) + __fmul_rn(u3i, w3r);
}

__global__ void fft4_stage_kernel(const float* __restrict__ re,
                                  const float* __restrict__ im,
                                  const float* __restrict__ wr,
                                  const float* __restrict__ wi,
                                  float* __restrict__ out_re,
                                  float* __restrict__ out_im,
                                  long long butterflies, int n, int q) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= butterflies) return;
  const int per_row = n / 4;
  const long long row = t / per_row;
  const int b = (int)(t - row * per_row);
  const int j = b / q;
  const int k = b - j * q;
  const long long p0 = row * n + (long long)j * 4 * q + k;
  const long long p1 = p0 + q, p2 = p0 + 2 * q, p3 = p0 + 3 * q;

  float ar = re[p0], ai = im[p0];
  float br = re[p1], bi = im[p1];
  float cr = re[p2], ci = im[p2];
  float dr = re[p3], di = im[p3];
  butterfly4(ar, ai, br, bi, cr, ci, dr, di, wr[k], wi[k], wr[q + k],
             wi[q + k], wr[2 * q + k], wi[2 * q + k]);
  out_re[p0] = ar;
  out_im[p0] = ai;
  out_re[p1] = br;
  out_im[p1] = bi;
  out_re[p2] = cr;
  out_im[p2] = ci;
  out_re[p3] = dr;
  out_im[p3] = di;
}

constexpr int FUSED_THREADS = 256;
constexpr int FUSED_L_MAX = 16384;
constexpr int FUSED_MIN_POINTS = 4096;   // points a block holds at least

__host__ __device__ constexpr int log4_of(int n) {
  return n <= 1 ? 0 : 1 + log4_of(n / 4);
}

template <int L>
__host__ __device__ constexpr int fused_rows() {   // rows a block holds
  return L >= FUSED_MIN_POINTS ? 1 : FUSED_MIN_POINTS / L;
}

template <int L>
__host__ __device__ constexpr int fused_smem_bytes() {
  // Passes after the first read shared memory; rows of 4 and 16 points
  // finish in the first pass, straight from and to device memory.
  return log4_of(L) > 2 ? 2 * (int)sizeof(float) * fused_rows<L>() * L : 0;
}

// One pass over the rows of a block: stages S and S + 1 (16-point groups,
// the second stage's sub-transforms are the first's outputs a = 0..3), or
// stage S alone when it is the last of an odd count (4-point groups).
// The first pass reads device memory, the last writes it, the others read
// and write shared memory in place.  The __syncthreads before a pass is
// the block-local barrier between FFT stages.
template <int L, int S>
__device__ __forceinline__ void fused_pass(
    const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ wr, const float* __restrict__ wi,
    float* __restrict__ out_re, float* __restrict__ out_im, float* sre,
    float* sim, int nrows) {
  constexpr int M = log4_of(L);
  constexpr bool PAIR = S + 1 < M;
  constexpr bool FIRST = S == 0, LAST = S + 2 >= M;
  constexpr int PTS = PAIR ? 16 : 4;         // points of a group
  constexpr int Q = L >> (2 * (S + 1));      // stage S's quarter length
  constexpr int Q2 = PAIR ? Q / 4 : 1;       // stage S + 1's
  constexpr int PER_ROW = L / PTS;           // groups of a row
  constexpr int GROUPS = fused_rows<L>() * PER_ROW;
  constexpr int OFF = L - 4 * Q;             // stage S's twiddles
  constexpr int OFF2 = L - Q;                // stage S + 1's
  // A group's points are contiguous when its last stage has q = 1: in
  // every last pass, and in the first when the row is that short.
  constexpr bool CONTIG = PAIR ? Q2 == 1 : Q == 1;
  static_assert(PAIR || Q == 1, "a single-stage pass is the last stage");
  static_assert(!LAST || CONTIG, "the last stage has q = 1");
  const float* src_re = FIRST ? re : sre;
  const float* src_im = FIRST ? im : sim;
  float* dst_re = LAST ? out_re : sre;
  float* dst_im = LAST ? out_im : sim;
  if (!FIRST) __syncthreads();
#pragma unroll
  for (int i = 0; i < (GROUPS + FUSED_THREADS - 1) / FUSED_THREADS; ++i) {
    const int g = i * FUSED_THREADS + threadIdx.x;
    const int row = g / PER_ROW;
    if ((GROUPS % FUSED_THREADS == 0 || g < GROUPS) && row < nrows) {
      const int gg = g % PER_ROW;
      const int k2 = gg % Q2;                // stage S + 1's twiddle index
      const int base = row * L + (gg / Q2) * 4 * Q + (PAIR ? k2 : 0);
      // Group point (a, b) sits at base + a Q + b Q2 (b = 0 when single).
      float xr[PTS], xi[PTS];
      if constexpr (FIRST && CONTIG) {
#pragma unroll
        for (int v = 0; v < PTS / 4; ++v) {
          const float4 r =
              *reinterpret_cast<const float4*>(src_re + base + 4 * v);
          const float4 m =
              *reinterpret_cast<const float4*>(src_im + base + 4 * v);
          xr[4 * v] = r.x, xr[4 * v + 1] = r.y, xr[4 * v + 2] = r.z;
          xr[4 * v + 3] = r.w;
          xi[4 * v] = m.x, xi[4 * v + 1] = m.y, xi[4 * v + 2] = m.z;
          xi[4 * v + 3] = m.w;
        }
      } else {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < PTS / 4; ++c) {
            xr[a * (PTS / 4) + c] = src_re[base + a * Q + c * Q2];
            xi[a * (PTS / 4) + c] = src_im[base + a * Q + c * Q2];
          }
      }
#pragma unroll
      for (int c = 0; c < PTS / 4; ++c) {    // stage S
        const int k = PAIR ? c * Q2 + k2 : 0;
        float* r = xr + c;
        float* m = xi + c;
        constexpr int St = PTS / 4;
        butterfly4(r[0], m[0], r[St], m[St], r[2 * St], m[2 * St],
                   r[3 * St], m[3 * St], __ldg(wr + OFF + k),
                   __ldg(wi + OFF + k), __ldg(wr + OFF + Q + k),
                   __ldg(wi + OFF + Q + k), __ldg(wr + OFF + 2 * Q + k),
                   __ldg(wi + OFF + 2 * Q + k));
      }
      if constexpr (PAIR) {                   // stage S + 1
        const float w1r = __ldg(wr + OFF2 + k2), w1i = __ldg(wi + OFF2 + k2);
        const float w2r = __ldg(wr + OFF2 + Q2 + k2);
        const float w2i = __ldg(wi + OFF2 + Q2 + k2);
        const float w3r = __ldg(wr + OFF2 + 2 * Q2 + k2);
        const float w3i = __ldg(wi + OFF2 + 2 * Q2 + k2);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float* r = xr + 4 * a;
          float* m = xi + 4 * a;
          butterfly4(r[0], m[0], r[1], m[1], r[2], m[2], r[3], m[3], w1r,
                     w1i, w2r, w2i, w3r, w3i);
        }
      }
      if constexpr (LAST) {
        // The points of a group are contiguous: 16-byte stores.
#pragma unroll
        for (int v = 0; v < PTS / 4; ++v) {
          *reinterpret_cast<float4*>(dst_re + base + 4 * v) =
              make_float4(xr[4 * v], xr[4 * v + 1], xr[4 * v + 2],
                          xr[4 * v + 3]);
          *reinterpret_cast<float4*>(dst_im + base + 4 * v) =
              make_float4(xi[4 * v], xi[4 * v + 1], xi[4 * v + 2],
                          xi[4 * v + 3]);
        }
      } else {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < PTS / 4; ++c) {
            dst_re[base + a * Q + c * Q2] = xr[a * (PTS / 4) + c];
            dst_im[base + a * Q + c * Q2] = xi[a * (PTS / 4) + c];
          }
      }
    }
  }
}

template <int L, int S>
__device__ __forceinline__ void fused_passes(
    const float* re, const float* im, const float* wr, const float* wi,
    float* out_re, float* out_im, float* sre, float* sim, int nrows) {
  if constexpr (S < log4_of(L)) {
    fused_pass<L, S>(re, im, wr, wi, out_re, out_im, sre, sim, nrows);
    fused_passes<L, S + 2>(re, im, wr, wi, out_re, out_im, sre, sim, nrows);
  }
}

// L is a template argument so that every loop has a fixed trip count and
// every index division is a shift.
template <int L>
__global__ void __launch_bounds__(FUSED_THREADS)
fft4_fused_kernel(const float* __restrict__ re, const float* __restrict__ im,
                  const float* __restrict__ wr, const float* __restrict__ wi,
                  float* __restrict__ out_re, float* __restrict__ out_im,
                  long long rows) {
  constexpr int R = fused_rows<L>();
  extern __shared__ float smem[];
  const long long row0 = (long long)blockIdx.x * R;
  const int nrows = (int)min((long long)R, rows - row0);
  fused_passes<L, 0>(re + row0 * L, im + row0 * L, wr, wi, out_re + row0 * L,
                     out_im + row0 * L, smem, smem + R * L, nrows);
}

template <int L>
int launch_fused(const float* re, const float* im, const float* wr,
                 const float* wi, float* out_re, float* out_im,
                 long long rows, cudaStream_t stream) {
  constexpr int R = fused_rows<L>();
  constexpr int smem = fused_smem_bytes<L>();
  // Raise the shared-memory limit once per device, so that a launch
  // captured into a CUDA graph is a launch and nothing else.
  static unsigned long long configured = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (!(configured >> device & 1ull)) {
    err = cudaFuncSetAttribute(fft4_fused_kernel<L>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    configured |= 1ull << device;
  }
  const long long blocks = (rows + R - 1) / R;
  fft4_fused_kernel<L><<<(unsigned)blocks, FUSED_THREADS, smem, stream>>>(
      re, im, wr, wi, out_re, out_im, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fft4_stage_f32(const float* re, const float* im,
                              const float* wr, const float* wi,
                              float* out_re, float* out_im,
                              int rows, int n, int q, cudaStream_t stream) {
  const long long butterflies = (long long)rows * (n / 4);
  if (butterflies == 0) return 0;
  const int threads = 256;
  const long long blocks = (butterflies + threads - 1) / threads;
  fft4_stage_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      re, im, wr, wi, out_re, out_im, butterflies, n, q);
  return (int)cudaGetLastError();
}

// rows x L float32 planes (contiguous, 16-byte aligned), L a power of 4
// in [4, FUSED_L_MAX]; wr/wi the L - 1 twiddles of every stage.
extern "C" int fft4_fused_f32(const float* re, const float* im,
                              const float* wr, const float* wi,
                              float* out_re, float* out_im, long long rows,
                              int L, cudaStream_t stream) {
  if (rows == 0) return 0;
  switch (L) {
    case 4: return launch_fused<4>(re, im, wr, wi, out_re, out_im, rows, stream);
    case 16: return launch_fused<16>(re, im, wr, wi, out_re, out_im, rows, stream);
    case 64: return launch_fused<64>(re, im, wr, wi, out_re, out_im, rows, stream);
    case 256: return launch_fused<256>(re, im, wr, wi, out_re, out_im, rows, stream);
    case 1024: return launch_fused<1024>(re, im, wr, wi, out_re, out_im, rows, stream);
    case 4096: return launch_fused<4096>(re, im, wr, wi, out_re, out_im, rows, stream);
    case FUSED_L_MAX: return launch_fused<FUSED_L_MAX>(re, im, wr, wi, out_re, out_im, rows, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fft4_stage_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
