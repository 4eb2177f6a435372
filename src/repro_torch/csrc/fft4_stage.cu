// One radix-4 decimation-in-frequency butterfly stage over rows.
//
// Replaces the Pallas kernel src/repro/kernels/fft4.py::fft4_stage
// (_stage_kernel), the OFDM demodulation stage of the 5G pipeline.
// Complex numbers travel as separate float32 re/im planes, as in the
// reference.
//
// Layout: a row of length n holds n / (4q) sub-transforms of length 4q.
// Butterfly b of a row (j = b / q, k = b % q) reads the four points
// j*4q + s*q + k, s = 0..3, and writes y0..y3 to the same four
// positions: the reshape(rows, -1, 4, q) / stack(axis=2) layout of the
// reference kernel.  Twiddles are (3, q) planes holding W^k, W^2k, W^3k.
//
// Bound: memory.  Each stage reads and writes every point once (16 bytes
// in, 16 bytes out per complex point) for about 8.5 flops a point, far
// below the card's flops-per-byte balance.  One thread per butterfly
// keeps the loads of a warp on neighbouring k, so they coalesce when
// q >= 32 (all stages of a 4096-point row but the last three, where a
// warp's four loads still fall in one contiguous span).  Fusing all
// stages of a row in shared memory (one read, one write per FFT) is the
// next step and is not done here.
#include <cuda_runtime.h>

namespace {

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

  const float ar = re[p0], ai = im[p0];
  const float br = re[p1], bi = im[p1];
  const float cr = re[p2], ci = im[p2];
  const float dr = re[p3], di = im[p3];

  const float t0r = ar + cr, t0i = ai + ci;
  const float t1r = ar - cr, t1i = ai - ci;
  const float t2r = br + dr, t2i = bi + di;
  const float t3r = bi - di, t3i = -(br - dr);   // -j * (b - d)

  const float w1r = wr[k], w1i = wi[k];
  const float w2r = wr[q + k], w2i = wi[q + k];
  const float w3r = wr[2 * q + k], w3i = wi[2 * q + k];

  const float u1r = t1r + t3r, u1i = t1i + t3i;
  const float u2r = t0r - t2r, u2i = t0i - t2i;
  const float u3r = t1r - t3r, u3i = t1i - t3i;

  out_re[p0] = t0r + t2r;
  out_im[p0] = t0i + t2i;
  out_re[p1] = u1r * w1r - u1i * w1i;
  out_im[p1] = u1r * w1i + u1i * w1r;
  out_re[p2] = u2r * w2r - u2i * w2i;
  out_im[p2] = u2r * w2i + u2i * w2r;
  out_re[p3] = u3r * w3r - u3i * w3i;
  out_im[p3] = u3r * w3i + u3i * w3r;
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

extern "C" const char* fft4_stage_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
