// Row-wise DCT-II: out (T, n) = float32(x) (T, n) @ basis_t (n, n).
//
// Replaces the Pallas kernel src/repro/kernels/dct.py::dct
// (_dct_kernel), the paper's DCT benchmark kernel.  The TPU kernel keeps
// the whole (n, n) basis resident in VMEM and streams 256-row tiles of x
// against it; at n = 4096 the basis is 64 MB, far past a Hopper block's
// 227 KB of shared memory, so here the basis streams through shared
// memory along a k-loop like any GEMM operand.  x is float32, bfloat16
// or float16 (converted to float32 as it enters shared memory); the
// basis and the output are float32, and the sums run in float32 FMAs.
//
// Design: one block of 256 threads per 128 x 128 output tile walks the
// k axis in steps of 8, staging a 128 x 8 tile of x (transposed) and an
// 8 x 128 tile of the basis in shared memory; each thread keeps an 8 x 8
// block of accumulators in registers, its rows and columns split into
// two groups of four 64 apart so that its shared-memory reads are
// conflict-free 16-byte loads.  Ragged T, n edges are masked on load
// (zeros) and on store.
//
// Bound: operations.  2 T n^2 flops against (T n + n^2) * 4 + T n * 4
// bytes: at (4096, 4096) 137 GFLOP, about 700 flops a byte, so the H100's
// 67 TFLOP/s of float32 outside the tensor cores bounds it (2.05 ms).
// The kernel uses no tensor cores (TF32 wgmma would change the
// rounding); reaching the float32 bound wants a deeper pipeline
// (cp.async double buffering), which is later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
dct_kernel(const T* __restrict__ x, const float* __restrict__ basis_t,
           float* __restrict__ out, int rows, int n) {
  __shared__ __align__(16) float xs[BK][BM];   // x tile, transposed
  __shared__ __align__(16) float bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // columns tx*4 .. +3 and 64 + tx*4 .. +3
  const int ty = tid / 16;   // rows ty*4 .. +3 and 64 + ty*4 .. +3
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += BK) {
#pragma unroll
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;   // r: row of x, c: along k
      const int gm = m0 + r, gk = k0 + c;
      xs[c][r] = (gm < rows && gk < n)
                     ? to_f32(x[(long long)gm * n + gk]) : 0.f;
    }
#pragma unroll
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;   // r: along k, c: output column
      const int gk = k0 + r, gn = n0 + c;
      bs[r][c] = (gk < n && gn < n) ? basis_t[(long long)gk * n + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gm >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gn < n) out[(long long)gm * n + gn] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const T* x, const float* basis_t, float* out, int rows, int n,
           cudaStream_t stream) {
  if (rows == 0 || n == 0) return 0;
  const dim3 grid((n + BN - 1) / BN, (rows + BM - 1) / BM);
  dct_kernel<T><<<grid, THREADS, 0, stream>>>(x, basis_t, out, rows, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dct_f32(const float* x, const float* basis_t, float* out,
                       int rows, int n, cudaStream_t stream) {
  return launch<float>(x, basis_t, out, rows, n, stream);
}

extern "C" int dct_bf16(const __nv_bfloat16* x, const float* basis_t,
                        float* out, int rows, int n, cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, basis_t, out, rows, n, stream);
}

extern "C" int dct_f16(const __half* x, const float* basis_t, float* out,
                       int rows, int n, cudaStream_t stream) {
  return launch<__half>(x, basis_t, out, rows, n, stream);
}

extern "C" const char* dct_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
