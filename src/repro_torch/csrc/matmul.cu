// Tiled GEMM with float32 accumulation: out (M, N) = x (M, K) @ w (K, N).
//
// Replaces the Pallas kernel src/repro/kernels/matmul.py::matmul
// (_mm_kernel), the beamforming product of the 5G pipeline.  Inputs are
// float32 or bfloat16 (converted to float32 as they enter shared
// memory); the output is always float32.
//
// Design: one block of 256 threads per 64 x 64 output tile walks the K
// axis in steps of 16, staging a 64 x 16 tile of x (transposed) and a
// 16 x 64 tile of w in shared memory; each thread keeps a 4 x 4 block of
// float32 accumulators in registers.  Ragged M, N and K edges are masked
// on load (zeros) and on store, so no caller pads.
//
// Bound: at the 5G shape (32 x 64 beams-by-antennas against 64 x 57344
// sub-carrier columns) the product does 2*M*K*N = 235 MFLOP on 22 MB of
// traffic, about 10 flops a byte: memory-bound on an H100.  The kernel
// reads w once and writes out once per output tile, which is the whole
// traffic when M <= 64.  It uses no tensor cores (no wgmma, no TMA): a
// compute-bound shape would want them, and that is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int PAD = 4;   // keeps rows 16-byte aligned, staggers banks

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mm_kernel(const T* __restrict__ x, const T* __restrict__ w,
          float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float xs[BK][BM + PAD];   // x tile, transposed
  __shared__ __align__(16) float ws[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // 4 output columns each
  const int ty = tid / 16;   // 4 output rows each
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;   // r: row of x, c: along K
      const int gm = m0 + r, gk = k0 + c;
      xs[c][r] = (gm < M && gk < K) ? to_f32(x[(long long)gm * K + gk])
                                    : 0.f;
    }
#pragma unroll
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;   // r: along K, c: column of w
      const int gk = k0 + r, gn = n0 + c;
      ws[r][c] = (gk < K && gn < N) ? to_f32(w[(long long)gk * N + gn])
                                    : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) out[(long long)gm * N + gn] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const T* x, const T* w, float* out, int M, int N, int K,
           cudaStream_t stream) {
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm_kernel<T><<<grid, THREADS, 0, stream>>>(x, w, out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int matmul_f32(const float* x, const float* w, float* out,
                          int M, int N, int K, cudaStream_t stream) {
  return launch<float>(x, w, out, M, N, K, stream);
}

extern "C" int matmul_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                           float* out, int M, int N, int K,
                           cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, w, out, M, N, K, stream);
}

extern "C" const char* matmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
