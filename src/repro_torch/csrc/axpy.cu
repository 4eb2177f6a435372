// AXPY: out = a * x + y, elementwise, in the inputs' dtype.
//
// Replaces the Pallas kernel src/repro/kernels/axpy.py::axpy
// (_axpy_kernel), the paper's AXPY benchmark kernel.  x and y are
// float32 or bfloat16; `a` arrives by value as float32.  Each element is
// computed in float32 with one fused multiply-add and, for bfloat16,
// rounded to bfloat16 once.
//
// Design: each thread takes a fixed run of PACKS 16-byte packs (4
// float32 or 8 bfloat16 values) of x and of y, PACKS * THREADS packs a
// block and one block per run of the array (no grid-stride loop), and
// issues all of its loads before its first FMA or store, so that every
// thread keeps 2 PACKS loads in flight; neighbouring threads touch
// neighbouring packs.  Loads are streaming (__ldcs) and so are stores
// (__stcs): nothing is read twice.  The last block also takes the
// elements past the last whole pack, and every block takes its run
// element by element when a base pointer is not 16-byte aligned.  Out
// of place: the caller allocates `out`.
//
// Bound: bytes.  Two reads and one write per element for 2 flops: 1/6
// flop a byte in float32, far below the H100's 20 flops a byte.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PACKS = 2;   // 16-byte packs of x (and of y) a thread

__device__ __forceinline__ float4 axpy4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y),
                     fmaf(a, x.z, y.z), fmaf(a, x.w, y.w));
}

__device__ __forceinline__ uint4 axpy_pack(float a, uint4 xp, uint4 yp,
                                           float) {
  const float4 r = axpy4(a, *reinterpret_cast<const float4*>(&xp),
                         *reinterpret_cast<const float4*>(&yp));
  return *reinterpret_cast<const uint4*>(&r);
}

__device__ __forceinline__ uint4 axpy_pack(float a, uint4 xp, uint4 yp,
                                           __nv_bfloat16) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&xp);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&yp);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 fx = __bfloat1622float2(x[k]);
    const float2 fy = __bfloat1622float2(y[k]);
    o[k] = __floats2bfloat162_rn(fmaf(a, fx.x, fy.x), fmaf(a, fx.y, fy.y));
  }
  return out;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
axpy_kernel(float a, const T* __restrict__ x, const T* __restrict__ y,
            T* __restrict__ out, long long n, int aligned) {
  constexpr int V = 16 / sizeof(T);
  const long long first = (long long)blockIdx.x * (THREADS * PACKS * V);
  if (!aligned) {
    for (int j = 0; j < PACKS * V; ++j) {
      const long long i = first + j * THREADS + threadIdx.x;
      if (i < n) store(out + i, fmaf(a, to_f32(x[i]), to_f32(y[i])));
    }
    return;
  }
  const long long nv = n / V;
  const long long v0 = first / V + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  uint4* ov = reinterpret_cast<uint4*>(out);
  uint4 xp[PACKS], yp[PACKS];
#pragma unroll
  for (int j = 0; j < PACKS; ++j) {
    const long long v = v0 + j * THREADS;
    if (v < nv) {
      xp[j] = __ldcs(xv + v);
      yp[j] = __ldcs(yv + v);
    }
  }
#pragma unroll
  for (int j = 0; j < PACKS; ++j) {
    const long long v = v0 + j * THREADS;
    if (v < nv) __stcs(ov + v, axpy_pack(a, xp[j], yp[j], T()));
  }
  const long long i = nv * V + threadIdx.x;   // fewer than V left over
  if (blockIdx.x == gridDim.x - 1 && i < n)
    store(out + i, fmaf(a, to_f32(x[i]), to_f32(y[i])));
}

template <typename T>
int launch(float a, const T* x, const T* y, T* out, long long n,
           cudaStream_t stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long span = (long long)THREADS * PACKS * (16 / sizeof(T));
  const long long blocks = (n + span - 1) / span;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int aligned = ((reinterpret_cast<uintptr_t>(x)
                        | reinterpret_cast<uintptr_t>(y)
                        | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  axpy_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(a, x, y, out, n,
                                                           aligned);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int axpy_f32(float a, const float* x, const float* y, float* out,
                        long long n, cudaStream_t stream) {
  return launch<float>(a, x, y, out, n, stream);
}

extern "C" int axpy_bf16(float a, const __nv_bfloat16* x,
                         const __nv_bfloat16* y, __nv_bfloat16* out,
                         long long n, cudaStream_t stream) {
  return launch<__nv_bfloat16>(a, x, y, out, n, stream);
}

extern "C" const char* axpy_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
