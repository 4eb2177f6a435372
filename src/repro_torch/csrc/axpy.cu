// AXPY: out = a * x + y, elementwise, in the inputs' dtype.
//
// Replaces the Pallas kernel src/repro/kernels/axpy.py::axpy
// (_axpy_kernel), the paper's AXPY benchmark kernel.  x and y are
// float32 or bfloat16; `a` arrives by value as float32.  Each element is
// computed in float32 with one fused multiply-add and, for bfloat16,
// rounded to bfloat16 once.
//
// Design: a grid-stride loop over 16-byte packs (4 float32 or 8
// bfloat16 values), so every load and store is one 128-bit transaction
// and neighbouring threads touch neighbouring packs; a scalar loop takes
// the elements past the last whole pack, and all of them when a base
// pointer is not 16-byte aligned.  Out of place: the caller allocates
// `out`.
//
// Bound: bytes.  Two reads and one write per element for 2 flops: 1/6
// flop a byte in float32, far below the H100's 20 flops a byte.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;   // 16 resident-sized waves of SMs

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
            T* __restrict__ out, long long n) {
  constexpr int V = 16 / sizeof(T);
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x)
                         | reinterpret_cast<uintptr_t>(y)
                         | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long nv = aligned ? n / V : 0;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  uint4* ov = reinterpret_cast<uint4*>(out);
#pragma unroll 4
  for (long long v = tid; v < nv; v += stride)
    ov[v] = axpy_pack(a, __ldg(xv + v), __ldg(yv + v), T());
  for (long long i = nv * V + tid; i < n; i += stride)
    store(out + i, fmaf(a, to_f32(x[i]), to_f32(y[i])));
}

template <typename T>
int launch(float a, const T* x, const T* y, T* out, long long n,
           cudaStream_t stream) {
  if (n == 0) return 0;
  const long long packs = (n + 16 / sizeof(T) - 1) / (16 / sizeof(T));
  long long blocks = (packs + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  axpy_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(a, x, y, out, n);
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
