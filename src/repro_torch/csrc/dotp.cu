// Dot product as a barrier-coupled reduction: the paper's DOTP kernel,
// with its two synchronization patterns.
//
// Replaces three Pallas kernels of src/repro/kernels/dotp.py:
//   dotp_central      every tile adds its partial sum into ONE revisited
//                     accumulator (the central counter) -> here one
//                     atomicAdd per block into a single float address;
//   dotp_partials     one independent partial sum per tile (the leaves
//                     of the k-ary tree) -> one block per leaf;
//   combine_partials  one k-ary tree level: groups of `radix` partials
//                     summed into one, the last group zero-padded -> one
//                     block per group, the padding a masked load.
//
// A leaf is 32768 elements, the reference's (256, 128) tile, so the leaf
// count and with it the tree depth at every radix equal the reference's
// (32 leaves at 1 Mi elements).  Inputs are float32 or bfloat16, widened
// to float32 as they are loaded; every sum is float32.
//
// Design: 256 threads per leaf read the leaf with 16-byte vector loads
// (a scalar loop takes the ragged tail, and the whole leaf when a base
// pointer is not 16-byte aligned), accumulate one float32 per thread
// with fused multiply-adds, and reduce across the block with warp
// shuffles and one shared-memory step.  The central variant's adds land
// on one address in no fixed order, so its result varies in the last
// bits from run to run; callers hold it to a tolerance.
//
// Bound: bytes.  A dot product reads each input once and does 2 flops
// per element pair (0.25 flop a byte in float32), far below the H100's
// 20 flops a byte; a tree level reads `n` partials and writes n/radix.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long LEAF = 32768;   // elements per leaf (256 x 128)

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int VEC = 4;   // elements per 16-byte load
  __device__ static float f32(float v) { return v; }
  __device__ static float dot(uint4 a, uint4 b, float acc) {
    const float4 x = *reinterpret_cast<const float4*>(&a);
    const float4 y = *reinterpret_cast<const float4*>(&b);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    return fmaf(x.w, y.w, acc);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static float f32(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static float dot(uint4 a, uint4 b, float acc) {
    const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 fx = __bfloat1622float2(x[k]);
      const float2 fy = __bfloat1622float2(y[k]);
      acc = fmaf(fx.x, fy.x, acc);
      acc = fmaf(fx.y, fy.y, acc);
    }
    return acc;
  }
};

// Sum of v over the block; the result is valid in thread 0.  blockDim.x
// is a multiple of 32.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// This thread's share of sum(x[i] * y[i]) over the leaf of this block.
template <typename T>
__device__ __forceinline__ float leaf_share(const T* __restrict__ x,
                                            const T* __restrict__ y,
                                            long long n) {
  constexpr int V = Elem<T>::VEC;
  const long long lo = (long long)blockIdx.x * LEAF;
  const long long hi = lo + LEAF < n ? lo + LEAF : n;
  float acc = 0.f;
  long long tail = lo;
  // lo * sizeof(T) is a multiple of 16, so the bases decide alignment.
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y))
       & 15) == 0) {
    const long long nv = (hi - lo) / V;
    const uint4* xv = reinterpret_cast<const uint4*>(x + lo);
    const uint4* yv = reinterpret_cast<const uint4*>(y + lo);
#pragma unroll 4
    for (long long v = threadIdx.x; v < nv; v += THREADS)
      acc = Elem<T>::dot(__ldg(xv + v), __ldg(yv + v), acc);
    tail = lo + nv * V;
  }
  for (long long i = tail + threadIdx.x; i < hi; i += THREADS)
    acc = fmaf(Elem<T>::f32(x[i]), Elem<T>::f32(y[i]), acc);
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
partials_kernel(const T* __restrict__ x, const T* __restrict__ y,
                float* __restrict__ out, long long n) {
  const float s = block_sum(leaf_share(x, y, n));
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
central_kernel(const T* __restrict__ x, const T* __restrict__ y,
               float* __restrict__ acc, long long n) {
  const float s = block_sum(leaf_share(x, y, n));
  if (threadIdx.x == 0) atomicAdd(acc, s);
}

__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ parts, float* __restrict__ out,
               long long n, int radix) {
  const long long lo = (long long)blockIdx.x * radix;
  float v = 0.f;
  for (int i = threadIdx.x; i < radix; i += blockDim.x) {
    const long long j = lo + i;
    if (j < n) v += parts[j];   // the zero padding of the last group
  }
  v = block_sum(v);
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

long long leaves(long long n) { return (n + LEAF - 1) / LEAF; }

template <typename T>
int launch_partials(const T* x, const T* y, float* out, long long n,
                    cudaStream_t stream) {
  partials_kernel<T><<<(unsigned)leaves(n), THREADS, 0, stream>>>(
      x, y, out, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_central(const T* x, const T* y, float* acc, long long n,
                   cudaStream_t stream) {
  const cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  central_kernel<T><<<(unsigned)leaves(n), THREADS, 0, stream>>>(
      x, y, acc, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dotp_partials_f32(const float* x, const float* y, float* out,
                                 long long n, cudaStream_t stream) {
  return launch_partials<float>(x, y, out, n, stream);
}

extern "C" int dotp_partials_bf16(const __nv_bfloat16* x,
                                  const __nv_bfloat16* y, float* out,
                                  long long n, cudaStream_t stream) {
  return launch_partials<__nv_bfloat16>(x, y, out, n, stream);
}

extern "C" int dotp_central_f32(const float* x, const float* y, float* acc,
                                long long n, cudaStream_t stream) {
  return launch_central<float>(x, y, acc, n, stream);
}

extern "C" int dotp_central_bf16(const __nv_bfloat16* x,
                                 const __nv_bfloat16* y, float* acc,
                                 long long n, cudaStream_t stream) {
  return launch_central<__nv_bfloat16>(x, y, acc, n, stream);
}

extern "C" int combine_partials_f32(const float* parts, float* out,
                                    long long n, int radix,
                                    cudaStream_t stream) {
  const unsigned groups = (unsigned)((n + radix - 1) / radix);
  const int threads = radix <= 32 ? 32 : THREADS;
  combine_kernel<<<groups, threads, 0, stream>>>(parts, out, n, radix);
  return (int)cudaGetLastError();
}

extern "C" const char* dotp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
