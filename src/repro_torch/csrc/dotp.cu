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
//                     warp segment per group, the padding a masked load;
// and, for the chain of those levels that the reference runs as one
// pallas_call per level, combine_tree: every level above the leaves in
// ONE block, the partials held in shared memory and the levels separated
// by the block's own barrier (__syncthreads) instead of kernel
// boundaries -- the paper's tree barrier inside one SM.
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
// Both combine kernels sum a group through one function, group_sum, in
// one fixed order: the group's lanes (a segment of w = min(32,
// next_pow2(radix)) lanes of a warp) each add their elements i, i + w,
// ... in sequence, then the segment reduces by xor shuffles w/2, ..., 1.
// So a tree launch gives the bits of the chain of per-level launches,
// the last group's zero padding included.  A tree holds at most
// TREE_MAX partials (the 227 KB a block can have); the caller runs
// per-level launches until the count fits.
//
// Bound: bytes.  A dot product reads each input once and does 2 flops
// per element pair (0.25 flop a byte in float32), far below the H100's
// 20 flops a byte; a tree level reads `n` partials and writes n/radix.
// A tree over the path's 2048 leaves is 8 KB of work: its time is the
// launch, which is why the levels share one.
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

// Lanes of a warp segment that sums one group of `radix`: the next power
// of two, at most a warp.
__host__ __device__ __forceinline__ int segment_width(int radix) {
  int w = 2;
  while (w < radix && w < 32) w <<= 1;
  return w;
}

// The sum of group g of src[0, n) (zero past n), in the fixed order both
// combine kernels share; `sl` is this lane's place in its segment of w
// lanes.  Every lane of the warp must call it (the shuffles span the
// warp); each lane of the segment gets the same bits.
__device__ __forceinline__ float group_sum(const float* src, long long n,
                                           long long g, int radix, int w,
                                           int sl) {
  const long long lo = g * radix;
  float v = 0.f;
  for (int i = sl; i < radix; i += w) {
    const long long j = lo + i;
    if (j < n) v += src[j];   // the zero padding of the last group
  }
  for (int o = w >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One tree level: 32 / w groups per warp.
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ parts, float* __restrict__ out,
               long long n, int radix, int w) {
  const int lane = threadIdx.x & 31;
  const long long g =
      ((long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32) * (32 / w)
      + lane / w;
  const long long groups = (n + radix - 1) / radix;
  const float v = group_sum(parts, n, g, radix, w, lane % w);
  if (lane % w == 0 && g < groups) out[g] = v;
}

constexpr int TREE_THREADS = 1024;
constexpr int TREE_MAX = 232448 / 4;   // partials in a block's 227 KB

// Every level from n partials down to one, in one block.  A level runs
// in rounds of (TREE_THREADS / w) groups: each round reads its groups,
// waits at the barrier, and writes its sums to the front of the buffer
// (a round's writes land below every later round's reads), so the
// levels run in place.  Once a level's groups fit in one warp, warp 0
// runs the rest alone, synchronised by __syncwarp: the same group_sum
// calls in the same lanes, without the block-wide barrier.
__global__ void __launch_bounds__(TREE_THREADS)
combine_tree_kernel(const float* __restrict__ parts, float* __restrict__ out,
                    int n, int radix, int w) {
  extern __shared__ float buf[];
  for (int i = threadIdx.x; i < n; i += TREE_THREADS) buf[i] = parts[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / w;
  const int per_round = (TREE_THREADS / 32) * per_warp;
  const int slot = (threadIdx.x / 32) * per_warp + lane / w;
  int m = n;
  for (; m > 1 && (m + radix - 1) / radix > per_warp;
       m = (m + radix - 1) / radix) {
    const int groups = (m + radix - 1) / radix;
    for (int base = 0; base < groups; base += per_round) {
      const int g = base + slot;
      const float v = group_sum(buf, m, g, radix, w, lane % w);
      __syncthreads();            // every read of this round is done
      if (lane % w == 0 && g < groups) buf[g] = v;
      __syncthreads();            // the sums are there for the next level
    }
  }
  if (threadIdx.x >= 32) return;
  for (; m > 1; m = (m + radix - 1) / radix) {
    const float v = group_sum(buf, m, slot, radix, w, lane % w);
    __syncwarp();
    if (lane % w == 0 && slot < (m + radix - 1) / radix) buf[slot] = v;
    __syncwarp();
  }
  if (threadIdx.x == 0) out[0] = buf[0];
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
  if (n <= 0 || radix < 2) return (int)cudaErrorInvalidValue;
  const int w = segment_width(radix);
  const long long groups = (n + radix - 1) / radix;
  const long long per_block = (THREADS / 32) * (32 / w);
  combine_kernel<<<(unsigned)((groups + per_block - 1) / per_block), THREADS,
                   0, stream>>>(parts, out, n, radix, w);
  return (int)cudaGetLastError();
}

// The whole tree above n <= TREE_MAX partials: out[0] = the last level's
// one sum.
extern "C" int combine_tree_f32(const float* parts, float* out, long long n,
                                int radix, cudaStream_t stream) {
  if (n <= 0 || n > TREE_MAX || radix < 2) return (int)cudaErrorInvalidValue;
  // Raise the shared-memory limit once per device, so that a launch
  // captured into a CUDA graph is a launch and nothing else.
  static unsigned long long configured = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (!(configured >> device & 1ull)) {
    err = cudaFuncSetAttribute(combine_tree_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TREE_MAX * (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    configured |= 1ull << device;
  }
  combine_tree_kernel<<<1, TREE_THREADS, (size_t)n * sizeof(float), stream>>>(
      parts, out, (int)n, radix, segment_width(radix));
  return (int)cudaGetLastError();
}

// The most partials combine_tree_f32 takes.
extern "C" int dotp_tree_max(void) { return TREE_MAX; }

extern "C" const char* dotp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
