// Row-wise DCT-II: out (T, n) = float32(x) (T, n) @ basis_t (n, n).
//
// Replaces the Pallas kernel src/repro/kernels/dct.py::dct
// (_dct_kernel), the paper's DCT benchmark kernel.  The TPU kernel keeps
// the whole (n, n) basis resident in VMEM and streams 256-row tiles of x
// against it; at n = 4096 the basis is 64 MB, far past a Hopper block's
// 227 KB of shared memory, so here the basis streams through shared
// memory along a k-loop like any GEMM operand.  x is float32, bfloat16
// or float16; the basis and the output are float32, and the sums run in
// float32 FMAs.  No tensor cores: TF32 would change the result.
//
// Bound: at (4096, 4096) operations -- 2 T n^2 = 137 GFLOP against
// (T n + n^2) * 4 + T n * 4 bytes, about 700 flops a byte, so the H100's
// 67 TFLOP/s of float32 outside the tensor cores bounds it (2.05 ms).  At
// the Fig. 5/6 suite's T = 2 rows it is bytes: the 64 MB basis read once,
// 0.020 ms at 3.35 TB/s.
//
// Design: a pipelined float32 GEMM whose block tile follows T.
//  * A ring of STAGES tiles in dynamic shared memory, each an x tile
//    (BM rows x BK, row-major, in x's own dtype) and a basis tile (BK x
//    BN), filled by 16-byte cp.async while the tile STAGES - 1 steps
//    behind is multiplied: one barrier a k-step.  Rows past T and columns
//    past n are zero-filled by the copy.  Rows whose length or base is
//    not a multiple of 16 bytes are copied element by element instead
//    (correct, not overlapped).
//  * Each thread owns a TM x TN register tile: rows ty + i BM/TM (so the
//    threads of a quarter warp read one x row, a broadcast), columns in
//    float4 groups BN/(TN/4) apart (so a quarter warp reads 128
//    consecutive basis bytes, no bank conflict).  Four k of a row come in
//    one 16-byte (or, for 16-bit x, 8-byte) load and widen to float32 in
//    registers.
//  * The tile follows T, one tile for each row count the path runs:
//    128 x 256 (256 threads, 8 x 16 each, one block an SM, k steps of 32)
//    where that grid is three waves or more (the timed 4096 rows); else
//    64 x 64 (two blocks an SM) above 64 rows (the suite's 256 rows: 256
//    blocks); 64 x 32 for T <= 64 and 16 x 32 for T <= 16 (the suite's 64
//    and 2 rows: 128 blocks; at 2 rows the basis streams in 64 x 32
//    tiles, four deep).  Blocks of one basis
//    column tile are adjacent in launch order (grid x is the row tile),
//    so the basis is read from device memory about once whatever the row
//    tiles.
//  * No split-K: every output is one fmaf chain over k = 0, 1, ..., n - 1
//    in order, in every tiling, so a row's bits do not depend on T or
//    the tile chosen (dct(x)[:2] equals dct(x[:2])).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, asynchronously; src_bytes = 0
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four consecutive elements of a shared-memory row as float32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// A block tile: BM x BN outputs, k steps of BK, a ring of STAGES tiles;
// each thread a TM x TN register tile; at least MIN_BLOCKS blocks an SM
// (two cap a thread at 128 registers).
template <int BM_, int BN_, int TM_, int TN_, int BK_, int STAGES_,
          int MIN_BLOCKS_ = 2>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, BK = BK_;
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int COLS = BN / TN;          // threads along a row
  static constexpr int THREADS = (BM / TM) * COLS;
  static constexpr int GROUPS = TN / 4;         // a thread's float4 columns
  static constexpr int GAP = BN / GROUPS;       // columns between them
  template <typename T>
  static constexpr int smem_bytes() {
    return STAGES * (BM * BK * (int)sizeof(T) + BK * BN * 4);
  }
};

// Each chosen, among a few, by its time at the suite's shapes on the H100.
using Wide = Tile<128, 256, 8, 16, 32, 3, 1>;  // 256 threads, many blocks
using Mid = Tile<64, 64, 4, 4, 32, 4>;       // 256 threads, T > 64
using Rows64 = Tile<64, 32, 4, 4, 32, 4>;    // 128 threads, T <= 64
using Rows16 = Tile<16, 32, 2, 4, 64, 4>;    // 64 threads, T <= 16

template <typename T, typename C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
dct_kernel(const T* __restrict__ x, const float* __restrict__ basis_t,
           float* __restrict__ out, int rows, int n, int vec) {
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, TM = C::TM;
  constexpr int TN = C::TN, STAGES = C::STAGES, THREADS = C::THREADS;
  constexpr int XV = 16 / (int)sizeof(T);       // x elements a copy
  extern __shared__ __align__(16) uint8_t dct_smem[];
  T* xs = reinterpret_cast<T*>(dct_smem);                      // [S][BM][BK]
  float* bs = reinterpret_cast<float*>(
      dct_smem + STAGES * BM * BK * (int)sizeof(T));           // [S][BK][BN]

  const int tid = threadIdx.x;
  const int tx = tid % C::COLS, ty = tid / C::COLS;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ktiles = (n + BK - 1) / BK;

  auto load_tile = [&](int kt, int slot) {
    const int k0 = kt * BK;
    T* xd = xs + slot * BM * BK;
    float* bd = bs + slot * BK * BN;
    if (vec) {
#pragma unroll
      for (int e = tid; e < BM * BK / XV; e += THREADS) {
        const int r = e / (BK / XV), c = e % (BK / XV) * XV;
        const bool in = m0 + r < rows && k0 + c < n;
        cp_async16(xd + r * BK + c,
                   in ? x + (long long)(m0 + r) * n + k0 + c : x,
                   in ? 16 : 0);
      }
#pragma unroll
      for (int e = tid; e < BK * BN / 4; e += THREADS) {
        const int r = e / (BN / 4), c = e % (BN / 4) * 4;
        const bool in = k0 + r < n && n0 + c < n;
        cp_async16(bd + r * BN + c,
                   in ? basis_t + (long long)(k0 + r) * n + n0 + c : basis_t,
                   in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, c = e % BK;
        xd[r * BK + c] = m0 + r < rows && k0 + c < n
                             ? x[(long long)(m0 + r) * n + k0 + c] : T(0.f);
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int r = e / BN, c = e % BN;
        bd[r * BN + c] = k0 + r < n && n0 + c < n
                             ? basis_t[(long long)(k0 + r) * n + n0 + c] : 0.f;
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of tile kt landed
    __syncthreads();               // everyone's did, and tile kt - 1 is done
    if (kt + STAGES - 1 < ktiles)
      load_tile(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();

    const T* xt = xs + kt % STAGES * BM * BK;
    const float* bt = bs + kt % STAGES * BK * BN;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = load4(xt + (ty + i * (BM / TM)) * BK + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float b[TN];
#pragma unroll
        for (int g = 0; g < C::GROUPS; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(
              bt + (kk + q) * BN + g * C::GAP + tx * 4);
          b[4 * g] = v.x;
          b[4 * g + 1] = v.y;
          b[4 * g + 2] = v.z;
          b[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = lane(a[i], q);
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * (BM / TM);
    if (gm >= rows) continue;
#pragma unroll
    for (int g = 0; g < C::GROUPS; ++g) {
      const int gn = n0 + g * C::GAP + tx * 4;
      float* dst = out + (long long)gm * n + gn;
      if (vec && gn + 3 < n) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                        acc[i][4 * g + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (gn + e < n) dst[e] = acc[i][4 * g + e];
      }
    }
  }
}

template <typename T, typename C>
int launch_tile(const T* x, const float* basis_t, float* out, int rows,
                int n, int vec, cudaStream_t stream) {
  constexpr int smem = C::template smem_bytes<T>();
  // Past 48 KB the limit is raised once per device, so that a launch
  // captured into a CUDA graph is a launch and nothing else.
  static unsigned long long configured = 0;
  if (smem > 48 * 1024) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    if (!(configured >> device & 1ull)) {
      err = cudaFuncSetAttribute(dct_kernel<T, C>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return (int)err;
      configured |= 1ull << device;
    }
  }
  const dim3 grid((rows + C::BM - 1) / C::BM, (n + C::BN - 1) / C::BN);
  dct_kernel<T, C><<<grid, C::THREADS, smem, stream>>>(x, basis_t, out, rows,
                                                       n, vec);
  return (int)cudaGetLastError();
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess
        || cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                  device) != cudaSuccess)
      count = 132;
  }
  return count;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch(const T* x, const float* basis_t, float* out, int rows, int n,
           cudaStream_t stream) {
  if (rows < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return 0;
  // 16-byte copies need rows of whole 16-byte packs on aligned bases.
  const int vec = n % (16 / (int)sizeof(T)) == 0 && n % 4 == 0
                  && aligned16(x) && aligned16(basis_t) && aligned16(out);
  if (rows <= 16)
    return launch_tile<T, Rows16>(x, basis_t, out, rows, n, vec, stream);
  if (rows <= 64)
    return launch_tile<T, Rows64>(x, basis_t, out, rows, n, vec, stream);
  auto blocks = [&](int bm, int bn) {
    return (long long)((rows + bm - 1) / bm) * ((n + bn - 1) / bn);
  };
  // One Wide block an SM pays only over several waves.
  if (blocks(Wide::BM, Wide::BN) >= 3 * sm_count())
    return launch_tile<T, Wide>(x, basis_t, out, rows, n, vec, stream);
  return launch_tile<T, Mid>(x, basis_t, out, rows, n, vec, stream);
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
