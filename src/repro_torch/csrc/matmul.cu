// Skinny GEMM with float32 accumulation: out (M, N) = x (M, K) @ w (K, N).
//
// Replaces the Pallas kernel src/repro/kernels/matmul.py::matmul
// (_mm_kernel), the beamforming product of the 5G pipeline.  Inputs are
// float32 or bfloat16 of one dtype (bfloat16 widens to float32 on its way
// into or out of shared memory); the sums and the output are float32.
//
// Bound: the 5G product is x (32 beams x 64 antennas) against w (64 x
// 57344 sub-carrier columns).  It moves 22.0 MB in float32 (w 14.7 MB,
// out 7.3 MB, x 8 KB): 6.58 us at 3.35 TB/s.  Its 117 M FMAs take 3.5 us
// at 67 TFLOP/s, half the byte time, but an SM can start them only as
// its w lands, so the kernel keeps the FMAs of one k-chunk under the
// loads of the next and out of one another's way.  In bfloat16 the bytes
// fall to 14.7 MB (4.4 us) and the FMAs set the pace.
//
// Design: one block of 128 threads a 32 x 128 output tile, one tile for
// every shape; each warp owns a 32 x 32 slice of the tile and runs on
// its own, with no block-wide barrier while it streams.
//  * A lane owns 8 rows (r, r + 4, ..., r + 28) and 4 adjacent columns
//    (one float4) of its warp's slice: 32 float32 accumulators, and no
//    zero rows at M = 32.
//  * x is read once per block (again for each further 64 k) into a float32
//    panel of 32 x 64 in shared memory, widened from bfloat16 there; its
//    loads go out before w's, so they land first.
//  * Each warp streams its own 32 columns of w through a ring of STAGES =
//    4 shared-memory stages of BK = 16 k, filled by 16-byte cp.async; a
//    warp waits for its own copies (cp.async.wait_group, __syncwarp), so
//    one warp's FMAs never wait for another warp's loads.  The prologue
//    puts three stages in flight and each k-step one more: at K = 64 all
//    of a block's w is requested before its first FMA, and the FMAs of
//    chunk j run while the chunks after it land.  bfloat16 w widens as
//    it leaves shared memory.
//  * Reads from shared memory, per k-step of 4: a lane takes four k of
//    each of its rows as one float4 (the warp's four row groups in other
//    banks, the panel's rows being padded by 16 bytes) and four columns
//    of w at each k as one float4 (the warp reads 128 consecutive bytes):
//    one wavefront each, 12 for 128 FMAs.
//  * Grid: one block a tile, row tiles fastest, so the row tiles of one w
//    strip run side by side and w is read from device memory about once
//    for any M.  At the 5G shape that is 448 blocks: one wave of 3-4 an
//    SM (41 KB of shared memory each), so an SM has up to 128 KB of w in
//    flight, where ~25 KB only just feeds 3.35 TB/s.
//  * The output leaves as float4 streaming stores (__stcs).
//  * A w whose rows are not whole 16-byte packs on an aligned base (N not
//    a multiple of 16 bytes, an offset view) is copied element by element,
//    and an output whose rows are not whole float4s is stored by scalars,
//    in the same kernel: correct, not overlapped.  Rows past M, columns
//    past N and k past K are zeros in shared memory and are not stored.
//  * Every output is one fmaf chain over k = 0, 1, ..., K - 1 in order,
//    in every block and path, so out[:t] of a call equals the call on
//    x[:t], and out[:, :c] the call on w[:, :c], bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;          // rows a tile
constexpr int BN = 128;         // columns a tile
constexpr int WN = 32;          // columns a warp
constexpr int BK = 16;          // k a ring stage
constexpr int STAGES = 4;       // ring depth
constexpr int KP = 64;          // k of the float32 x panel
constexpr int XS = KP + 4;      // the panel's row stride (bank offset)
constexpr int THREADS = 32 * BN / WN;   // 128
constexpr int RG = 32 / (WN / 4);       // a warp's row groups: 4
constexpr int TM = BM / RG;             // rows a lane: 8
constexpr int XPT = BM * KP / THREADS;  // panel elements a thread: 16

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Block b computes rows (b % row_tiles) BM and columns (b / row_tiles) BN.
template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
mm_kernel(const T* __restrict__ x, const T* __restrict__ w,
          float* __restrict__ out, int M, int N, int K, int row_tiles,
          int vec_w, int vec_out) {
  constexpr int V = 16 / (int)sizeof(T);   // elements a 16-byte copy
  __shared__ __align__(16) float xs[BM * XS];                // [row][k]
  __shared__ __align__(16) T ws[THREADS / 32][STAGES][BK * WN];

  const int tid = threadIdx.x;
  const int warp = tid / 32, ln = tid % 32;
  const int cg = ln % (WN / 4);     // columns 4 cg .. 4 cg + 3 of the warp's
  const int rg = ln / (WN / 4);     // rows rg, rg + RG, ...
  const int m0 = (int)(blockIdx.x % row_tiles) * BM;
  const int n0 = (int)(blockIdx.x / row_tiles) * BN + warp * WN;
  const int ktiles = (K + BK - 1) / BK;

  auto load_stage = [&](int kt, int slot) {
    const int k0 = kt * BK;
    T* wd = ws[warp][slot];
    if (vec_w) {
#pragma unroll
      for (int e = ln; e < BK * WN / V; e += 32) {
        const int r = e / (WN / V), c = e % (WN / V) * V;
        const bool in = k0 + r < K && n0 + c < N;
        cp_async16(wd + r * WN + c,
                   in ? w + (long long)(k0 + r) * N + n0 + c : w,
                   in ? 16 : 0);
      }
    } else {
      for (int e = ln; e < BK * WN; e += 32) {
        const int r = e / WN, c = e % WN;
        wd[e] = k0 + r < K && n0 + c < N
                    ? w[(long long)(k0 + r) * N + n0 + c] : T(0.f);
      }
    }
  };

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // The first x panel: its loads go out into registers before w's
  // copies, and land in shared memory as float32 once they arrive.
  {
    T xr[XPT];
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int e = tid + j * THREADS, r = e / KP, c = e % KP;
      xr[j] = m0 + r < M && c < K ? x[(long long)(m0 + r) * K + c] : T(0.f);
    }
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < ktiles) load_stage(s, s);
      cp_async_commit();
    }
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int e = tid + j * THREADS;
      xs[e / KP * XS + e % KP] = to_f32(xr[j]);
    }
  }
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int k0 = kt * BK;
    if (kt > 0 && k0 % KP == 0) {   // the next 64 k of x
      __syncthreads();              // every warp is done with the old panel
#pragma unroll 4
      for (int e = tid; e < BM * KP; e += THREADS) {
        const int r = e / KP, c = k0 + e % KP;
        xs[r * XS + e % KP] =
            m0 + r < M && c < K ? to_f32(x[(long long)(m0 + r) * K + c]) : 0.f;
      }
      __syncthreads();
    }
    cp_async_wait<STAGES - 2>();   // this lane's copies of chunk kt landed
    __syncwarp();                  // the warp's did, and chunk kt - 1 is done
    if (kt + STAGES - 1 < ktiles)
      load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();

    const float* xt = xs + rg * XS + k0 % KP;
    const T* wt = ws[warp][kt % STAGES] + cg * 4;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = load4(xt + i * RG * XS + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b = load4(wt + (kk + q) * WN);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = lane(a[i], q);
          acc[i][0] = fmaf(av, b.x, acc[i][0]);
          acc[i][1] = fmaf(av, b.y, acc[i][1]);
          acc[i][2] = fmaf(av, b.z, acc[i][2]);
          acc[i][3] = fmaf(av, b.w, acc[i][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int gn = n0 + cg * 4;
  if (gn >= N) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + rg + i * RG;
    if (gm >= M) break;
    float* dst = out + (long long)gm * N + gn;
    if (vec_out && gn + 3 < N) {
      __stcs(reinterpret_cast<float4*>(dst),
             make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gn + j < N) __stcs(dst + j, acc[i][j]);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch(const T* x, const T* w, float* out, int M, int N, int K,
           cudaStream_t stream) {
  if (M < 0 || N < 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  // 16-byte copies and stores need rows of whole packs on aligned bases.
  const int vec_w = N % (16 / (int)sizeof(T)) == 0 && aligned16(w);
  const int vec_out = N % 4 == 0 && aligned16(out);
  const int row_tiles = (M + BM - 1) / BM;
  const long long blocks = (long long)row_tiles * ((N + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  mm_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      x, w, out, M, N, K, row_tiles, vec_w, vec_out);
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
