// Flash attention forward: out (B, H, S, D) = softmax(q k^T * scale) v,
// causal or bidirectional, with grouped-query heads.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attn.py::
// flash_attention (_fa_kernel), and on the card computes the LM stack's
// prefill attention (src/repro/models/attention.py::flash_attention, a
// chunked jnp twin of the same function).  q is (B, H, S, D); k and v are
// (B, Hk, T, D) with H a multiple of Hk: query head h reads KV head
// h / (H / Hk), so grouped-query attention needs no repeated copy of K
// and V.  The semantics are the reference's: scores q.k * scale summed in
// float32; causal masking by absolute position (key t is seen by query s
// when t <= s) with the finite score NEG_INF = -1e30, never -inf; a
// running state (acc, m, l) updated tile by tile; p rounded to v's dtype
// before the PV product while l sums the unrounded p; out = acc /
// max(l, 1e-30) in q's dtype.  KV tiles wholly above the diagonal are
// skipped.  One launch covers every (b, h).
//
// Bound: at the serving path's prefill (B = 4, H = 32, Hk = 8, S = T =
// 2048, D = 128, bf16, causal) the two products over the causal half
// take 4 B H D S (S + 1) / 2 = 1.375e11 FLOP, 0.139 ms at the H100's
// 989 TFLOP/s bf16 tensor rate, against 168 MB of traffic (q, k, v read
// once, out written once), 0.050 ms at 3.35 TB/s: the kernel is bound by
// tensor-core operations.
//
// Design.  The TPU kernel walked 512 x 512 VMEM tiles in a sequential
// grid and carried (acc, m, l) in scratch across grid steps.  On Hopper
// the kv loop lives inside the block instead and the state stays in
// registers:
//  * bf16, D in {16, 32, 64, 128} (the path): a block of 4 warps per
//    (b, h, 64-query tile).  Each warp owns 16 query rows; its Q
//    fragments stay in registers for the whole kv loop.  K and V tiles of
//    64 rows are staged in shared memory (16 KB each at D = 128, rows
//    padded by 8 elements so the fragment loads hit 32 distinct banks).
//    QK^T and PV run on the tensor cores as mma.sync m16n8k16 (bf16 in,
//    float32 accumulate); the score accumulator's layout is the PV
//    A-operand's, so p goes from registers to the tensor cores without
//    shared memory.  The row max and row sum are reduced across the four
//    threads of a quad with shuffles.
//  * float32 (true float32, no TF32) and bf16 at D = 8: plain FMAs.  A
//    block of 128 threads takes 32 query rows, four threads a row, each
//    owning every fourth feature; K and V tiles of 32 rows are staged in
//    shared memory as float32, and each score is a quad-shuffle sum.
// Causal blocks are launched heaviest first (the last query tiles have
// the most kv tiles) to even out the tail.  What is left for later:
// wgmma with TMA-fed, double-buffered K/V tiles and warp specialisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (mma.sync m16n8k16).
// ---------------------------------------------------------------------------

constexpr int MMA_BQ = 64;        // query rows per block: 4 warps x 16
constexpr int MMA_BK = 64;        // kv rows per shared-memory tile
constexpr int MMA_THREADS = 128;

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo)
         | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// d += a (16 x 16, row-major) @ b (16 x 8, column-major), float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Two consecutive bf16 of row `row` (zero past the last row) as one word.
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base,
                                              int row, int col, int rows,
                                              int D) {
  if (row >= rows) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + (long long)row * D + col);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
fa_mma_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, int H, int Hk, int S, int T,
              float scale, int causal) {
  constexpr int LD = D + 8;                 // padded shared row (elements)
  constexpr int PACKS = D / 8;              // 16-byte packs per row
  __shared__ __align__(16) __nv_bfloat16 ks[MMA_BK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[MMA_BK * LD];

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = qt * MMA_BQ;
  const int r0 = q0 + warp * 16 + g;        // this thread's rows: r0, r0 + 8
  const int r1 = r0 + 8;

  const __nv_bfloat16* qh = q + ((long long)b * H + h) * S * D;
  const __nv_bfloat16* kh = k + ((long long)b * Hk + hk) * T * D;
  const __nv_bfloat16* vh = v + ((long long)b * Hk + hk) * T * D;

  // Q as A fragments, one per 16-feature step, for the whole kv loop.
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int s = 0; s < D / 16; ++s) {
    const int c = s * 16 + t4 * 2;
    qf[s][0] = load_pair(qh, r0, c, S, D);
    qf[s][1] = load_pair(qh, r1, c, S, D);
    qf[s][2] = load_pair(qh, r0, c + 8, S, D);
    qf[s][3] = load_pair(qh, r1, c + 8, S, D);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int u = 0; u < D / 8; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  const int q_last = min(q0 + MMA_BQ, S) - 1;
  int n_kv = (T + MMA_BK - 1) / MMA_BK;
  if (causal) n_kv = min(n_kv, q_last / MMA_BK + 1);

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * MMA_BK;
    __syncthreads();                        // the previous tile is consumed
    for (int e = threadIdx.x; e < MMA_BK * PACKS; e += MMA_THREADS) {
      const int r = e / PACKS, c = (e % PACKS) * 8;
      uint4 kp = make_uint4(0u, 0u, 0u, 0u), vp = kp;
      if (k0 + r < T) {
        kp = *reinterpret_cast<const uint4*>(kh + (long long)(k0 + r) * D + c);
        vp = *reinterpret_cast<const uint4*>(vh + (long long)(k0 + r) * D + c);
      }
      *reinterpret_cast<uint4*>(ks + r * LD + c) = kp;
      *reinterpret_cast<uint4*>(vs + r * LD + c) = vp;
    }
    __syncthreads();

    // Scores of this warp's 16 rows against the tile's 64 keys.
    float sc[MMA_BK / 8][4];
#pragma unroll
    for (int j = 0; j < MMA_BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int s = 0; s < D / 16; ++s) {
        const __nv_bfloat16* kr = ks + (j * 8 + g) * LD + s * 16 + t4 * 2;
        mma_bf16(sc[j], qf[s], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // Scale and mask: keys past T drop out (-inf, p = 0); causal masking
    // writes the reference's finite NEG_INF.
    float tmax0 = -INFINITY, tmax1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < MMA_BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + t4 * 2 + (e & 1);
        const int row = e < 2 ? r0 : r1;
        float x = sc[j][e] * scale;
        if (col >= T) x = -INFINITY;
        else if (causal && col > row) x = NEG_INF;
        sc[j][e] = x;
        if (e < 2) tmax0 = fmaxf(tmax0, x);
        else tmax1 = fmaxf(tmax1, x);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(tmax0));
    const float mn1 = fmaxf(m1, quad_max(tmax1));
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < MMA_BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[j][e] - (e < 2 ? mn0 : mn1));
        sc[j][e] = p;
        if (e < 2) ps0 += p;
        else ps1 += p;
      }
    }
    l0 = l0 * al0 + quad_sum(ps0);
    l1 = l1 * al1 + quad_sum(ps1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int u = 0; u < D / 8; ++u) {
      acc[u][0] *= al0;
      acc[u][1] *= al0;
      acc[u][2] *= al1;
      acc[u][3] *= al1;
    }

    // acc += bf16(p) @ v: the score accumulators of key columns
    // [16 s, 16 s + 16) are the A fragment of step s.
#pragma unroll
    for (int s = 0; s < MMA_BK / 16; ++s) {
      const uint32_t a[4] = {pack_f32(sc[2 * s][0], sc[2 * s][1]),
                             pack_f32(sc[2 * s][2], sc[2 * s][3]),
                             pack_f32(sc[2 * s + 1][0], sc[2 * s + 1][1]),
                             pack_f32(sc[2 * s + 1][2], sc[2 * s + 1][3])};
#pragma unroll
      for (int u = 0; u < D / 8; ++u) {
        const __nv_bfloat16* vr = vs + (s * 16 + t4 * 2) * LD + u * 8 + g;
        mma_bf16(acc[u], a, pack_bf16(vr[0], vr[LD]),
                 pack_bf16(vr[8 * LD], vr[9 * LD]));
      }
    }
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* oh = o + ((long long)b * H + h) * S * D;
#pragma unroll
  for (int u = 0; u < D / 8; ++u) {
    const int c = u * 8 + t4 * 2;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(oh + (long long)r0 * D + c) =
          pack_f32(acc[u][0] / d0, acc[u][1] / d0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(oh + (long long)r1 * D + c) =
          pack_f32(acc[u][2] / d1, acc[u][3] / d1);
  }
}

// ---------------------------------------------------------------------------
// float32 (and bf16 at D = 8) on plain FMAs.
// ---------------------------------------------------------------------------

constexpr int F_BQ = 32;          // query rows per block, four threads each
constexpr int F_BK = 32;          // kv rows per shared-memory tile
constexpr int F_THREADS = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// p as the PV product sees it: rounded to v's dtype.
__device__ __forceinline__ float as_v(float p, const float*) { return p; }
__device__ __forceinline__ float as_v(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(F_THREADS)
fa_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int H, int Hk,
              int S, int Tk, float scale, int causal) {
  constexpr int DP = D / 4;                 // features per thread
  __shared__ float ks[F_BK][D];
  __shared__ float vs[F_BK][D];

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int part = threadIdx.x % 4;         // features part, part + 4, ...
  const int row = qt * F_BQ + threadIdx.x / 4;

  const T* qh = q + ((long long)b * H + h) * S * D;
  const T* kh = k + ((long long)b * Hk + hk) * Tk * D;
  const T* vh = v + ((long long)b * Hk + hk) * Tk * D;

  float qr[DP], acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = row < S ? to_f32(qh[(long long)row * D + i * 4 + part]) : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  const int q_last = min(qt * F_BQ + F_BQ, S) - 1;
  int n_kv = (Tk + F_BK - 1) / F_BK;
  if (causal) n_kv = min(n_kv, q_last / F_BK + 1);

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * F_BK;
    __syncthreads();
    for (int e = threadIdx.x; e < F_BK * D; e += F_THREADS) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < Tk;
      ks[r][c] = in ? to_f32(kh[(long long)(k0 + r) * D + c]) : 0.f;
      vs[r][c] = in ? to_f32(vh[(long long)(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();

    float s[F_BK];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < F_BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) dot += qr[i] * ks[j][i * 4 + part];
      float x = quad_sum(dot) * scale;
      const int col = k0 + j;
      if (col >= Tk) x = -INFINITY;
      else if (causal && col > row) x = NEG_INF;
      s[j] = x;
      tmax = fmaxf(tmax, x);
    }
    const float mn = fmaxf(m, tmax);
    const float al = expf(m - mn);
    float psum = 0.f, pv[DP];
#pragma unroll
    for (int i = 0; i < DP; ++i) pv[i] = 0.f;
#pragma unroll
    for (int j = 0; j < F_BK; ++j) {
      const float p = expf(s[j] - mn);
      psum += p;
      const float pr = as_v(p, v);
#pragma unroll
      for (int i = 0; i < DP; ++i) pv[i] += pr * vs[j][i * 4 + part];
    }
    l = l * al + psum;
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[i] = acc[i] * al + pv[i];
    m = mn;
  }

  if (row < S) {
    const float den = fmaxf(l, 1e-30f);
    T* orow = o + ((long long)b * H + h) * S * D + (long long)row * D;
#pragma unroll
    for (int i = 0; i < DP; ++i) store(orow + i * 4 + part, acc[i] / den);
  }
}

template <typename T, int D>
int launch_fma(const T* q, const T* k, const T* v, T* o, int B, int H,
               int Hk, int S, int Tk, float scale, int causal,
               cudaStream_t stream) {
  const dim3 grid((S + F_BQ - 1) / F_BQ, H, B);
  fa_fma_kernel<T, D><<<grid, F_THREADS, 0, stream>>>(q, k, v, o, H, Hk, S,
                                                     Tk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, __nv_bfloat16* o, int B, int H,
               int Hk, int S, int Tk, float scale, int causal,
               cudaStream_t stream) {
  const dim3 grid((S + MMA_BQ - 1) / MMA_BQ, H, B);
  fa_mma_kernel<D><<<grid, MMA_THREADS, 0, stream>>>(q, k, v, o, H, Hk, S,
                                                    Tk, scale, causal);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int Hk, int S, int Tk) {
  return B < 0 || S < 0 || Tk < 0 || H <= 0 || Hk <= 0 || H % Hk != 0;
}

}  // namespace

extern "C" int flash_attn_f32(const float* q, const float* k, const float* v,
                              float* o, int B, int H, int Hk, int S, int Tk,
                              int D, float scale, int causal,
                              cudaStream_t stream) {
  if (bad_shape(B, H, Hk, S, Tk)) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  switch (D) {
    case 8: return launch_fma<float, 8>(q, k, v, o, B, H, Hk, S, Tk, scale, causal, stream);
    case 16: return launch_fma<float, 16>(q, k, v, o, B, H, Hk, S, Tk, scale, causal, stream);
    case 32: return launch_fma<float, 32>(q, k, v, o, B, H, Hk, S, Tk, scale, causal, stream);
    case 64: return launch_fma<float, 64>(q, k, v, o, B, H, Hk, S, Tk, scale, causal, stream);
    case 128: return launch_fma<float, 128>(q, k, v, o, B, H, Hk, S, Tk, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_attn_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                               const __nv_bfloat16* v, __nv_bfloat16* o,
                               int B, int H, int Hk, int S, int Tk, int D,
                               float scale, int causal, cudaStream_t stream) {
  if (bad_shape(B, H, Hk, S, Tk)) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  switch (D) {
    case 8: return launch_fma<__nv_bfloat16, 8>(q, k, v, o, B, H, Hk, S, Tk, scale, causal, stream);
    case 16: return launch_mma<16>(q, k, v, o, B, H, Hk, S, Tk, scale, causal, stream);
    case 32: return launch_mma<32>(q, k, v, o, B, H, Hk, S, Tk, scale, causal, stream);
    case 64: return launch_mma<64>(q, k, v, o, B, H, Hk, S, Tk, scale, causal, stream);
    case 128: return launch_mma<128>(q, k, v, o, B, H, Hk, S, Tk, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
