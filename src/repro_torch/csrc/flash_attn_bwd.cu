// Flash attention backward: the gradients dQ, dK and dV of the forward of
// csrc/flash_attn.cu, out (B, H, S, D) = softmax(q k^T * scale) v, causal
// or bidirectional, with grouped-query heads and strided operands.
//
// Replaces no Pallas kernel of its own: the reference trains through JAX's
// autodiff of its jnp chunked attention (src/repro/models/attention.py:86
// flash_attention, the same function as the Pallas kernel
// src/repro/kernels/flash_attn.py:73, which has no backward).  On the card
// the port's forward is the hand-written kernel, so its gradient is one
// too.  q, out and dO are (B, H, S, D), k and v (B, Hk, T, D) with H a
// multiple of Hk (query head h reads KV head h / (H / Hk)); lse (B, H, S)
// is the forward's row log-sum-exp of the scaled scores and delta (B, H,
// S) a float32 scratch.  With P = exp(q k^T * scale - lse) (exactly the
// forward's normalised softmax; masked and out-of-range keys give p = 0):
//
//   delta_i = sum_f dO_if O_if                 (pre-pass, bwd_delta_kernel)
//   dS_ij   = P_ij (dO_i . v_j - delta_i)
//   dV_j    = sum_i P_ij dO_i                  (P rounded to v's dtype, as
//                                              the forward's PV product)
//   dK_j    = scale sum_i dS_ij q_i
//   dQ_i    = scale sum_j dS_ij k_j
//
// in the FlashAttention-2 form: one kernel per (batch, KV head, key tile)
// recomputes P from lse tile by tile, accumulates dK and dV in registers
// over every query tile and over the H / Hk query heads of its group, and
// writes them once; one kernel per (batch, head, query tile) recomputes P
// and accumulates dQ.  No atomics: two runs give the same bits.  Pairs (D,
// D) for D in {8, 16, 32, 40, 64, 80, 128, 192}; no window and no (D, Dv) pair
// with Dv != D (the wrapper refuses both before any launch).
//
// Bound: at Qwen3-4B's training shape (B = 1, H = 32, Hk = 8, S = T =
// 2048, D = 128, bf16, causal) the five products (S = QK^T and dP = dO V^T
// recomputed, dV, dK, dQ) take 5 * 2 B H S T D / 2 = 8.6e10 FLOP over the
// causal half, 0.087 ms at the H100's 989 TFLOP/s bf16 tensor rate,
// against 42 MB of traffic (q, k, v, out, dO, lse read once, dq, dk, dv
// written once), 0.013 ms at 3.35 TB/s: bound by tensor-core operations.
//
// Design.  Two kernel families:
//  * bf16 with D a multiple of 16: mma.sync m16n8k16 (bf16 in, float32
//    sums).  Blocks of 4 warps own 64 rows of their side (keys in
//    bwd_dkdv_mma, queries in bwd_dq_mma), 16 a warp; the other side comes
//    in 64-row tiles through shared memory (rows padded by 8 elements) and
//    is walked 16 rows at a time, so a warp's score tiles are 16 x 16 and
//    its registers hold only its dK and dV (or dQ) accumulators.  The
//    accumulators of S^T and dP^T become, after the elementwise step, the
//    A fragments of the dV and dK products (the layout of two 8-column
//    accumulator tiles is an A fragment's), as the forward's P does for
//    PV; the B operands that run along a tile's rows are gathered from
//    shared memory two elements at a time.  Under causal masking a block
//    starts at the first query tile that sees its keys (dK/dV) or stops at
//    the last key tile its queries see (dQ), and a warp skips a 16-row step
//    wholly above the diagonal.
//  * float32 (true float32 FMAs, no TF32) and bf16 at D = 8 and 40: 32 x 32
//    tiles of 128 threads in float32 shared memory (rows padded by one
//    float); a thread computes 8 scores and their dS, the block writes P
//    and dS to shared memory, then each thread accumulates D / 4 elements
//    of dK and dV (or dQ) over the tile.
// What is left for later: wgmma and TMA, as the forward has, a persistent
// grid that balances the causal triangle's long and short key tiles, and
// dQ accumulated beside dK/dV instead of recomputing P a second time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 128;      // 4 warps
constexpr int BM = 64;            // mma kernels: a block's rows, 16 a warp
constexpr int SUB = 16;           // mma kernels: other-side rows a step
constexpr int FB = 32;            // FMA kernels: rows of each side a tile

// Element strides (batch, head, row) of one operand.
struct Layout {
  long long b, h, s;
};

struct Layouts {
  Layout q, k, v, o, dout, dq, dk, dv;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(bf16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// p as the forward's PV product saw it: rounded to v's dtype.
__device__ __forceinline__ float as_v(float p, const float*) { return p; }
__device__ __forceinline__ float as_v(float p, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O), one warp a row.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, Layouts st, int H, int S, int D,
                 long long rows) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                     // the whole warp
  const int s = (int)(row % S);
  const long long bh = row / S;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const T* orow = o + b * st.o.b + h * st.o.h + s * st.o.s;
  const T* drow = dout + b * st.dout.b + h * st.dout.h + s * st.dout.s;
  float acc = 0.f;
  for (int f = lane; f < D; f += 32)
    acc = fmaf(to_f32(orow[f]), to_f32(drow[f]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// bf16 on mma.sync m16n8k16, D a multiple of 16.
// ---------------------------------------------------------------------------

// Q, dO, K and V tiles of 64 padded rows, then lse and delta of 64 rows.
template <int D>
constexpr int mma_smem_bytes() {
  return 4 * BM * (D + 8) * 2 + 2 * BM * 4;
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo)
         | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// The A fragment of rows r0 .. r0 + 15 and columns c0 .. c0 + 15 of a
// shared tile with rows of LD elements.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t,
                                       int r0, int c0, int g, int t4) {
  const bf16* p = t + (r0 + g) * LD + c0 + t4 * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// The B fragment whose 8 columns are tile rows n0 .. n0 + 7 and whose 16
// k steps are tile columns c0 .. c0 + 15 (B = tile^T).
template <int LD>
__device__ __forceinline__ void frag_b_rows(uint32_t& b0, uint32_t& b1,
                                            const bf16* t, int n0, int c0,
                                            int g, int t4) {
  const bf16* p = t + (n0 + g) * LD + c0 + t4 * 2;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// The B fragment of tile rows k0 .. k0 + 15 (its k steps) and columns
// n0 .. n0 + 7 (B = the tile itself), gathered two elements at a time.
template <int LD>
__device__ __forceinline__ void frag_b_cols(uint32_t& b0, uint32_t& b1,
                                            const bf16* t, int k0, int n0,
                                            int g, int t4) {
  const bf16* p = t + (k0 + t4 * 2) * LD + n0 + g;
  b0 = pack_bf16(p[0], p[LD]);
  b1 = pack_bf16(p[8 * LD], p[9 * LD]);
}

// Rows row0 .. row0 + 63 of a (rows, D) operand with row stride `stride`
// into a padded shared tile, 16 bytes a copy; rows past the end are zeros.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0,
                                          int rows) {
  constexpr int LD = D + 8, PACKS = D / 8;
  for (int e = threadIdx.x; e < BM * PACKS; e += THREADS) {
    const int r = e / PACKS, c = (e % PACKS) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows)
      x = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = x;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dk, bf16* __restrict__ dv, Layouts st, int H,
             int Hk, int S, int T, float scale, int causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + BM * LD;
  bf16* qs = vs + BM * LD;
  bf16* ds = qs + BM * LD;                               // dO
  float* ls = reinterpret_cast<float*>(ds + BM * LD);    // lse * log2(e)
  float* es = ls + BM;                                   // delta

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int k0 = kt * BM, kw = warp * 16;   // the warp's keys k0 + kw + 0..15
  const float sl2 = scale * LOG2E;

  load_tile<D>(ks, k + b * st.k.b + hk * st.k.h, st.k.s, k0, T);
  load_tile<D>(vs, v + b * st.v.b + hk * st.v.h, st.v.s, k0, T);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int u = 0; u < D / 8; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[u][e] = dva[u][e] = 0.f;

  const int G = H / Hk;
  const int n_qt = (S + BM - 1) / BM;
  const int qt0 = causal ? k0 / BM : 0;     // queries before k0 see no key
#pragma unroll 1
  for (int hh = 0; hh < G; ++hh) {
    const int h = hk * G + hh;
    const bf16* qh = q + b * st.q.b + h * st.q.h;
    const bf16* doh = dout + b * st.dout.b + h * st.dout.h;
    const float* lh = lse + ((long long)b * H + h) * S;
    const float* eh = delta + ((long long)b * H + h) * S;
#pragma unroll 1
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BM;
      __syncthreads();                      // the previous tiles are read
      load_tile<D>(qs, qh, st.q.s, q0, S);
      load_tile<D>(ds, doh, st.dout.s, q0, S);
      if (threadIdx.x < BM) {
        const int r = q0 + threadIdx.x;
        ls[threadIdx.x] = r < S ? lh[r] * LOG2E : 0.f;
        es[threadIdx.x] = r < S ? eh[r] : 0.f;
      }
      __syncthreads();
#pragma unroll 1
      for (int sub = 0; sub < BM / SUB; ++sub) {
        const int qs0 = sub * SUB;
        // Every key of the warp after every query of the step: p = 0.
        if (causal && q0 + qs0 + SUB - 1 < k0 + kw) continue;
        // S^T = K Q^T and dP^T = V dO^T: 16 keys x 16 queries.
        float sa[2][4], pa[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sa[n][e] = pa[n][e] = 0.f;
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          uint32_t ak[4], av[4];
          frag_a<LD>(ak, ks, kw, c * 16, g, t4);
          frag_a<LD>(av, vs, kw, c * 16, g, t4);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            uint32_t b0, b1;
            frag_b_rows<LD>(b0, b1, qs, qs0 + n * 8, c * 16, g, t4);
            mma_bf16(sa[n], ak, b0, b1);
            frag_b_rows<LD>(b0, b1, ds, qs0 + n * 8, c * 16, g, t4);
            mma_bf16(pa[n], av, b0, b1);
          }
        }
        // P^T and dS^T in place.
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + kw + g + (e >= 2 ? 8 : 0);
            const int qi = qs0 + n * 8 + t4 * 2 + (e & 1);
            const int row = q0 + qi;
            const bool keep = key < T && row < S && (!causal || key <= row);
            const float p = keep ? exp2f(fmaf(sa[n][e], sl2, -ls[qi])) : 0.f;
            pa[n][e] = p * (pa[n][e] - es[qi]);
            sa[n][e] = p;
          }
        // dV += bf16(P^T) dO and dK += bf16(dS^T) Q over the 16 queries.
        const uint32_t pf[4] = {pack_f32(sa[0][0], sa[0][1]),
                                pack_f32(sa[0][2], sa[0][3]),
                                pack_f32(sa[1][0], sa[1][1]),
                                pack_f32(sa[1][2], sa[1][3])};
        const uint32_t df[4] = {pack_f32(pa[0][0], pa[0][1]),
                                pack_f32(pa[0][2], pa[0][3]),
                                pack_f32(pa[1][0], pa[1][1]),
                                pack_f32(pa[1][2], pa[1][3])};
#pragma unroll
        for (int u = 0; u < D / 8; ++u) {
          uint32_t b0, b1;
          frag_b_cols<LD>(b0, b1, ds, qs0, u * 8, g, t4);
          mma_bf16(dva[u], pf, b0, b1);
          frag_b_cols<LD>(b0, b1, qs, qs0, u * 8, g, t4);
          mma_bf16(dka[u], df, b0, b1);
        }
      }
    }
  }

  bf16* dkh = dk + b * st.dk.b + hk * st.dk.h;
  bf16* dvh = dv + b * st.dv.b + hk * st.dv.h;
  const int r0 = k0 + kw + g, r1 = r0 + 8;
#pragma unroll
  for (int u = 0; u < D / 8; ++u) {
    const int c = u * 8 + t4 * 2;
    if (r0 < T) {
      *reinterpret_cast<uint32_t*>(dkh + r0 * st.dk.s + c) =
          pack_f32(dka[u][0] * scale, dka[u][1] * scale);
      *reinterpret_cast<uint32_t*>(dvh + r0 * st.dv.s + c) =
          pack_f32(dva[u][0], dva[u][1]);
    }
    if (r1 < T) {
      *reinterpret_cast<uint32_t*>(dkh + r1 * st.dk.s + c) =
          pack_f32(dka[u][2] * scale, dka[u][3] * scale);
      *reinterpret_cast<uint32_t*>(dvh + r1 * st.dv.s + c) =
          pack_f32(dva[u][2], dva[u][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dq, Layouts st, int H, int Hk, int S, int T,
           float scale, int causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ds = qs + BM * LD;                               // dO
  bf16* ks = ds + BM * LD;
  bf16* vs = ks + BM * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;      // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = qt * BM, qw = warp * 16;
  const int r0 = q0 + qw + g, r1 = r0 + 8;  // this thread's query rows
  const float sl2 = scale * LOG2E;

  load_tile<D>(qs, q + b * st.q.b + h * st.q.h, st.q.s, q0, S);
  load_tile<D>(ds, dout + b * st.dout.b + h * st.dout.h, st.dout.s, q0, S);
  const float* lh = lse + ((long long)b * H + h) * S;
  const float* eh = delta + ((long long)b * H + h) * S;
  const float l0 = r0 < S ? lh[r0] * LOG2E : 0.f;
  const float l1 = r1 < S ? lh[r1] * LOG2E : 0.f;
  const float e0 = r0 < S ? eh[r0] : 0.f, e1 = r1 < S ? eh[r1] : 0.f;
  const bf16* kh = k + b * st.k.b + hk * st.k.h;
  const bf16* vh = v + b * st.v.b + hk * st.v.h;

  float dqa[D / 8][4];
#pragma unroll
  for (int u = 0; u < D / 8; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[u][e] = 0.f;

  int n_kt = (T + BM - 1) / BM;
  if (causal) n_kt = min(n_kt, (min(q0 + BM, S) - 1) / BM + 1);
#pragma unroll 1
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BM;
    __syncthreads();                        // the previous K and V are read
    load_tile<D>(ks, kh, st.k.s, k0, T);
    load_tile<D>(vs, vh, st.v.s, k0, T);
    __syncthreads();
#pragma unroll 1
    for (int sub = 0; sub < BM / SUB; ++sub) {
      const int ks0 = sub * SUB;
      // Every key of the step after every query of the warp: p = 0.
      if (causal && k0 + ks0 > q0 + qw + 15) continue;
      // S = Q K^T and dP = dO V^T: 16 queries x 16 keys.
      float sa[2][4], pa[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[n][e] = pa[n][e] = 0.f;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        uint32_t aq[4], ad[4];
        frag_a<LD>(aq, qs, qw, c * 16, g, t4);
        frag_a<LD>(ad, ds, qw, c * 16, g, t4);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          uint32_t b0, b1;
          frag_b_rows<LD>(b0, b1, ks, ks0 + n * 8, c * 16, g, t4);
          mma_bf16(sa[n], aq, b0, b1);
          frag_b_rows<LD>(b0, b1, vs, ks0 + n * 8, c * 16, g, t4);
          mma_bf16(pa[n], ad, b0, b1);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? r0 : r1;
          const int key = k0 + ks0 + n * 8 + t4 * 2 + (e & 1);
          const bool keep = row < S && key < T && (!causal || key <= row);
          const float p =
              keep ? exp2f(fmaf(sa[n][e], sl2, -(e < 2 ? l0 : l1))) : 0.f;
          pa[n][e] = p * (pa[n][e] - (e < 2 ? e0 : e1));
        }
      // dQ += bf16(dS) K over the 16 keys.
      const uint32_t df[4] = {pack_f32(pa[0][0], pa[0][1]),
                              pack_f32(pa[0][2], pa[0][3]),
                              pack_f32(pa[1][0], pa[1][1]),
                              pack_f32(pa[1][2], pa[1][3])};
#pragma unroll
      for (int u = 0; u < D / 8; ++u) {
        uint32_t b0, b1;
        frag_b_cols<LD>(b0, b1, ks, ks0, u * 8, g, t4);
        mma_bf16(dqa[u], df, b0, b1);
      }
    }
  }

  bf16* dqh = dq + b * st.dq.b + h * st.dq.h;
#pragma unroll
  for (int u = 0; u < D / 8; ++u) {
    const int c = u * 8 + t4 * 2;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(dqh + r0 * st.dq.s + c) =
          pack_f32(dqa[u][0] * scale, dqa[u][1] * scale);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(dqh + r1 * st.dq.s + c) =
          pack_f32(dqa[u][2] * scale, dqa[u][3] * scale);
  }
}

// ---------------------------------------------------------------------------
// float32 (and bf16 at D = 8 and 40) on FMAs.
// ---------------------------------------------------------------------------

// Four tiles of 32 rows of D floats (rows padded by one float), two 32 x 32
// score tiles (padded likewise), lse and delta of 32 rows.
template <int D>
struct FmaShape {
  static constexpr int LD = D + 1;
  static constexpr int LP = FB + 1;
  static constexpr int E = FB * D / THREADS;   // accumulators a thread
  static constexpr int SMEM = (4 * FB * LD + 2 * FB * LP + 2 * FB) * 4;
  static_assert(FB * D % THREADS == 0, "whole accumulators a thread");
};

template <typename T, int D>
__device__ __forceinline__ void load_tile_f(float* dst, const T* src,
                                            long long stride, int row0,
                                            int rows) {
  for (int e = threadIdx.x; e < FB * D; e += THREADS) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] =
        row0 + r < rows ? to_f32(src[(row0 + r) * stride + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_fma(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dk, T* __restrict__ dv, Layouts st, int H,
             int Hk, int S, int Tk, float scale, int causal) {
  using F = FmaShape<D>;
  constexpr int LD = F::LD, LP = F::LP, E = F::E;
  extern __shared__ __align__(16) uint8_t smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + FB * LD;
  float* qs = vs + FB * LD;
  float* ds = qs + FB * LD;                 // dO
  float* pt = ds + FB * LD;                 // P^T [key][query], as v's dtype
  float* dst = pt + FB * LP;                // dS^T [key][query]
  float* ls = dst + FB * LP;
  float* es = ls + FB;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * FB;
  // Scores: key `me` against queries 8 part .. 8 part + 7.
  const int me = threadIdx.x % FB, part = threadIdx.x / FB;
  load_tile_f<T, D>(ks, k + b * st.k.b + hk * st.k.h, st.k.s, k0, Tk);
  load_tile_f<T, D>(vs, v + b * st.v.b + hk * st.v.h, st.v.s, k0, Tk);

  float dka[E], dva[E];
#pragma unroll
  for (int e = 0; e < E; ++e) dka[e] = dva[e] = 0.f;

  const int G = H / Hk;
  const int n_qt = (S + FB - 1) / FB;
  const int qt0 = causal ? k0 / FB : 0;
#pragma unroll 1
  for (int hh = 0; hh < G; ++hh) {
    const int h = hk * G + hh;
    const T* qh = q + b * st.q.b + h * st.q.h;
    const T* doh = dout + b * st.dout.b + h * st.dout.h;
    const float* lh = lse + ((long long)b * H + h) * S;
    const float* eh = delta + ((long long)b * H + h) * S;
#pragma unroll 1
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * FB;
      __syncthreads();                      // the previous tiles are read
      load_tile_f<T, D>(qs, qh, st.q.s, q0, S);
      load_tile_f<T, D>(ds, doh, st.dout.s, q0, S);
      if (threadIdx.x < FB) {
        const int r = q0 + threadIdx.x;
        ls[threadIdx.x] = r < S ? lh[r] : 0.f;
        es[threadIdx.x] = r < S ? eh[r] : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < 8; ++i) {
        const int qi = part * 8 + i, row = q0 + qi, key = k0 + me;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int f = 0; f < D; ++f) {
          s = fmaf(ks[me * LD + f], qs[qi * LD + f], s);
          dp = fmaf(vs[me * LD + f], ds[qi * LD + f], dp);
        }
        const bool keep = key < Tk && row < S && (!causal || key <= row);
        const float p = keep ? expf(s * scale - ls[qi]) : 0.f;
        pt[me * LP + qi] = as_v(p, v);
        dst[me * LP + qi] = p * (dp - es[qi]);
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int idx = threadIdx.x + THREADS * e;
        const int key = idx / D, f = idx % D;
        float a = dva[e], c = dka[e];
#pragma unroll 8
        for (int qi = 0; qi < FB; ++qi) {
          a = fmaf(pt[key * LP + qi], ds[qi * LD + f], a);
          c = fmaf(dst[key * LP + qi], qs[qi * LD + f], c);
        }
        dva[e] = a;
        dka[e] = c;
      }
    }
  }

  T* dkh = dk + b * st.dk.b + hk * st.dk.h;
  T* dvh = dv + b * st.dv.b + hk * st.dv.h;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = threadIdx.x + THREADS * e;
    const int key = k0 + idx / D, f = idx % D;
    if (key < Tk) {
      store(dkh + key * st.dk.s + f, dka[e] * scale);
      store(dvh + key * st.dv.s + f, dva[e]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_fma(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dq, Layouts st, int H, int Hk, int S, int Tk,
           float scale, int causal) {
  using F = FmaShape<D>;
  constexpr int LD = F::LD, LP = F::LP, E = F::E;
  extern __shared__ __align__(16) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ds = qs + FB * LD;                 // dO
  float* ks = ds + FB * LD;
  float* vs = ks + FB * LD;
  float* dss = vs + FB * LD;                // dS [query][key]
  float* ls = dss + 2 * FB * LP;
  float* es = ls + FB;

  const int qt = gridDim.x - 1 - blockIdx.x;      // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int q0 = qt * FB;
  // Scores: query `me` against keys 8 part .. 8 part + 7.
  const int me = threadIdx.x % FB, part = threadIdx.x / FB;
  load_tile_f<T, D>(qs, q + b * st.q.b + h * st.q.h, st.q.s, q0, S);
  load_tile_f<T, D>(ds, dout + b * st.dout.b + h * st.dout.h, st.dout.s, q0,
                    S);
  if (threadIdx.x < FB) {
    const int r = q0 + threadIdx.x;
    const long long bh = (long long)b * H + h;
    ls[threadIdx.x] = r < S ? lse[bh * S + r] : 0.f;
    es[threadIdx.x] = r < S ? delta[bh * S + r] : 0.f;
  }
  const T* kh = k + b * st.k.b + hk * st.k.h;
  const T* vh = v + b * st.v.b + hk * st.v.h;

  float dqa[E];
#pragma unroll
  for (int e = 0; e < E; ++e) dqa[e] = 0.f;

  int n_kt = (Tk + FB - 1) / FB;
  if (causal) n_kt = min(n_kt, (min(q0 + FB, S) - 1) / FB + 1);
#pragma unroll 1
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * FB;
    __syncthreads();                        // the previous K, V, dS are read
    load_tile_f<T, D>(ks, kh, st.k.s, k0, Tk);
    load_tile_f<T, D>(vs, vh, st.v.s, k0, Tk);
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < 8; ++i) {
      const int kj = part * 8 + i, key = k0 + kj, row = q0 + me;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int f = 0; f < D; ++f) {
        s = fmaf(qs[me * LD + f], ks[kj * LD + f], s);
        dp = fmaf(ds[me * LD + f], vs[kj * LD + f], dp);
      }
      const bool keep = row < S && key < Tk && (!causal || key <= row);
      const float p = keep ? expf(s * scale - ls[me]) : 0.f;
      dss[me * LP + kj] = p * (dp - es[me]);
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int idx = threadIdx.x + THREADS * e;
      const int qr = idx / D, f = idx % D;
      float c = dqa[e];
#pragma unroll 8
      for (int kj = 0; kj < FB; ++kj)
        c = fmaf(dss[qr * LP + kj], ks[kj * LD + f], c);
      dqa[e] = c;
    }
  }

  T* dqh = dq + b * st.dq.b + h * st.dq.h;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = threadIdx.x + THREADS * e;
    const int row = q0 + idx / D, f = idx % D;
    if (row < S) store(dqh + row * st.dq.s + f, dqa[e] * scale);
  }
}

// ---------------------------------------------------------------------------
// Launches.
// ---------------------------------------------------------------------------

// Let `kernel` take `bytes` of dynamic shared memory: past the default
// 48 KB the limit is raised, once per device (`configured` holds a bit per
// device), so that a launch captured into a CUDA graph is a launch and
// nothing else.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes,
                       unsigned long long* configured) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (*configured >> device & 1ull)) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) *configured |= 1ull << device;
  return err;
}

template <typename T>
struct Args {
  const T *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  T *dq, *dk, *dv;
  Layouts st;
  int B, H, Hk, S, Tk, D;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T>
int launch_delta(const Args<T>& a) {
  const long long rows = (long long)a.B * a.H * a.S;
  const long long blocks = (rows + 7) / 8;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  bwd_delta_kernel<T><<<(unsigned)blocks, 256, 0, a.stream>>>(
      a.o, a.dout, a.delta, a.st, a.H, a.S, a.D, rows);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const Args<bf16>& a) {
  static unsigned long long kv_configured = 0, q_configured = 0;
  constexpr int smem = mma_smem_bytes<D>();
  cudaError_t err = allow_smem(bwd_dkdv_mma<D>, smem, &kv_configured);
  if (err == cudaSuccess) err = allow_smem(bwd_dq_mma<D>, smem,
                                           &q_configured);
  if (err != cudaSuccess) return (int)err;
  int rc = launch_delta(a);
  if (rc) return rc;
  bwd_dkdv_mma<D><<<dim3((a.Tk + BM - 1) / BM, a.Hk, a.B), THREADS, smem,
                    a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk,
                                a.dv, a.st, a.H, a.Hk, a.S, a.Tk, a.scale,
                                a.causal);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  bwd_dq_mma<D><<<dim3((a.S + BM - 1) / BM, a.H, a.B), THREADS, smem,
                  a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq,
                              a.st, a.H, a.Hk, a.S, a.Tk, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_fma(const Args<T>& a) {
  static unsigned long long kv_configured = 0, q_configured = 0;
  constexpr int smem = FmaShape<D>::SMEM;
  cudaError_t err = allow_smem(bwd_dkdv_fma<T, D>, smem, &kv_configured);
  if (err == cudaSuccess) err = allow_smem(bwd_dq_fma<T, D>, smem,
                                           &q_configured);
  if (err != cudaSuccess) return (int)err;
  int rc = launch_delta(a);
  if (rc) return rc;
  bwd_dkdv_fma<T, D><<<dim3((a.Tk + FB - 1) / FB, a.Hk, a.B), THREADS, smem,
                       a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta,
                                   a.dk, a.dv, a.st, a.H, a.Hk, a.S, a.Tk,
                                   a.scale, a.causal);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  bwd_dq_fma<T, D><<<dim3((a.S + FB - 1) / FB, a.H, a.B), THREADS, smem,
                     a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq,
                                 a.st, a.H, a.Hk, a.S, a.Tk, a.scale,
                                 a.causal);
  return (int)cudaGetLastError();
}

Layouts layouts_from(const long long* s) {
  Layouts st;
  Layout* l[8] = {&st.q, &st.k, &st.v, &st.o, &st.dout, &st.dq, &st.dk,
                  &st.dv};
  for (int i = 0; i < 8; ++i) *l[i] = Layout{s[3 * i], s[3 * i + 1],
                                             s[3 * i + 2]};
  return st;
}

template <typename T>
bool fill(Args<T>& a, const T* q, const T* k, const T* v, const T* o,
          const T* dout, const float* lse, float* delta, T* dq, T* dk,
          T* dv, const long long* strides, int B, int H, int Hk, int S,
          int Tk, int D, float scale, int causal, cudaStream_t stream) {
  a = Args<T>{q, k, v, o, dout, lse, delta, dq, dk, dv,
              layouts_from(strides), B, H, Hk, S, Tk, D, scale, causal,
              stream};
  // Heads and batch rows run on the grid's y and z axes.
  return !(B <= 0 || S <= 0 || Tk <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0
           || H > 65535 || B > 65535);
}

}  // namespace

// strides: 24 element strides (batch, head, row) of q, k, v, out, dout, dq,
// dk, dv.  lse: the forward's (B, H, S) float32 row log-sum-exp; delta a
// (B, H, S) float32 scratch.  D one of 8, 16, 32, 40, 64, 80, 128, 192 (any
// other -> cudaErrorInvalidValue); B, S, Tk > 0 (the wrapper returns zero
// gradients for an empty problem without a launch).
extern "C" int flash_attn_bwd_f32(const float* q, const float* k,
                                  const float* v, const float* o,
                                  const float* dout, const float* lse,
                                  float* delta, float* dq, float* dk,
                                  float* dv, const long long* strides, int B,
                                  int H, int Hk, int S, int Tk, int D,
                                  float scale, int causal,
                                  cudaStream_t stream) {
  Args<float> a;
  if (!fill(a, q, k, v, o, dout, lse, delta, dq, dk, dv, strides, B, H, Hk,
            S, Tk, D, scale, causal, stream))
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 8: return launch_fma<float, 8>(a);
    case 16: return launch_fma<float, 16>(a);
    case 32: return launch_fma<float, 32>(a);
    case 40: return launch_fma<float, 40>(a);
    case 64: return launch_fma<float, 64>(a);
    case 80: return launch_fma<float, 80>(a);
    case 128: return launch_fma<float, 128>(a);
    case 192: return launch_fma<float, 192>(a);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attn_bwd_bf16(const bf16* q, const bf16* k,
                                   const bf16* v, const bf16* o,
                                   const bf16* dout, const float* lse,
                                   float* delta, bf16* dq, bf16* dk, bf16* dv,
                                   const long long* strides, int B, int H,
                                   int Hk, int S, int Tk, int D, float scale,
                                   int causal, cudaStream_t stream) {
  Args<bf16> a;
  if (!fill(a, q, k, v, o, dout, lse, delta, dq, dk, dv, strides, B, H, Hk,
            S, Tk, D, scale, causal, stream))
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 8: return launch_fma<bf16, 8>(a);
    case 16: return launch_mma<16>(a);
    case 32: return launch_mma<32>(a);
    case 40: return launch_fma<bf16, 40>(a);
    case 64: return launch_mma<64>(a);
    case 80: return launch_mma<80>(a);
    case 128: return launch_mma<128>(a);
    case 192: return launch_mma<192>(a);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attn_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
