// Flash attention forward: out (B, H, S, Dv) = softmax(q k^T * scale) v,
// causal or bidirectional, with grouped-query heads and strided heads.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attn.py::
// flash_attention (_fa_kernel), and on the card computes the LM stack's
// prefill attention (src/repro/models/attention.py::flash_attention, a
// chunked jnp twin of the same function, which MLA calls with a value
// width and a scale of its own).  q is (B, H, S, D); k is (B, Hk, T, D)
// and v (B, Hk, T, Dv) with H a multiple of Hk: query head h reads KV
// head h / (H / Hk), so grouped-query attention needs no repeated copy of
// K and V.  (D, Dv) is one of the pairs D = Dv in {8, 16, 32, 40, 64, 80,
// 128, 192}, (192, 128) (DeepSeek-V3's MLA: 128 + 64 rope features against
// values of 128) and (24, 16) (its smoke config); the scale is the
// caller's.  Every operand and the output come with their own batch, head
// and sequence strides (the feature axis is contiguous), so the model's
// (B, S, H, D) projections are read and written in place.  The semantics
// are the reference's: scores q.k * scale summed in float32; causal
// masking by absolute position (key t is seen by query s when t <= s)
// with the finite score NEG_INF = -1e30, never -inf; keys past T give
// p = 0; a running state (acc, m, l) updated tile by tile; p rounded to
// v's dtype before the PV product while l sums the unrounded p; out =
// acc / max(l, 1e-30) in q's dtype.  KV tiles wholly above the diagonal
// are skipped, and the heaviest causal query tiles launch first.  A
// sliding window (window > 0, the hybrid family's; the reference's
// src/repro/models/attention.py mask: key t is seen by query s when
// s - t < window, and t <= s too when causal) starts each query tile's kv
// loop at the tile holding its first row's first visible key, never at
// tile 0; keys behind a row's window drop out as -inf, like keys past T,
// so a row that has seen no key yet keeps its state (0, NEG_INF, 0) and
// its rescale factor is 2^0, never 0 * inf.  A window needs S <= T
// (every row then sees a key).
//
// Bound: at the serving path's prefill (B = 4, H = 32, Hk = 8, S = T =
// 2048, D = 128, bf16, causal) the two products over the causal half
// take 4 B H D S (S + 1) / 2 = 1.375e11 FLOP, 0.139 ms at the H100's
// 989 TFLOP/s bf16 tensor rate, against 168 MB of traffic (q, k, v read
// once, out written once), 0.050 ms at 3.35 TB/s: the kernel is bound by
// tensor-core operations.  In float32 (no TF32) the same products run on
// the 67 TFLOP/s FMA pipes, fifteen times slower: bound by operations too.
// DeepSeek-V3's prefill (B = 4, H = Hk = 128, S = 2048, (192, 128), bf16,
// causal) takes 2 (D + Dv) B H S (S + 1) / 2 = 6.87e11 FLOP over the
// causal half, 0.69 ms at the tensor rate, against 1.34 GB, 0.40 ms.
// Hymba-1.5B's (B = 4, H = 25, Hk = 5, S = 2048, D = 64, bf16, causal,
// window 1024) keeps 1024 * 1025 / 2 + 1024 * 1024 (query, key) pairs a
// head: 4 D B H of them is 4.03e10 FLOP, 0.041 ms, against 63 MB of
// traffic, 0.019 ms: bound by operations.
//
// Design.  The TPU kernel walked 512 x 512 VMEM tiles in a sequential
// grid and carried (acc, m, l) in scratch across grid steps.  On Hopper
// the kv loop lives inside the block instead and the state stays in
// registers.  Three kernels:
//  * bf16, D in {64, 80, 128, 192} (the serving path's 128, hubert-xlarge's
//    80, nemotron-4-340b's 192) and (D 192, Dv 128) (DeepSeek-V3's MLA):
//    fa_wgmma_kernel, warp-specialised.  A
//    block of three warpgroups takes 128 query rows of one (b, h).  The
//    producer warpgroup gives up its registers (setmaxnreg) and one of its
//    threads keeps a ring of K and V tiles full with TMA: 4-D tensor maps
//    over (D, heads, rows, batch) carry the operands' strides, write the
//    128-byte swizzled layout that wgmma reads without bank conflicts, and
//    zero-fill rows past the end; mbarriers say when a tile has landed and
//    when both consumers are done with it (K after QK^T, V after PV, so
//    the next K refill need not wait for PV).  Shared memory holds whole
//    64-column swizzle chunks, DP = D rounded up to 64: at D = 80 the
//    second box of a row reads features 64-79 and TMA zero-fills the rest
//    (the map's extent is D, so never the next head's data), and every
//    expect_tx counts the whole boxes.  The ring is two stages of 128 rows
//    up to D = 128 (160 KB); at D = 192 that would take 240 KB of the 227
//    a block may have, so two stages of 64 rows (145 KB).  V has a ring of
//    its own width: at (192, 128) its tiles are 128 features wide (two
//    chunks, two boxes, its own expect_tx), so two stages of 128-row K and
//    V tiles fit (209 KB) and the registers are D 128's (S 64 x 128, O 64 x
//    128 a warpgroup); only QK^T takes 12 steps instead of 8.  The two
//    consumer warpgroups own 64 query rows each.  S = Q K^T is wgmma
//    m64nBNk16 (BN the tile's rows) with Q and K K-major in shared memory,
//    D / 16 steps; O += P V is wgmma m64nDk16 with P taken from the S
//    accumulators' registers (the accumulator layout of one 16-key step is
//    the A fragment's) and V read through the transpose flag, so neither P
//    nor a transposed V goes through shared memory.  Tile j's QK^T and
//    tile j - 1's PV are issued together and the softmax of tile j runs
//    while PV is in flight; the first tile runs before the loop, so that
//    every wgmma in the loop is waited for on every path (ptxas serialises
//    all of a kernel's wgmmas otherwise).  The two consumers run freely,
//    so one's products fill the tensor cores while the other computes its
//    softmax (making them take turns through named barriers was slower on
//    the H100).  The softmax folds the scale into exp2f: p = 2^(s c - m)
//    with c = scale log2(e) and the running max m kept in those units.
//  * bf16, D in {16, 32} (the smoke configs): fa_mma_kernel, 4 warps per
//    64-query tile on mma.sync m16n8k16, K and V tiles of 64 rows in
//    padded shared memory.
//  * float32 (true float32, no TF32) at every pair and bf16 at D = 8, 40
//    (not a multiple of 16) and (24, 16): fa_fma_kernel, register-tiled
//    FMAs.  A block of 128 threads takes 64 query rows against 64-key
//    tiles; a thread holds an 8 x 4 tile of S (8 rows, keys tx, tx + 16,
//    ...) and an 8 x D/16 tile of O (the same rows, features tx, tx + 16,
//    ...), so a 16-byte shared-memory load feeds 16 FMAs (of Q) or 32 (of
//    K) and a score needs no shuffle.  The launch bound asks for two
//    blocks a multiprocessor, which lets ptxas take the registers it needs
//    (at D = 80 it spilled without).  The row max is reduced across the
//    16 lanes of a row once a tile; l is summed per lane and reduced once
//    at the end.  p goes to shared memory key-major for PV.  Q, K and V
//    are staged in their own dtype by cp.async, rows padded by 16 bytes
//    (conflict-free 16-byte loads); K and V have one buffer each, and
//    each buffer's next tile is copied while the other is read (K_{j+1}
//    during tile j's softmax and PV, V_{j+1} during tile j + 1's QK^T),
//    which keeps two blocks a multiprocessor at D = 80.
// Each kernel optionally writes the row log-sum-exp (lse) at its epilogue,
// for the backward kernels of csrc/flash_attn_bwd.cu.
// What is left for later: a persistent grid that overlaps one tile's
// epilogue with the next tile's loads, and the output written through
// shared memory with TMA.
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// Element strides of the four operands: batch, head, sequence.
struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// bf16 on wgmma, D in {64, 80, 128, 192}.
// ---------------------------------------------------------------------------

constexpr int WG_BM = 128;        // query rows per block: 2 warpgroups x 64
constexpr int WG_THREADS = 384;   // producer warpgroup + 2 consumers
constexpr int WG_STAGES = 2;      // K/V ring depth
// Registers per thread after the hand-over: 128 x 24 + 256 x 240 <= 64 K.
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// The wgmma kernel's tiling at query/key width D and value width DV:
// shared memory holds DP = D and DVP = DV rounded up to whole 64-column
// (128-byte) swizzle chunks; K/V tiles of BN rows, 128 where two stages of
// them fit the 227 KB a block may have, else 64.  Q, the ring and 1 KB to
// align take 160 KB at D 80 and 128, 145 KB at D 192 (64-row tiles: 128
// would need 240 KB) and 209 KB at (D 192, DV 128).
constexpr int WG_SMEM_MAX = 232448;
template <int D, int DV>
struct WgShape {
  static constexpr int DP = (D + 63) / 64 * 64;
  static constexpr int DVP = (DV + 63) / 64 * 64;
  static constexpr int CHUNKS = DP / 64;
  static constexpr int V_CHUNKS = DVP / 64;
  static constexpr uint32_t Q_BYTES = WG_BM * DP * 2;   // whole TMA boxes
  static constexpr int BN =
      Q_BYTES + WG_STAGES * 128 * (DP + DVP) * 2 + 1024 <= WG_SMEM_MAX ? 128
                                                                        : 64;
  static constexpr uint32_t K_BYTES = BN * DP * 2;      // one K tile
  static constexpr uint32_t V_BYTES = BN * DVP * 2;     // one V tile
  static constexpr int SMEM = Q_BYTES + WG_STAGES * (K_BYTES + V_BYTES)
                              + 1024;
};

// S = Q K^T for one warpgroup's 64 rows against a BN-row K tile: D / 16
// steps of 16 features.  Within a 64-column chunk a step advances the
// start address by 32 bytes; the hardware applies the swizzle to the full
// address.
template <int D, int BN>
__device__ __forceinline__ void issue_qk(float (&sacc)[BN / 2],
                                         uint32_t q_s, uint32_t k_s,
                                         int wg) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss(sacc,
             sw128_desc(q_s + (kk / 4) * (WG_BM * 128) + wg * (64 * 128)
                        + col, 16, 1024),
             sw128_desc(k_s + (kk / 4) * (BN * 128) + col, 16, 1024),
             kk > 0);
  }
}

// O += bf16(P) V: step kk's A fragment is the S accumulators of keys
// [16 kk, 16 kk + 16); V is read N-major through the transpose flag, the
// 16 rows of a step 2048 bytes on, its 64-column chunks BN * 128 bytes
// apart.  The product is DV columns wide, so the zero columns past DV are
// never read.
template <int DV, int BN>
__device__ __forceinline__ void issue_pv(float (&oacc)[DV / 2],
                                         const uint32_t (&pf)[BN / 16][4],
                                         uint32_t v_s) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs(oacc, pf[kk], sw128_desc(v_s + kk * 16 * 128, BN * 128, 1024));
}

// The online softmax of one tile of scores (keys k0 .. k0 + BN - 1) in
// place: keys past T and keys a window or more behind the row drop out
// (-inf, p = 0), causal masking writes the reference's finite NEG_INF
// (only edge tiles need the test); the running max m is kept in units of
// scale * log2(e), p = 2^(s c - m); l sums the unrounded p.  A row whose
// keys in this tile all lie behind its window, before any key it sees,
// keeps m = NEG_INF, rescales by 2^0 and adds p = 2^-inf = 0: its state
// stays (0, NEG_INF, 0), as if the tile had not been visited.  Returns
// the factors al0, al1 that rescale O's rows.
template <int BN>
__device__ __forceinline__ void softmax_tile(
    float (&sacc)[BN / 2], int k0, int T, int causal, int window,
    int wg_row0, int r0, int r1, int t4, float scale_log2, float& m0,
    float& m1, float& l0, float& l1, float& al0, float& al1) {
  if (k0 + BN > T || (causal && k0 + BN - 1 > wg_row0)
      || (window > 0 && wg_row0 + 63 - k0 >= window)) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int col = k0 + (i / 4) * 8 + t4 * 2 + (i % 2);
      const int row = (i % 4) < 2 ? r0 : r1;
      if (col >= T || (window > 0 && row - col >= window))
        sacc[i] = -INFINITY;
      else if (causal && col > row) sacc[i] = NEG_INF;
    }
  }
  float tmax0 = -INFINITY, tmax1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    if ((i % 4) < 2) tmax0 = fmaxf(tmax0, sacc[i]);
    else tmax1 = fmaxf(tmax1, sacc[i]);
  }
  const float mn0 = fmaxf(m0, quad_max(tmax0) * scale_log2);
  const float mn1 = fmaxf(m1, quad_max(tmax1) * scale_log2);
  al0 = exp2f(m0 - mn0);
  al1 = exp2f(m1 - mn1);
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const bool top = (i % 4) < 2;
    const float p = exp2f(fmaf(sacc[i], scale_log2, top ? -mn0 : -mn1));
    sacc[i] = p;
    if (top) ps0 += p;
    else ps1 += p;
  }
  l0 = l0 * al0 + quad_sum(ps0);
  l1 = l1 * al1 + quad_sum(ps1);
  m0 = mn0;
  m1 = mn1;
}

// p rounded to bf16 as the PV product's A fragments.
template <int BN>
__device__ __forceinline__ void pack_p(const float (&sacc)[BN / 2],
                                       uint32_t (&pf)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    pf[kk][0] = pack_f32(sacc[8 * kk], sacc[8 * kk + 1]);
    pf[kk][1] = pack_f32(sacc[8 * kk + 2], sacc[8 * kk + 3]);
    pf[kk][2] = pack_f32(sacc[8 * kk + 4], sacc[8 * kk + 5]);
    pf[kk][3] = pack_f32(sacc[8 * kk + 6], sacc[8 * kk + 7]);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(WG_THREADS, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                Strides st, int H, int Hk, int S, int T, float scale_log2,
                int causal, int window) {
  using W = WgShape<D, DV>;
  constexpr int BN = W::BN;
  extern __shared__ uint8_t fa_smem[];
  // mbarriers: Q landed; per stage K landed, V landed, K consumed, V
  // consumed.
  __shared__ __align__(8) uint64_t bars[1 + 4 * WG_STAGES];
  // Swizzle atoms are 1024 bytes and must start on a 1024-byte boundary.
  const uint32_t q_s = (smem_u32(fa_smem) + 1023) & ~1023u;
  const uint32_t k_ring = q_s + W::Q_BYTES;
  const uint32_t v_ring = k_ring + WG_STAGES * W::K_BYTES;
  const uint32_t q_full = smem_u32(&bars[0]);
  const uint32_t k_full = smem_u32(&bars[1]);                  // + 8 s
  const uint32_t v_full = smem_u32(&bars[1 + WG_STAGES]);
  const uint32_t k_empty = smem_u32(&bars[1 + 2 * WG_STAGES]);
  const uint32_t v_empty = smem_u32(&bars[1 + 3 * WG_STAGES]);

  const int qt = gridDim.y - 1 - blockIdx.y;      // heaviest tiles first
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hk);
  const int q0 = qt * WG_BM;
  int n_kv = (T + BN - 1) / BN;
  if (causal) n_kv = min(n_kv, (min(q0 + WG_BM, S) - 1) / BN + 1);
  // Under a sliding window the first tile is the one that holds the first
  // key the block's first row sees: tiles j0 .. n_kv - 1, the i-th of
  // them in ring stage i % WG_STAGES.
  const int j0 = window > 0 ? max(0, q0 - window + 1) / BN : 0;
  const int n_tiles = max(0, n_kv - j0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);              // the 8 consumer warps
      mbar_init(v_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: one thread keeps the TMA ring full; the warpgroup hands
    // its registers to the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, W::Q_BYTES);
      for (int c = 0; c < W::CHUNKS; ++c)
        tma_load(q_s + c * (WG_BM * 128), tq, q_full, c * 64, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % WG_STAGES, k0 = (j0 + i) * BN;
        const uint32_t free_parity = ((i / WG_STAGES) & 1) ^ 1;
        mbar_wait(k_empty + 8 * s, free_parity);
        mbar_expect_tx(k_full + 8 * s, W::K_BYTES);
        for (int c = 0; c < W::CHUNKS; ++c)
          tma_load(k_ring + s * W::K_BYTES + c * (BN * 128), tk,
                   k_full + 8 * s, c * 64, hk, k0, b);
        mbar_wait(v_empty + 8 * s, free_parity);
        mbar_expect_tx(v_full + 8 * s, W::V_BYTES);
        for (int c = 0; c < W::V_CHUNKS; ++c)
          tma_load(v_ring + s * W::V_BYTES + c * (BN * 128), tv,
                   v_full + 8 * s, c * 64, hk, k0, b);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(CONSUMER_REGS));
  const int wg = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wg_row0 = q0 + wg * 64;
  const int r0 = wg_row0 + warp * 16 + g, r1 = r0 + 8;

  float oacc[DV / 2], sacc[BN / 2];
  uint32_t pf[BN / 16][4];         // bf16(p) of the last tile, A fragments
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) oacc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f, al0, al1;
  mbar_wait(q_full, 0);

  // Tile 0 alone, so that in the loop every PV issued is waited for on
  // every path (a wait that ptxas cannot prove makes it serialise every
  // wgmma of the kernel).
  if (n_tiles > 0) {
    mbar_wait(k_full, 0);
    wgmma_fence();
    issue_qk<D, BN>(sacc, q_s, k_ring, wg);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    if (lane == 0) mbar_arrive(k_empty);
    softmax_tile<BN>(sacc, j0 * BN, T, causal, window, wg_row0, r0, r1, t4,
                     scale_log2, m0, m1, l0, l1, al0, al1);
    pack_p<BN>(sacc, pf);
  }
  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % WG_STAGES;
    const int sp = (j - 1) % WG_STAGES;             // tile j - 1's stage
    mbar_wait(k_full + 8 * s, (j / WG_STAGES) & 1);
    wgmma_fence();
    issue_qk<D, BN>(sacc, q_s, k_ring + s * W::K_BYTES, wg);
    wgmma_commit();
    // O += bf16(P_{j-1}) V_{j-1}, in flight during this tile's softmax.
    mbar_wait(v_full + 8 * sp, ((j - 1) / WG_STAGES) & 1);
    issue_pv<DV, BN>(oacc, pf, v_ring + sp * W::V_BYTES);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sacc);
    if (lane == 0) mbar_arrive(k_empty + 8 * s);      // K_j is read
    softmax_tile<BN>(sacc, (j0 + j) * BN, T, causal, window, wg_row0, r0,
                     r1, t4, scale_log2, m0, m1, l0, l1, al0, al1);
    wgmma_wait<0>();
    fence_regs(oacc);
    fence_regs(pf);
    if (lane == 0) mbar_arrive(v_empty + 8 * sp);     // V_{j-1} is read
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) oacc[i] *= (i % 4) < 2 ? al0 : al1;
    pack_p<BN>(sacc, pf);
  }
  if (n_tiles > 0) {              // the last tile's PV
    const int sp = (n_tiles - 1) % WG_STAGES;
    mbar_wait(v_full + 8 * sp, ((n_tiles - 1) / WG_STAGES) & 1);
    wgmma_fence();
    issue_pv<DV, BN>(oacc, pf, v_ring + sp * W::V_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oacc);
    fence_regs(pf);
  }

  // The row's log-sum-exp in natural units (m is kept in log2 units).
  if (lse != nullptr && t4 == 0) {
    float* lh = lse + ((long long)b * H + h) * S;
    if (r0 < S) lh[r0] = m0 * 0.6931471805599453f + logf(l0);
    if (r1 < S) lh[r1] = m1 * 0.6931471805599453f + logf(l1);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* oh = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int u = 0; u < DV / 8; ++u) {
    const int c = u * 8 + t4 * 2;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(oh + r0 * st.os + c) =
          pack_f32(oacc[4 * u] / d0, oacc[4 * u + 1] / d0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(oh + r1 * st.os + c) =
          pack_f32(oacc[4 * u + 2] / d1, oacc[4 * u + 3] / d1);
  }
}

// ---------------------------------------------------------------------------
// bf16 on mma.sync m16n8k16, D in {16, 32}.
// ---------------------------------------------------------------------------

constexpr int MMA_BQ = 64;        // query rows per block: 4 warps x 16
constexpr int MMA_BK = 64;        // kv rows per shared-memory tile
constexpr int MMA_THREADS = 128;

template <int D>
constexpr int mma_smem_bytes() {  // the K and V tiles, rows padded by 8
  return 2 * MMA_BK * (D + 8) * 2;
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

// Two consecutive bf16 of row `row` (zero past the last row) as one word.
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base,
                                              int row, int col, int rows,
                                              long long stride) {
  if (row >= rows) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + row * stride + col);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
fa_mma_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
              Strides st, int H, int Hk, int S, int T, float scale,
              int causal, int window) {
  constexpr int LD = D + 8;                 // padded shared row (elements)
  constexpr int PACKS = D / 8;              // 16-byte packs per row
  extern __shared__ uint8_t fa_smem[];      // mma_smem_bytes<D>()
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(fa_smem);
  __nv_bfloat16* vs = ks + MMA_BK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = qt * MMA_BQ;
  const int r0 = q0 + warp * 16 + g;        // this thread's rows: r0, r0 + 8
  const int r1 = r0 + 8;

  const __nv_bfloat16* qh = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* kh = k + b * st.kb + hk * st.kh;
  const __nv_bfloat16* vh = v + b * st.vb + hk * st.vh;

  // Q as A fragments, one per 16-feature step, for the whole kv loop.
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int s = 0; s < D / 16; ++s) {
    const int c = s * 16 + t4 * 2;
    qf[s][0] = load_pair(qh, r0, c, S, st.qs);
    qf[s][1] = load_pair(qh, r1, c, S, st.qs);
    qf[s][2] = load_pair(qh, r0, c + 8, S, st.qs);
    qf[s][3] = load_pair(qh, r1, c + 8, S, st.qs);
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
  // Under a sliding window, from the tile of the first row's first key.
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / MMA_BK : 0;

  for (int kt = kt0; kt < n_kv; ++kt) {
    const int k0 = kt * MMA_BK;
    __syncthreads();                        // the previous tile is consumed
    for (int e = threadIdx.x; e < MMA_BK * PACKS; e += MMA_THREADS) {
      const int r = e / PACKS, c = (e % PACKS) * 8;
      uint4 kp = make_uint4(0u, 0u, 0u, 0u), vp = kp;
      if (k0 + r < T) {
        kp = *reinterpret_cast<const uint4*>(kh + (k0 + r) * st.ks + c);
        vp = *reinterpret_cast<const uint4*>(vh + (k0 + r) * st.vs + c);
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

    // Scale and mask: keys past T and keys a window or more behind the
    // row drop out (-inf, p = 0; a row that has seen no key yet keeps m =
    // NEG_INF and adds nothing); causal masking writes the reference's
    // finite NEG_INF.
    float tmax0 = -INFINITY, tmax1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < MMA_BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + t4 * 2 + (e & 1);
        const int row = e < 2 ? r0 : r1;
        float x = sc[j][e] * scale;
        if (col >= T || (window > 0 && row - col >= window)) x = -INFINITY;
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

  if (lse != nullptr && t4 == 0) {
    float* lh = lse + ((long long)b * H + h) * S;
    if (r0 < S) lh[r0] = m0 + logf(l0);
    if (r1 < S) lh[r1] = m1 + logf(l1);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* oh = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int u = 0; u < D / 8; ++u) {
    const int c = u * 8 + t4 * 2;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(oh + r0 * st.os + c) =
          pack_f32(acc[u][0] / d0, acc[u][1] / d0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(oh + r1 * st.os + c) =
          pack_f32(acc[u][2] / d1, acc[u][3] / d1);
  }
}

// ---------------------------------------------------------------------------
// float32 (and bf16 at D = 8 and 40) on register-tiled FMAs.
// ---------------------------------------------------------------------------

constexpr int F_BQ = 64;          // query rows per block
constexpr int F_BK = 64;          // keys per shared-memory tile
constexpr int F_THREADS = 128;    // 8 row groups x 16 lanes
constexpr int F_RM = F_BQ / 8;    // query rows per thread
constexpr int F_KN = F_BK / 16;   // keys per thread in S
constexpr int F_LDP = F_BQ + 4;   // a key's row of p (floats), padded
static_assert(F_BQ == F_BK, "Q and K/V tiles share copy_tile");

// A shared tile's rows of W elements of T: padded by 16 bytes (so that
// the 16-byte loads of 8 consecutive rows hit distinct banks), copied in
// 16-byte packs.
template <typename T, int W>
struct FmaRow {
  static constexpr int LD = W + 16 / (int)sizeof(T);    // elements a row
  static constexpr int PACKS = W * (int)sizeof(T) / 16;  // 16-byte copies
  static_assert(W * sizeof(T) % 16 == 0, "rows are whole 16-byte packs");
};

// The FMA kernel's shared memory at query/key width D and value width DV:
// Q, K (rows of D) and V (rows of DV) tiles in their own dtype, and p as
// float32, key-major.
template <typename T, int D, int DV>
struct FmaShape {
  static constexpr int LD = FmaRow<T, D>::LD;
  static constexpr int LDV = FmaRow<T, DV>::LD;
  static constexpr int NC = (DV + 15) / 16;    // output features a thread
  static constexpr int SMEM = (2 * F_BK * LD + F_BK * LDV) * (int)sizeof(T)
                              + F_BK * F_LDP * 4;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows row0 .. row0 + 63 of a (rows, W) operand with row stride `stride`
// into a padded tile; rows past the end are zeros.
template <typename T, int W>
__device__ __forceinline__ void copy_tile(T* dst, const T* src,
                                          long long stride, int row0,
                                          int rows) {
  using F = FmaRow<T, W>;
  constexpr int PACK = 16 / (int)sizeof(T);
  for (int e = threadIdx.x; e < F_BK * F::PACKS; e += F_THREADS) {
    const int r = e / F::PACKS, c = (e % F::PACKS) * PACK;
    const bool in = row0 + r < rows;
    cp_async16(dst + r * F::LD + c, src + (in ? (row0 + r) * stride : 0) + c,
               in);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four consecutive elements of a shared tile as float32.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
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

// Max and sum over the 16 lanes that share a row (lanes tx = 0 .. 15 of
// one half-warp).
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o *= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o *= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(F_THREADS, 2)
fa_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, Strides st, int H, int Hk, int S,
              int Tk, float scale, int causal, int window) {
  using F = FmaShape<T, D, DV>;
  constexpr int LD = F::LD, LDV = F::LDV, NC = F::NC;
  extern __shared__ uint8_t fa_smem[];      // F::SMEM, 16-byte aligned
  T* qs = reinterpret_cast<T*>(fa_smem);
  T* ks = qs + F_BQ * LD;
  T* vs = ks + F_BK * LD;
  float* pt = reinterpret_cast<float*>(vs + F_BK * LDV);  // [key][row]

  const int qt = gridDim.x - 1 - blockIdx.x;      // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  // Thread (ty, tx): query rows q0 + 8 ty .. + 7; keys tx + 16 jj of a
  // tile in S; features tx + 16 n in O.
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = qt * F_BQ;
  const int row0 = q0 + ty * F_RM;

  const T* qh = q + b * st.qb + h * st.qh;
  const T* kh = k + b * st.kb + hk * st.kh;
  const T* vh = v + b * st.vb + hk * st.vh;

  const int q_last = min(q0 + F_BQ, S) - 1;
  int n_kv = (Tk + F_BK - 1) / F_BK;
  if (causal) n_kv = min(n_kv, q_last / F_BK + 1);
  // Under a sliding window, from the tile of the first row's first key.
  const int j0 = window > 0 ? max(0, q0 - window + 1) / F_BK : 0;

  // Copy groups: Q with K_j0, then V_j0; in the loop K_{j+1}, then
  // V_{j+1}.  Each wait_group 1 below leaves only the newest group in
  // flight.
  copy_tile<T, D>(qs, qh, st.qs, q0, S);
  if (j0 < n_kv) copy_tile<T, D>(ks, kh, st.ks, j0 * F_BK, Tk);
  cp_async_commit();
  if (j0 < n_kv) copy_tile<T, DV>(vs, vh, st.vs, j0 * F_BK, Tk);
  cp_async_commit();

  float acc[F_RM][NC], m[F_RM], l[F_RM];
#pragma unroll
  for (int i = 0; i < F_RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;                   // this lane's keys; summed at the end
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  for (int j = j0; j < n_kv; ++j) {
    const int k0 = j * F_BK;
    cp_async_wait<1>();           // Q and K_j
    __syncthreads();

    // S = Q K^T: an 8 x 4 tile a thread, four features a step.
    float s[F_RM][F_KN];
#pragma unroll
    for (int i = 0; i < F_RM; ++i)
#pragma unroll
      for (int jj = 0; jj < F_KN; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kv[F_KN];
#pragma unroll
      for (int jj = 0; jj < F_KN; ++jj)
        kv[jj] = ld4(ks + (tx + 16 * jj) * LD + d);
#pragma unroll
      for (int i = 0; i < F_RM; ++i) {
        const float4 qv = ld4(qs + (ty * F_RM + i) * LD + d);
#pragma unroll
        for (int jj = 0; jj < F_KN; ++jj) {
          s[i][jj] = fmaf(qv.x, kv[jj].x, s[i][jj]);
          s[i][jj] = fmaf(qv.y, kv[jj].y, s[i][jj]);
          s[i][jj] = fmaf(qv.z, kv[jj].z, s[i][jj]);
          s[i][jj] = fmaf(qv.w, kv[jj].w, s[i][jj]);
        }
      }
    }
    __syncthreads();              // K_j is read: copy K_{j+1} over it
    if (j + 1 < n_kv) copy_tile<T, D>(ks, kh, st.ks, k0 + F_BK, Tk);
    cp_async_commit();

    // Scale and mask (keys past T and keys a window or more behind the row
    // drop out, -inf: a row that has seen no key yet keeps m = NEG_INF and
    // adds nothing; causal masking writes the reference's finite NEG_INF),
    // then the online softmax row by row.
#pragma unroll
    for (int i = 0; i < F_RM; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < F_KN; ++jj) {
        const int col = k0 + tx + 16 * jj;
        float x = s[i][jj] * scale;
        if (col >= Tk || (window > 0 && row0 + i - col >= window))
          x = -INFINITY;
        else if (causal && col > row0 + i) x = NEG_INF;
        s[i][jj] = x;
        tmax = fmaxf(tmax, x);
      }
      const float mn = fmaxf(m[i], row_max16(tmax));
      const float al = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < F_KN; ++jj) {
        const float p = expf(s[i][jj] - mn);
        ps += p;
        s[i][jj] = as_v(p, v);
      }
      l[i] = l[i] * al + ps;
      m[i] = mn;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= al;
    }
    // p to shared memory, key-major: a key's 8 rows of this thread are
    // two 16-byte stores.
#pragma unroll
    for (int jj = 0; jj < F_KN; ++jj) {
      float4* dst = reinterpret_cast<float4*>(pt + (tx + 16 * jj) * F_LDP
                                              + ty * F_RM);
      dst[0] = make_float4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]);
      dst[1] = make_float4(s[4][jj], s[5][jj], s[6][jj], s[7][jj]);
    }
    cp_async_wait<1>();           // V_j
    __syncthreads();

    // O += p V: an 8 x NC tile a thread.
#pragma unroll 4
    for (int c = 0; c < F_BK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(pt + c * F_LDP
                                                         + ty * F_RM);
      const float4 pb = *reinterpret_cast<const float4*>(pt + c * F_LDP
                                                         + ty * F_RM + 4);
      const float pr[F_RM] = {pa.x, pa.y, pa.z, pa.w,
                              pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int f = tx + 16 * n;
        if (DV % 16 == 0 || f < DV) {
          const float vf = to_f32(vs[c * LDV + f]);
#pragma unroll
          for (int i = 0; i < F_RM; ++i)
            acc[i][n] = fmaf(pr[i], vf, acc[i][n]);
        }
      }
    }
    __syncthreads();              // V_j and p are read: copy V_{j+1}
    if (j + 1 < n_kv) copy_tile<T, DV>(vs, vh, st.vs, k0 + F_BK, Tk);
    cp_async_commit();
  }
  cp_async_wait<0>();

  T* oh = o + b * st.ob + h * st.oh;
  float* lh = lse == nullptr ? nullptr : lse + ((long long)b * H + h) * S;
#pragma unroll
  for (int i = 0; i < F_RM; ++i) {
    const float sum = row_sum16(l[i]);
    const float den = fmaxf(sum, 1e-30f);
    if (lh != nullptr && tx == 0 && row0 + i < S)
      lh[row0 + i] = m[i] + logf(sum);
    if (row0 + i < S) {
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int f = tx + 16 * n;
        if (DV % 16 == 0 || f < DV)
          store(oh + (row0 + i) * st.os + f, acc[i][n] / den);
      }
    }
  }
}

template <typename T, int D, int DV = D>
int launch_fma(const T* q, const T* k, const T* v, T* o, float* lse,
               const Strides& st,
               int B, int H, int Hk, int S, int Tk, float scale, int causal,
               int window, cudaStream_t stream) {
  static unsigned long long configured = 0;
  constexpr int smem = FmaShape<T, D, DV>::SMEM;
  const cudaError_t err = allow_smem(fa_fma_kernel<T, D, DV>, smem,
                                     &configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + F_BQ - 1) / F_BQ, H, B);
  fa_fma_kernel<T, D, DV><<<grid, F_THREADS, smem, stream>>>(
      q, k, v, o, lse, st, H, Hk, S, Tk, scale, causal, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, __nv_bfloat16* o, float* lse,
               const Strides& st, int B, int H, int Hk, int S, int Tk,
               float scale, int causal, int window, cudaStream_t stream) {
  static unsigned long long configured = 0;
  constexpr int smem = mma_smem_bytes<D>();
  const cudaError_t err = allow_smem(fa_mma_kernel<D>, smem, &configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + MMA_BQ - 1) / MMA_BQ, H, B);
  fa_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
      q, k, v, o, lse, st, H, Hk, S, Tk, scale, causal, window);
  return (int)cudaGetLastError();
}

template <int D, int DV = D>
int launch_wgmma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                 const __nv_bfloat16* v, __nv_bfloat16* o, float* lse,
                 const Strides& st, int B, int H, int Hk, int S, int Tk,
                 float scale, int causal, int window, cudaStream_t stream) {
  using W = WgShape<D, DV>;
  constexpr int smem = W::SMEM;
  if ((S + WG_BM - 1) / WG_BM > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, H, S, B, st.qh, st.qs, st.qb, WG_BM))
    return (int)cudaErrorInvalidValue;
  if (Tk == 0) {                  // no key tile is ever loaded
    tk = tv = tq;
  } else if (!make_map(&tk, k, D, Hk, Tk, B, st.kh, st.ks, st.kb, W::BN)
             || !make_map(&tv, v, DV, Hk, Tk, B, st.vh, st.vs, st.vb,
                          W::BN)) {
    return (int)cudaErrorInvalidValue;
  }
  static unsigned long long configured = 0;
  const cudaError_t err = allow_smem(fa_wgmma_kernel<D, DV>, smem,
                                     &configured);
  if (err != cudaSuccess) return (int)err;
  // (b, h) on x, query tiles on y: every head's heaviest tile is issued
  // before any lighter one, and heads that share a KV head run together.
  const dim3 grid((unsigned)B * H, (S + WG_BM - 1) / WG_BM);
  fa_wgmma_kernel<D, DV><<<grid, WG_THREADS, smem, stream>>>(
      tq, tk, tv, o, lse, st, H, Hk, S, Tk, scale * 1.4426950408889634f,
      causal, window);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int Hk, int S, int Tk, int window) {
  return B < 0 || S < 0 || Tk < 0 || H <= 0 || Hk <= 0 || H % Hk != 0
         || window < 0 || (window > 0 && S > Tk);
}

Strides strides_from(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5],
                 s[6], s[7], s[8], s[9], s[10], s[11]};
}

}  // namespace

// strides: 12 element strides (batch, head, sequence) of q, k, v, out.
// lse: null, or a contiguous (B, H, S) float32 tensor that receives each
// row's log-sum-exp of its scaled scores, m + log(l) in natural units from
// the running state the epilogue already holds (the backward kernels
// recompute p from it); serving passes null.
// (D, Dv): the query/key and value widths, one of the pairs below (0 ->
// cudaErrorInvalidValue).  window > 0: query s sees key t only when
// s - t < window (a sliding window; with causal masking too, t <= s);
// it needs S <= Tk, so that every row sees a key.
extern "C" int flash_attn_f32(const float* q, const float* k, const float* v,
                              float* o, float* lse, const long long* strides,
                              int B,
                              int H, int Hk, int S, int Tk, int D, int Dv,
                              float scale, int causal, int window,
                              cudaStream_t stream) {
  if (bad_shape(B, H, Hk, S, Tk, window)) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const Strides st = strides_from(strides);
#define FA_ARGS \
  q, k, v, o, lse, st, B, H, Hk, S, Tk, scale, causal, window, stream
  if (D == Dv) {
    switch (D) {
      case 8: return launch_fma<float, 8>(FA_ARGS);
      case 16: return launch_fma<float, 16>(FA_ARGS);
      case 32: return launch_fma<float, 32>(FA_ARGS);
      case 40: return launch_fma<float, 40>(FA_ARGS);
      case 64: return launch_fma<float, 64>(FA_ARGS);
      case 80: return launch_fma<float, 80>(FA_ARGS);
      case 128: return launch_fma<float, 128>(FA_ARGS);
      case 192: return launch_fma<float, 192>(FA_ARGS);
    }
  }
  if (D == 192 && Dv == 128) return launch_fma<float, 192, 128>(FA_ARGS);
  if (D == 24 && Dv == 16) return launch_fma<float, 24, 16>(FA_ARGS);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attn_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                               const __nv_bfloat16* v, __nv_bfloat16* o,
                               float* lse, const long long* strides, int B,
                               int H,
                               int Hk, int S, int Tk, int D, int Dv,
                               float scale, int causal, int window,
                               cudaStream_t stream) {
  if (bad_shape(B, H, Hk, S, Tk, window)) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const Strides st = strides_from(strides);
  if (D == Dv) {
    switch (D) {
      case 8: return launch_fma<__nv_bfloat16, 8>(FA_ARGS);
      case 16: return launch_mma<16>(FA_ARGS);
      case 32: return launch_mma<32>(FA_ARGS);
      // Not a multiple of mma's 16 features: the FMA kernel.
      case 40: return launch_fma<__nv_bfloat16, 40>(FA_ARGS);
      case 64: return launch_wgmma<64>(FA_ARGS);
      case 80: return launch_wgmma<80>(FA_ARGS);
      case 128: return launch_wgmma<128>(FA_ARGS);
      case 192: return launch_wgmma<192>(FA_ARGS);
    }
  }
  if (D == 192 && Dv == 128) return launch_wgmma<192, 128>(FA_ARGS);
  // The deepseek-v3 smoke config's (16 + 8, 16): too narrow a key for
  // wgmma's 16-feature steps to pay, so the FMA kernel, as at D 8.
  if (D == 24 && Dv == 16) return launch_fma<__nv_bfloat16, 24, 16>(FA_ARGS);
#undef FA_ARGS
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the wgmma kernel at (D, Dv) (0 if the pair has
// none).
extern "C" int flash_attn_wgmma_smem(int D, int Dv) {
  if (D == 192 && Dv == 128) return WgShape<192, 128>::SMEM;
  if (D != Dv) return 0;
  switch (D) {
    case 64: return WgShape<64, 64>::SMEM;
    case 80: return WgShape<80, 80>::SMEM;
    case 128: return WgShape<128, 128>::SMEM;
    case 192: return WgShape<192, 192>::SMEM;
    default: return 0;
  }
}

// Dynamic shared memory of the float32 FMA kernel at (D, Dv) (0 if the
// pair has none).
extern "C" int flash_attn_fma_smem(int D, int Dv) {
  if (D == 192 && Dv == 128) return FmaShape<float, 192, 128>::SMEM;
  if (D == 24 && Dv == 16) return FmaShape<float, 24, 16>::SMEM;
  if (D != Dv) return 0;
  switch (D) {
    case 8: return FmaShape<float, 8, 8>::SMEM;
    case 16: return FmaShape<float, 16, 16>::SMEM;
    case 32: return FmaShape<float, 32, 32>::SMEM;
    case 40: return FmaShape<float, 40, 40>::SMEM;
    case 64: return FmaShape<float, 64, 64>::SMEM;
    case 80: return FmaShape<float, 80, 80>::SMEM;
    case 128: return FmaShape<float, 128, 128>::SMEM;
    case 192: return FmaShape<float, 192, 192>::SMEM;
    default: return 0;
  }
}

extern "C" const char* flash_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
