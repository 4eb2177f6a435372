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
//  * bf16, D in {64, 80, 128, 192} (Hymba-1.5B's 64, the serving path's
//    128, hubert-xlarge's 80, nemotron-4-340b's 192) and (D 192, Dv 128)
//    (DeepSeek-V3's MLA): fa_wgmma_kernel, warp-specialised on a
//    persistent grid.  One block a multiprocessor walks the (b, h, 128-row
//    query tile) items that fwd_plan (kernels/flash_attn.py) gives it:
//    item blockIdx.x + i gridDim.x of a static order, so no counter needs
//    resetting and a CUDA graph replays the launch as it is (sched_item).
//    Under causal masking without a window the order pairs each head's
//    query tiles n - 1 - p and p (n + 1 key tiles together, the same for
//    every pair) and runs the pairs head by head, so that the ~17 heads in
//    flight keep their K and V in L2 (DeepSeek-V3's 512 heads of 1.3 MB
//    each were re-read from HBM for every query tile when the grid walked
//    all heads' latest tiles first); otherwise (a window, or fewer items
//    than multiprocessors) the longest walks go first, in rounds that
//    snake across the blocks.  A block is three warpgroups.  The producer
//    warpgroup gives up its registers (setmaxnreg) and one of its threads
//    keeps the Q buffers and a ring of K and V tiles full with TMA,
//    running into the next item as buffers free: 4-D tensor maps over (D,
//    heads, rows, batch) carry the operands' strides, write the 128-byte
//    swizzled layout that wgmma reads without bank conflicts, and
//    zero-fill rows past the end; mbarriers say when a tile has landed and
//    when both consumers are done with it (K after QK^T, V after PV, Q
//    after the item's last QK^T or once it is in registers).  Shared
//    memory holds whole 64-column swizzle chunks, DP = D rounded up to 64:
//    at D = 80 the second box of a row reads features 64-79 and TMA
//    zero-fills the rest (the map's extent is D, so never the next head's
//    data), and every expect_tx counts the whole boxes.  Q has two
//    buffers (the next item's lands while this one runs) and the ring as
//    many stages as fit, up to three: 64-key tiles at D 192 (128 would
//    not fit), 128 elsewhere (WgShape).  At (192, 128) one Q buffer and
//    two stages of 128-row K and V tiles fill 209 KB; there each consumer
//    loads its Q rows into registers (ldmatrix) as an item starts, frees
//    the buffer for the next item's Q, and QK^T takes Q from registers
//    (wgmma's A operand): its 12 steps then read only K from shared
//    memory.  The two consumer warpgroups own 64 query rows each.  S = Q
//    K^T is wgmma m64nBNk16, D / 16 steps; O += P V is wgmma m64nDk16
//    with P taken from the S accumulators' registers (the accumulator
//    layout of one 16-key step is the A fragment's) and V read through
//    the transpose flag, so neither P nor a transposed V goes through
//    shared memory.  The block's tiles form one stream across its items:
//    tile j's QK^T is issued, O rescaled for tile j - 1's max while it
//    runs, then tile j - 1's PV, and tile j's softmax runs while PV is in
//    flight; where tile j opens an item, that PV ended the last item,
//    whose epilogue follows it.  The block's first tile runs before the
//    loop, so that every wgmma in the loop is waited for on every path
//    (ptxas serialises all of a kernel's wgmmas otherwise).  The epilogue
//    divides by l and writes O in 16-byte stores (a quad transposes four
//    8-column blocks so that a warp writes 64 contiguous bytes of each of
//    its 8 rows), and the rows' lse where asked.  The softmax folds the
//    scale into exp2: p = 2^(s c - m) with c = scale log2(e) and the
//    running max m kept in those units, ex2.approx.ftz for the
//    exponentials; each row's max over four chains.  The consumers run
//    freely (taking turns through named barriers measured no faster).
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
// What is left for later: at D 64 the softmax's latency sits between the
// products (without the softmax the window's time falls to 0.58x, without
// its exponentials not at all); a second score tile that let tile j + 1's
// QK^T run during tile j's softmax measured slower (1.3x), with or without
// a branch between a product's issue and its wait.
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
// bf16 on wgmma, D in {64, 80, 128, 192} and (192, 128): a persistent grid.
// ---------------------------------------------------------------------------

constexpr int PRODUCER_REGS = 24;
constexpr int WG_SMEM_MAX = 232448;
constexpr int ORDER_PAIRS = 0;     // see sched_item
constexpr int ORDER_HEAVIEST = 1;

// The wgmma kernel's tiling at query/key width D and value width DV.
// Shared memory holds DP = D and DVP = DV rounded up to whole 64-column
// (128-byte) swizzle chunks.  An item is BM = 64 CONSUMERS query rows of
// one (b, h); K/V tiles are BN rows.  Q has two buffers (the next item's
// Q lands while this item runs), or one where Q goes to registers at the
// item's start (and at (192, 128), where two do not fit beside two
// stages of 128-row K and V tiles).  The K/V ring has as many stages as
// fit, up to three.  Registers a thread after the hand-over: 128 x 24 +
// 256 x 240 <= 64 K.
template <int D, int DV>
struct WgShape {
  static constexpr bool MLA = D == 192 && DV == 128;
  static constexpr int DP = (D + 63) / 64 * 64;
  static constexpr int DVP = (DV + 63) / 64 * 64;
  static constexpr int CHUNKS = DP / 64;
  static constexpr int V_CHUNKS = DVP / 64;
  static constexpr int CONSUMERS = 2;
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int CONSUMER_REGS = 240;
  static constexpr int BM = 64 * CONSUMERS;
  static constexpr int BN = D == 192 && !MLA ? 64 : 128;
  static constexpr bool Q_REGS = MLA;
  static constexpr int Q_STAGES = MLA ? 1 : 2;
  static constexpr uint32_t Q_BYTES = BM * DP * 2;      // whole TMA boxes
  static constexpr uint32_t K_BYTES = BN * DP * 2;      // one K tile
  static constexpr uint32_t V_BYTES = BN * DVP * 2;     // one V tile
  static constexpr int FIT = (WG_SMEM_MAX - 1024 - 256 - Q_STAGES * Q_BYTES)
                             / (K_BYTES + V_BYTES);
  static constexpr int STAGES = FIT < 3 ? FIT : 3;
  static constexpr int SMEM = Q_STAGES * Q_BYTES
                              + STAGES * (K_BYTES + V_BYTES) + 1024;
  static_assert(STAGES >= 2 && BN % 64 == 0, "two ring stages at least");
};

// The persistent grid's schedule (fwd_plan in kernels/flash_attn.py is
// its twin): n_qt query tiles of BM rows for each of the bh = B H heads;
// block blk of `grid` takes slot i = 0, 1, ..., rounds - 1 in turn.
//  * ORDER_PAIRS: unit u = (i / 2) grid + blk is head u / np's pair p = u
//    % np (np = ceil(n_qt / 2)) of query tiles n_qt - 1 - p (even slots)
//    and p (odd slots; the middle tile of an odd n_qt once).  Under causal
//    masking the two walk n_qt + 1 key tiles together, so every unit costs
//    the same; units run head by head, so the heads in flight at a time
//    are about grid / np, whose K and V stay in L2 while all their query
//    tiles read them.
//  * ORDER_HEAVIEST: rank i grid + c, c = blk in even slots and grid - 1 -
//    blk in odd ones (a snake), is query tile qt[rank / bh] of head rank %
//    bh: qt lists the query tiles longest walk first (past MAX_ORDER
//    tiles, the latest first), and the snake evens the blocks' sums.
constexpr int MAX_ORDER = 1024;
struct Sched {
  int n_qt, bh, mode, grid, rounds;
  unsigned short qt[MAX_ORDER];
};

__device__ __forceinline__ bool sched_item(const Sched& f, int i, int& bh,
                                           int& qt) {
  const int blk = blockIdx.x;
  if (f.mode == ORDER_PAIRS) {
    const int np = (f.n_qt + 1) / 2;
    const int u = (i / 2) * f.grid + blk;
    if (u >= f.bh * np) return false;
    bh = u / np;
    const int p = u % np;
    qt = i % 2 == 0 ? f.n_qt - 1 - p : p;
    return i % 2 == 0 || p != f.n_qt - 1 - p;
  }
  const int rank = i * f.grid + (i % 2 == 0 ? blk : f.grid - 1 - blk);
  if (rank >= f.bh * f.n_qt) return false;
  qt = f.n_qt <= MAX_ORDER ? f.qt[rank / f.bh] : f.n_qt - 1 - rank / f.bh;
  bh = rank % f.bh;
  return true;
}

// The key tiles of query tile qt: j0 .. j0 + n_tiles - 1.  Under causal
// masking up to the tile of its last row's key; under a sliding window
// from the tile that holds its first row's first visible key.  With T >=
// 1 every item has a tile (a window needs S <= T).
template <int BM, int BN>
__device__ __forceinline__ void item_tiles(int qt, int S, int T, int causal,
                                           int window, int& q0, int& j0,
                                           int& n_tiles) {
  q0 = qt * BM;
  int n_kv = (T + BN - 1) / BN;
  if (causal) n_kv = min(n_kv, (min(q0 + BM, S) - 1) / BN + 1);
  j0 = window > 0 ? max(0, q0 - window + 1) / BN : 0;
  n_tiles = max(0, n_kv - j0);
}

// S = Q K^T for one warpgroup's 64 rows against a BN-row K tile: D / 16
// steps of 16 features.  Within a 64-column chunk a step advances the
// start address by 32 bytes; the hardware applies the swizzle to the full
// address.  Q comes from shared memory (q_s, BM rows a chunk) or, where
// qf holds it, from registers.
template <int D, int BN, int BM>
__device__ __forceinline__ void issue_qk(float (&sacc)[BN / 2],
                                         uint32_t q_s, uint32_t k_s,
                                         int wg) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss(sacc,
             sw128_desc(q_s + (kk / 4) * (BM * 128) + wg * (64 * 128)
                        + col, 16, 1024),
             sw128_desc(k_s + (kk / 4) * (BN * 128) + col, 16, 1024),
             kk > 0);
  }
}

template <int D, int BN>
__device__ __forceinline__ void issue_qk(float (&sacc)[BN / 2],
                                         const uint32_t (&qf)[D / 16][4],
                                         uint32_t k_s) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_rs_kmajor(sacc, qf[kk],
                    sw128_desc(k_s + (kk / 4) * (BN * 128) + (kk % 4) * 32,
                               16, 1024),
                    kk > 0);
}

// A warp's 16 rows of Q (rows 64 wg + 16 warp ..) as wgmma's A fragments,
// one per 16-feature step, from the 128-byte-swizzled tile (16-byte chunk
// c of row r at chunk c ^ (r % 8)).
template <int D, int BM>
__device__ __forceinline__ void load_q(uint32_t (&qf)[D / 16][4],
                                       uint32_t q_s, int wg, int warp,
                                       int lane) {
  const int row = wg * 64 + warp * 16 + lane % 8 + ((lane / 8) % 2) * 8;
  const int half = lane / 16;                    // features +0 or +8
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t chunk16 = (kk % 4) * 2 + half;
    ldmatrix_x4(qf[kk], q_s + (kk / 4) * (BM * 128) + row * 128
                            + ((chunk16 ^ (row % 8)) << 4));
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
    // Score i is key c0 + rel(i) of row r0 or r1, rel(i) a constant: the
    // bounds move to the row once, so that a score costs three compares
    // against immediates.
    const int c0 = k0 + t4 * 2;
    const int past = T - c0;                    // rel >= past: key >= T
    const int lo0 = window > 0 ? r0 - window + 1 - c0 : -BN;
    const int lo1 = window > 0 ? r1 - window + 1 - c0 : -BN;
    const int dg0 = causal ? r0 - c0 : BN, dg1 = causal ? r1 - c0 : BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int rel = (i / 4) * 8 + (i % 2);
      const bool top = (i % 4) < 2;
      if (rel >= past || rel < (top ? lo0 : lo1)) sacc[i] = -INFINITY;
      else if (rel > (top ? dg0 : dg1)) sacc[i] = NEG_INF;
    }
  }
  // Each row's max over four chains (depth BN / 16, not BN / 4).
  float x0[4], x1[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) x0[c] = x1[c] = -INFINITY;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int c = ((i / 4) % 2) * 2 + i % 2;
    if ((i % 4) < 2) x0[c] = fmaxf(x0[c], sacc[i]);
    else x1[c] = fmaxf(x1[c], sacc[i]);
  }
  const float tmax0 = fmaxf(fmaxf(x0[0], x0[1]), fmaxf(x0[2], x0[3]));
  const float tmax1 = fmaxf(fmaxf(x1[0], x1[1]), fmaxf(x1[2], x1[3]));
  const float mn0 = fmaxf(m0, quad_max(tmax0) * scale_log2);
  const float mn1 = fmaxf(m1, quad_max(tmax1) * scale_log2);
  al0 = exp2_p(m0 - mn0);
  al1 = exp2_p(m1 - mn1);
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const bool top = (i % 4) < 2;
    const float p = exp2_p(fmaf(sacc[i], scale_log2, top ? -mn0 : -mn1));
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

// O's rows times the softmax's rescale factors (al0 for row r0, al1 for
// r0 + 8).
template <int DV>
__device__ __forceinline__ void rescale(float (&oacc)[DV / 2], float al0,
                                        float al1) {
#pragma unroll
  for (int u = 0; u < DV / 2; ++u) oacc[u] *= (u % 4) < 2 ? al0 : al1;
}

// The four lanes of a quad hold a 4 x 4 block of words, lane t word e;
// afterwards lane t holds lane e's word t as its word e (two butterfly
// exchanges, on bit 0 and bit 1 of the lane).
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int t4) {
  const bool odd = t4 & 1, high = t4 & 2;
  uint32_t a = __shfl_xor_sync(0xffffffffu, odd ? w[0] : w[1], 1);
  uint32_t b = __shfl_xor_sync(0xffffffffu, odd ? w[2] : w[3], 1);
  if (odd) {
    w[0] = a;
    w[2] = b;
  } else {
    w[1] = a;
    w[3] = b;
  }
  a = __shfl_xor_sync(0xffffffffu, high ? w[0] : w[2], 2);
  b = __shfl_xor_sync(0xffffffffu, high ? w[1] : w[3], 2);
  if (high) {
    w[0] = a;
    w[1] = b;
  } else {
    w[2] = a;
    w[3] = b;
  }
}

// An item's epilogue for one thread's rows r0 and r0 + 8: the rows'
// log-sum-exp in natural units (m is kept in log2 units) where lse is
// given, and out = acc / max(l, 1e-30) in 16-byte stores.  A quad holds 8
// consecutive features of a row for each 8-column block u (2 a lane);
// after a transpose of four blocks the lane t4 holds all 8 of block u0 +
// t4, so a warp writes 64 contiguous bytes of each of 8 rows a store.
template <int DV>
__device__ __forceinline__ void store_rows(const float (&oacc)[DV / 2],
                                           __nv_bfloat16* __restrict__ o,
                                           float* __restrict__ lse,
                                           const Strides& st, int b, int h,
                                           int H, int S, int r0, int t4,
                                           float m0, float m1, float l0,
                                           float l1) {
  if (lse != nullptr && t4 == 0) {
    float* lh = lse + ((long long)b * H + h) * S;
    if (r0 < S) lh[r0] = m0 * 0.6931471805599453f + logf(l0);
    if (r0 + 8 < S) lh[r0 + 8] = m1 * 0.6931471805599453f + logf(l1);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* oh = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    const float dn = half ? d1 : d0;
#pragma unroll
    for (int u0 = 0; u0 < DV / 8; u0 += 4) {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = u0 + e;
        w[e] = u < DV / 8 ? pack_f32(oacc[4 * u + 2 * half] / dn,
                                     oacc[4 * u + 2 * half + 1] / dn)
                          : 0u;
      }
      quad_transpose(w, t4);
      if (r < S && u0 + t4 < DV / 8)
        *reinterpret_cast<uint4*>(oh + r * st.os + (u0 + t4) * 8) =
            make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(WgShape<D, DV>::THREADS, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                Strides st, int H, int Hk, int S, int T, float scale_log2,
                int causal, int window, Sched f) {
  using W = WgShape<D, DV>;
  constexpr int BM = W::BM, BN = W::BN, NS = W::STAGES, NQ = W::Q_STAGES;
  constexpr int CONSUMER_WARPS = 4 * W::CONSUMERS;
  extern __shared__ uint8_t fa_smem[];
  // mbarriers: per Q buffer full and empty; per ring stage K landed, V
  // landed, K consumed, V consumed.
  __shared__ __align__(8) uint64_t bars[2 * NQ + 4 * NS];
  // Swizzle atoms are 1024 bytes and must start on a 1024-byte boundary.
  const uint32_t q_ring = (smem_u32(fa_smem) + 1023) & ~1023u;
  const uint32_t k_ring = q_ring + NQ * W::Q_BYTES;
  const uint32_t v_ring = k_ring + NS * W::K_BYTES;
  const uint32_t q_full = smem_u32(&bars[0]);                  // + 8 s
  const uint32_t q_empty = smem_u32(&bars[NQ]);
  const uint32_t k_full = smem_u32(&bars[2 * NQ]);
  const uint32_t v_full = k_full + 8 * NS;
  const uint32_t k_empty = v_full + 8 * NS;
  const uint32_t v_empty = k_empty + 8 * NS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NQ; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, CONSUMER_WARPS);
    }
    for (int s = 0; s < NS; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, CONSUMER_WARPS);
      mbar_init(v_empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: one thread walks the block's items and keeps the Q
    // buffers and the K/V ring full with TMA, running ahead into the next
    // item as buffers free; the warpgroup hands its registers to the
    // consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0 && T > 0) {
      int it = 0, qi = 0;
      for (int i = 0; i < f.rounds; ++i) {
        int bh, qt, q0, j0, n_tiles;
        if (!sched_item(f, i, bh, qt)) continue;
        const int b = bh / H, h = bh % H, hk = h / (H / Hk);
        item_tiles<BM, BN>(qt, S, T, causal, window, q0, j0, n_tiles);
        const int qs = qi % NQ;
        mbar_wait(q_empty + 8 * qs, ((qi / NQ) & 1) ^ 1);
        mbar_expect_tx(q_full + 8 * qs, W::Q_BYTES);
        for (int c = 0; c < W::CHUNKS; ++c)
          tma_load(q_ring + qs * W::Q_BYTES + c * (BM * 128), tq,
                   q_full + 8 * qs, c * 64, h, q0, b);
        ++qi;
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int s = it % NS, k0 = (j0 + j) * BN;
          const uint32_t free_parity = ((it / NS) & 1) ^ 1;
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
    }
    return;
  }

  // Consumers: warpgroup wg owns rows [q0 + 64 wg, q0 + 64 wg + 64) of
  // each item.  The block's tiles form one stream across its items:
  // tile g's QK^T is issued with tile g - 1's PV, and where g starts an
  // item, tile g - 1 ended the last one, whose epilogue follows that PV.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(W::CONSUMER_REGS));
  const int wg = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row = wg * 64 + warp * 16 + g;      // this thread's rows - q0

  float oacc[DV / 2], sacc[BN / 2];
  uint32_t pf[BN / 16][4];         // bf16(p) of the last tile, A fragments
  uint32_t qf[W::Q_REGS ? D / 16 : 1][4];       // Q, where in registers
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) oacc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f, al0 = 1.f, al1 = 1.f;

  // The cursor: slot i, its head and tile (b, h, q0, j0, n_tiles), tile j
  // of it, its Q buffer qs; `it` counts the block's tiles (ring stage and
  // phase), qi its items (Q buffer and phase).
  int i = 0, b = 0, h = 0, q0 = 0, j0 = 0, n_tiles = 0, qs = 0;
  int it = 0, qi = 0;
  // Enter the next item with a slot: false past the block's last.
  auto next_item = [&]() -> bool {
    for (; i < f.rounds; ++i) {
      int bh, qt;
      if (!sched_item(f, i, bh, qt)) continue;
      b = bh / H;
      h = bh % H;
      item_tiles<BM, BN>(qt, S, T, causal, window, q0, j0, n_tiles);
      ++i;
      return true;
    }
    return false;
  };
  // Wait for the item's Q; where it goes to registers, load it and free
  // its buffer for the next item's.
  auto enter_q = [&]() {
    qs = qi % NQ;
    mbar_wait(q_full + 8 * qs, (qi / NQ) & 1);
    ++qi;
    if constexpr (W::Q_REGS) {
      load_q<D, BM>(qf, q_ring + qs * W::Q_BYTES, wg, warp, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty + 8 * qs);
    }
  };
  auto qk = [&](uint32_t k_s) {
    if constexpr (W::Q_REGS) issue_qk<D, BN>(sacc, qf, k_s);
    else issue_qk<D, BN, BM>(sacc, q_ring + qs * W::Q_BYTES, k_s, wg);
  };
  // After an item's last QK^T its Q buffer is free.
  auto release = [&](int s, bool last) {
    if (lane == 0) {
      mbar_arrive(k_empty + 8 * s);
      if (!W::Q_REGS && last) mbar_arrive(q_empty + 8 * qs);
    }
  };

  if (T == 0) {                   // no key: out 0, lse -inf, no load
    while (next_item())
      store_rows<DV>(oacc, o, lse, st, b, h, H, S, q0 + row, t4, m0, m1,
                     l0, l1);
    return;
  }
  if (!next_item()) return;
  // The block's first tile alone, so that in the loop every PV issued is
  // waited for on every path (a wait that ptxas cannot prove makes it
  // serialise every wgmma of the kernel).
  enter_q();
  mbar_wait(k_full, 0);
  wgmma_fence();
  qk(k_ring);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sacc);
  if constexpr (W::Q_REGS) fence_regs(qf);
  release(0, n_tiles == 1);
  softmax_tile<BN>(sacc, j0 * BN, T, causal, window, q0 + wg * 64, q0 + row,
                   q0 + row + 8, t4, scale_log2, m0, m1, l0, l1, al0, al1);
  pack_p<BN>(sacc, pf);
  int j = 0;
  // The item that the pending PV finishes: its head, rows and state.
  int pb = b, ph = h, pq0 = q0;
  float pm0, pm1, pl0, pl1;
  while (true) {
    const int sp = it % NS;                     // the pending PV's stage
    const uint32_t vpar = (it / NS) & 1;
    ++it;
    bool fresh = false;
    if (++j == n_tiles) {
      pb = b;
      ph = h;
      pq0 = q0;
      pm0 = m0;
      pm1 = m1;
      pl0 = l0;
      pl1 = l1;
      if (!next_item()) break;
      enter_q();
      j = 0;
      fresh = true;
      m0 = m1 = NEG_INF;
      l0 = l1 = 0.f;
    }
    const int s = it % NS;
    mbar_wait(k_full + 8 * s, (it / NS) & 1);
    wgmma_fence();
    qk(k_ring + s * W::K_BYTES);
    wgmma_commit();
    // While QK^T runs: O's rows rescaled for the last tile's max, then O
    // += bf16(P) V of that tile, in flight during this softmax.
    rescale<DV>(oacc, al0, al1);
    wgmma_fence();
    mbar_wait(v_full + 8 * sp, vpar);
    issue_pv<DV, BN>(oacc, pf, v_ring + sp * W::V_BYTES);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sacc);
    if constexpr (W::Q_REGS) fence_regs(qf);
    release(s, j == n_tiles - 1);
    softmax_tile<BN>(sacc, (j0 + j) * BN, T, causal, window, q0 + wg * 64,
                     q0 + row, q0 + row + 8, t4, scale_log2, m0, m1, l0, l1,
                     al0, al1);
    wgmma_wait<0>();
    fence_regs(oacc);
    fence_regs(pf);
    if (lane == 0) mbar_arrive(v_empty + 8 * sp);     // V is read
    if (fresh) {
      store_rows<DV>(oacc, o, lse, st, pb, ph, H, S, pq0 + row, t4, pm0,
                     pm1, pl0, pl1);
#pragma unroll
      for (int u = 0; u < DV / 2; ++u) oacc[u] = 0.f;
    }
    pack_p<BN>(sacc, pf);
  }
  // The last tile's PV, then the last item's epilogue.
  const int sp = (it - 1) % NS;
  mbar_wait(v_full + 8 * sp, ((it - 1) / NS) & 1);
  rescale<DV>(oacc, al0, al1);
  wgmma_fence();
  issue_pv<DV, BN>(oacc, pf, v_ring + sp * W::V_BYTES);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(oacc);
  fence_regs(pf);
  store_rows<DV>(oacc, o, lse, st, pb, ph, H, S, pq0 + row, t4, pm0, pm1,
                 pl0, pl1);
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

// The wrapper's plan of the wgmma kernel's grid (fwd_plan in
// kernels/flash_attn.py): the query rows of an item, which must be this
// build's, the order of the items, the number of blocks and, for
// ORDER_HEAVIEST, the query tiles longest walk first (n_qt of them, up to
// MAX_ORDER).
struct Plan {
  int rows, mode, grid;
  const unsigned short* order;
};

template <int D, int DV = D>
int launch_wgmma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                 const __nv_bfloat16* v, __nv_bfloat16* o, float* lse,
                 const Strides& st, int B, int H, int Hk, int S, int Tk,
                 float scale, int causal, int window, const Plan& plan,
                 cudaStream_t stream) {
  using W = WgShape<D, DV>;
  constexpr int smem = W::SMEM;
  const long long n_qt = (S + W::BM - 1) / W::BM, bh = (long long)B * H;
  if (plan.rows != W::BM || plan.grid < 1
      || (plan.mode != ORDER_PAIRS && plan.mode != ORDER_HEAVIEST)
      || bh * (n_qt + 1) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const long long units = plan.mode == ORDER_PAIRS ? bh * ((n_qt + 1) / 2)
                                                   : bh * n_qt;
  const long long slots = (units + plan.grid - 1) / plan.grid;
  Sched f{(int)n_qt, (int)bh, plan.mode, plan.grid,
          (int)(plan.mode == ORDER_PAIRS ? 2 * slots : slots), {}};
  if (plan.mode == ORDER_HEAVIEST && n_qt <= MAX_ORDER) {
    if (plan.order == nullptr) return (int)cudaErrorInvalidValue;
    for (int t = 0; t < n_qt; ++t) {
      if (plan.order[t] >= n_qt) return (int)cudaErrorInvalidValue;
      f.qt[t] = plan.order[t];
    }
  }
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, H, S, B, st.qh, st.qs, st.qb, W::BM))
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
  fa_wgmma_kernel<D, DV><<<plan.grid, W::THREADS, smem, stream>>>(
      tq, tk, tv, o, lse, st, H, Hk, S, Tk, scale * 1.4426950408889634f,
      causal, window, f);
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

// rows, mode, grid, order: the wgmma kernel's plan (fwd_plan), read at D
// 64-192 and (192, 128) only.
extern "C" int flash_attn_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                               const __nv_bfloat16* v, __nv_bfloat16* o,
                               float* lse, const long long* strides, int B,
                               int H,
                               int Hk, int S, int Tk, int D, int Dv,
                               float scale, int causal, int window, int rows,
                               int mode, int grid,
                               const unsigned short* order,
                               cudaStream_t stream) {
  if (bad_shape(B, H, Hk, S, Tk, window)) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const Strides st = strides_from(strides);
  const Plan plan{rows, mode, grid, order};
#define WG_ARGS \
  q, k, v, o, lse, st, B, H, Hk, S, Tk, scale, causal, window, plan, stream
  if (D == Dv) {
    switch (D) {
      case 8: return launch_fma<__nv_bfloat16, 8>(FA_ARGS);
      case 16: return launch_mma<16>(FA_ARGS);
      case 32: return launch_mma<32>(FA_ARGS);
      // Not a multiple of mma's 16 features: the FMA kernel.
      case 40: return launch_fma<__nv_bfloat16, 40>(FA_ARGS);
      case 64: return launch_wgmma<64>(WG_ARGS);
      case 80: return launch_wgmma<80>(WG_ARGS);
      case 128: return launch_wgmma<128>(WG_ARGS);
      case 192: return launch_wgmma<192>(WG_ARGS);
    }
  }
  if (D == 192 && Dv == 128) return launch_wgmma<192, 128>(WG_ARGS);
#undef WG_ARGS
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
