// Flash attention backward: the gradients dQ, dK and dV of the forward of
// csrc/flash_attn.cu, out (B, H, S, Dv) = softmax(q k^T * scale) v, causal
// or bidirectional, with grouped-query heads and strided operands.
//
// Replaces no Pallas kernel of its own: the reference trains through JAX's
// autodiff of its jnp chunked attention (src/repro/models/attention.py:86
// flash_attention, the same function as the Pallas kernel
// src/repro/kernels/flash_attn.py:73, which has no backward).  On the card
// the port's forward is the hand-written kernel, so its gradient is one
// too.  q is (B, H, S, D), k (B, Hk, T, D), v (B, Hk, T, Dv), out and dO
// (B, H, S, Dv), with H a multiple of Hk (query head h reads KV head h /
// (H / Hk)); lse (B, H, S) is the forward's row log-sum-exp of the scaled
// scores, and a float32 scratch takes each row's record {lse * log2 e,
// delta}.  With P = exp(q k^T * scale - lse) (exactly the forward's
// normalised softmax; masked and out-of-range keys give p = 0):
//
//   delta_i = sum_f dO_if O_if   (over Dv)     (pre-pass,
//                                              bwd_delta_rows_kernel)
//   dS_ij   = P_ij (dO_i . v_j - delta_i)      (dP over Dv)
//   dV_j    = sum_i P_ij dO_i                  (width Dv; P rounded to v's
//                                              dtype, as the forward's PV
//                                              product)
//   dK_j    = scale sum_i dS_ij q_i            (width D)
//   dQ_i    = scale sum_j dS_ij k_j            (width D)
//
// in the FlashAttention-2 form: one kernel per (batch, KV head, key tile)
// recomputes P from lse tile by tile, accumulates dK and dV over every
// query tile and over the H / Hk query heads of its group, and writes them
// once; one kernel per (batch, head, query tile) recomputes P and dP and
// accumulates dQ.  No atomics: two runs give the same bits.  Pairs (D, D)
// for D in {8, 16, 32, 40, 64, 80, 128, 192}, and multi-head latent
// attention's (D, Dv) = (192, 128) (DeepSeek-V3) and (24, 16) (its smoke
// config), each at the caller's scale, causal or full, and under the
// forward's sliding window (window > 0: query s sees key t only when s - t
// < window; S <= T), the hybrid family's.
//
// Bound: at Qwen3-4B's training shape (B = 1, H = 32, Hk = 8, S = T =
// 2048, D = 128, bf16, causal) the five products (S = QK^T and dP = dO V^T
// recomputed, dV, dK, dQ) take 5 * 2 B H S T D / 2 = 8.6e10 FLOP over the
// causal half, 0.087 ms at the H100's 989 TFLOP/s bf16 tensor rate,
// against 42 MB of traffic (q, k, v, out, dO, lse read once, dq, dk, dv
// written once), 0.013 ms at 3.35 TB/s: bound by tensor-core operations.
// At DeepSeek-V3's (B = 1, H = Hk = 128, S = 2048, (192, 128)) the
// products take 2 H S(S+1)/2 (3 D + 2 Dv) = 4.5e11 FLOP, 0.452 ms; at
// Hymba-1.5B's (B = 1, H = 25, Hk = 5, S = 2048, D = 64, window 1024) the
// 1.57e6 pairs the window keeps take 2.5e10 FLOP, 0.0255 ms.
// dQ's own kernel recomputes S and dP (seven products in all), which caps
// the pair at 5/7 of that bound.
//
// Design.  Three kernel families:
//  * bf16 at (64, 64), (128, 128) (the dense training path's) and (192,
//    128) (DeepSeek-V3's): bwd_dkdv_wgmma<D, DV> and bwd_dq_wgmma<D, DV>,
//    warp-specialised as the forward's fa_wgmma_kernel
//    (helpers in hopper.cuh).  A block is a producer warpgroup, which
//    hands its registers to two consumer warpgroups (setmaxnreg), and
//    the two consumers.  Every operand arrives by TMA through 4-D tensor
//    maps over the strided views, 64-row boxes in the 128-byte swizzle
//    that wgmma reads, rows past the end zero-filled; mbarriers say when
//    a tile has landed and when its consumer is done with it.  Q and K
//    tiles are D wide, dO and V tiles DV wide.
//    - The pre-pass (bwd_delta_rows_kernel) writes every query row's
//      record, lse * log2 e and delta, 8 lanes a row with 16-byte loads
//      of O and dO and a fixed shuffle tree, 4 rows a warp; each (batch,
//      head) is padded to whole 64-row tiles with {+inf, 0}, so that p = 0
//      past row S with no branch, and a tile holds its 64 lse values, then
//      its 64 deltas (512 bytes, one bulk copy; every kernel family reads
//      this one form).
//    - dK/dV at (D, D): a block takes one 64-key tile; K and V stay in
//      shared memory, and a ring streams the (head, query tile) items that
//      see the keys: one producer thread brings Q and dO by TMA and the
//      item's 64 records by one cp.async.bulk, all on the stage's `full`
//      mbarrier.  The consumers take items in turn.  S^T = K Q^T and dP^T =
//      V dO^T are wgmma (64 keys x 64 queries); P^T (rounded to bf16, as
//      the forward's PV took it) and dS^T (rounded to bf16) stay in
//      registers, where the accumulator layout is the A fragment's, and are
//      the A operands of dV += P^T dO and dK += dS^T Q (wgmma, dO and Q
//      read N-major through the transpose flag): no operand is gathered
//      element by element.  Each consumer holds float32 dK and dV of all 64
//      keys (D floats a thread beside 64 of scores: 192 at D 128); at the
//      end consumer 0 hands its dK over the K/V tiles, consumer 1 its dV
//      over the ring, and each sums the other's half into the gradient it
//      writes (a + b == b + a, so the order of the two does not matter).
//      A consumer waits for an item's products before its next scores; the
//      ring has three stages.
//    - dK/dV at (192, 128): there dK (96 floats a thread) and dV (64)
//      beside two 64 x 64 score tiles and their fragments would take 256
//      registers of a consumer's 240, and a dK partial (48 KB) would not
//      fit over K and V.  So a block takes 128 keys, 64 a consumer, and
//      both consumers walk every item of the ring (Q and dO read once for
//      128 keys, and no partials to hand over).  A consumer holds one
//      score tile at a time and no fragments: S^T, then P^T (float32 into
//      a shared stash of its own, bf16 into a swizzled shared tile), then
//      dP^T beside dV += P^T dO, then dS^T = P^T (dP^T - delta) with P^T
//      from the stash (bf16 into a second tile), then dK += dS^T Q in
//      flight during the next item's P^T; dV and dK read their A operands
//      from those tiles.  That is 96 + 64 + 32 registers: with fragments
//      in registers ptxas serialised the wgmmas (C7512).  P^T and dS^T
//      round to bf16 where the (D, D) kernel rounds them.
//    - dQ: a block takes 128 query rows of one (batch, head), 64 a
//      consumer; Q and dO stay in shared memory and a ring streams 64-key
//      K and V tiles (three stages); each consumer reads its rows' records
//      once.  S = Q K^T and dP = dO V^T as above; dQ += bf16(dS) K
//      with dS from registers, in flight during the next tile's scores.  A
//      separate kernel, rather than dQ summed beside dK/dV: a key tile's
//      share of dQ would cross blocks, and a fixed-order sum of it needs a
//      float32 scratch of every (key tile, query row) or a flag chain
//      between blocks; the two recomputed products cost less.
//    - The grid (bwd_plan in kernels/flash_attn_bwd.py, which the wrapper
//      passes and this file checks): dK/dV blocks launch key tile by key
//      tile, so under causal masking the longest walks (tile j walks H /
//      Hk (S/64 - j) items) go first and the short ones fill in behind
//      them; dQ blocks launch the latest query tiles (the longest walks)
//      first.  The tiles' order comes from two tables the plan passes in
//      the kernels' parameters (TileOrder, longest walk first; without a
//      window the order above): under a window a key tile walks only the
//      query tiles from its first key to the last query its last key
//      reaches (window_end), a dQ tile only the key tiles from its first
//      row's first visible key (window_start), and the walks no longer
//      shrink in launch order.  At Qwen3-4B's training shape the 256
//      dK/dV blocks hold 16,896 items, 128 a multiprocessor, and taken in
//      launch order end at 128.  At (192, 128) both grids launch in
//      groups of HEAD_GROUP KV heads, that order within a group: with
//      every head in flight, the
//      blocks stream 168 MB of Q and dO (1.31 MB a head at DeepSeek-V3's
//      2048 rows) through the 50 MB L2; a group's 16 heads or fewer fit.
//    - Every wgmma is waited for in the iteration that issues it (ptxas
//      serialises all of a kernel's wgmmas when a wait is not on every
//      path); the two consumers overlap each other's elementwise work
//      with their products.
//  * bf16 at D 16, 32, 80 and 192: mma.sync m16n8k16
//    (bf16 in, float32 sums), bwd_dkdv_mma<D, DV> and bwd_dq_mma<D, DV>.
//    Blocks of 4 warps own 64 rows of their side (keys in bwd_dkdv_mma,
//    queries in bwd_dq_mma), 16 a warp; the other side comes in 64-row
//    tiles through shared memory (rows padded by 8 elements; K and Q D
//    wide, V and dO DV wide) and is walked 16 rows at a time, so a warp's
//    score tiles are 16 x 16 and its registers hold only its dK and dV
//    (or dQ) accumulators: D / 2 + DV / 2 floats (192 at D 192).  The
//    accumulators of S^T and dP^T become, after the elementwise step, the
//    A fragments of the dV and dK products, as the forward's P does for
//    PV; the B operands that run along a tile's rows are gathered from
//    shared memory two elements at a time.  Under causal masking a block
//    starts at the first query tile that sees its keys (dK/dV) or stops at
//    the last key tile its queries see (dQ), and a warp skips a 16-row step
//    wholly above the diagonal.  At D 192 the wgmma design's dK and dV (192
//    float32 registers a thread beside the scores) do not fit, and D 16,
//    32 and 80 are the smoke configs' and hubert-xlarge's.
//  * float32 (true float32 FMAs, no TF32) at every pair, and bf16 at D = 8
//    and 40 and at (24, 16): bwd_dkdv_fma<T, D, DV> and bwd_dq_fma; 32 x 32
//    tiles of 128 threads in float32 shared memory (rows padded by one
//    float); a thread computes 8 scores and their dS, the block writes P
//    and dS to shared memory, then each thread accumulates its share of
//    dK (D wide) and dV (DV wide), or dQ, over the tile.
// Where D == DV the two widths' loops run together, as one loop of both
// products, so the (D, D) kernels are those of before the pairs.
// The window: every kernel masks a kept pair by causal and s - t < window
// (ref.flash_attention's mask, not the reference's non-causal swa_fast
// quirk), and a tile walks only the tiles the window reaches; the wgmma
// kernels apply the mask arithmetically inside a tile (a select on p) and
// set only their loops' bounds per item, so no wgmma is issued under a
// condition.
// Why G2 (bf16 at (64, 64) under Hymba-1.5B's window, (1, 25 / 5, 2048,
// 64), window 1024) has this shape, by cut-down copies of the design
// before it (a warp's lse/delta loads, three stages, one warp a row in the
// pre-pass) timed in turns with it (kernel_times.py --only attention_bwd
// --src; on an H100 at 700 W, PERF.md §6): the pre-pass took 0.0145 ms
// and 0.0068 with 16-byte loads, so it has them; dK/dV took 0.057, of
// which its products alone take 0.044 and the row loads ~0.003, so the
// records come by one bulk copy in place of a warp's loads; with the Q/dO
// stream from L2 taken away, or a ring of six stages in place of three,
// dK/dV was no faster (0.0565, 0.062), so no cluster shares Q and dO.  In
// this design, without exp2 dK/dV was 4 % faster, without the bf16
// conversions 2 %, with an integer rounding in place of the conversions
// 25 % slower (more instructions a thread an item), and with products
// only 35 % faster; two warpgroups' m64n64k16 run near the card's peak
// rate, so the products' shape is not what holds it: the consumer's
// elementwise work between a wait and the next issue is.  A consumer that
// issued item j's scores before item j - 1's dV and dK (two stages held,
// a ring of eight), a dQ ring of six with Q and dO as register fragments,
// descriptors stepped by one add (sw128_step) and the barrier in
// item_scores_t each moved G2 by 2 % or less (the pipelined consumer
// 0.056-0.058 ms against 0.057): of these only the last two are kept, and
// (64, 64) runs the three-stage consumer loop and dQ path of (128, 128).
// The exponentials are ex2.approx.ftz (exp2_p) in every wgmma kernel, as
// in the forward, where the design before took exp2f; the FMA kernels
// take exp2f of s * scale * log2 e less the record's prescaled lse where
// they took expf(s * scale - lse) (the mma.sync kernels read from the
// record the product they formed themselves: the same bits).  With the
// pre-pass's other summation order these are why the gradients differ
// from that design's in the last bits (all within the checks' bounds).
// What is left for later: the wgmma kernels at D 80 and 192; a consumer
// schedule that overlaps one warpgroup's elementwise work with the
// other's products (G2's dK/dV runs at ~40 % of its products' rate);
// two-block clusters sharing Q and dO by TMA multicast, which the copies
// above say would not pay.
#include <math.h>

#include "hopper.cuh"

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
// The row record {lse * log2 e, delta = rowsum(dO * O)} of every (batch,
// head, query row), each (batch, head) padded to whole 64-row tiles
// (ROW_TILE) with {+inf, 0}, so that a padded row's p is 0 with no branch.
// 8 lanes a row and 4 rows a warp: each lane reads 16-byte packs of O and
// dO (pack l, l + 8, ...), sums them in order, and a fixed shuffle tree adds
// the 8 lanes.
// ---------------------------------------------------------------------------

constexpr int ROW_TILE = 64;

__host__ __device__ constexpr int row_pad(int S) {
  return (S + ROW_TILE - 1) / ROW_TILE * ROW_TILE;
}

// The records of one (batch, head): rows + (b H + h) 2 row_pad(S) floats,
// tile by tile; a tile holds its 64 rows' lse * log2 e, then their delta.
__device__ __forceinline__ const float* head_records(const float* rows,
                                                     int b, int H, int h,
                                                     int S) {
  return rows + ((long long)b * H + h) * 2 * row_pad(S);
}

__device__ __forceinline__ float rec_lse(const float* rh, int r) {
  return rh[r / ROW_TILE * 2 * ROW_TILE + r % ROW_TILE];
}

__device__ __forceinline__ float rec_delta(const float* rh, int r) {
  return rh[r / ROW_TILE * 2 * ROW_TILE + ROW_TILE + r % ROW_TILE];
}

__device__ __forceinline__ float dot_pack(const uint4& a, const uint4& b,
                                          float acc, const float*) {
  const float* x = reinterpret_cast<const float*>(&a);
  const float* y = reinterpret_cast<const float*>(&b);
#pragma unroll
  for (int j = 0; j < 4; ++j) acc = fmaf(x[j], y[j], acc);
  return acc;
}

__device__ __forceinline__ float dot_pack(const uint4& a, const uint4& b,
                                          float acc, const bf16*) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 u = __bfloat1622float2(x[j]), w = __bfloat1622float2(y[j]);
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}

template <typename T, int DV>
__global__ void __launch_bounds__(256)
bwd_delta_rows_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      float* __restrict__ rows, Layouts st, int H, int S,
                      long long n_rows) {
  constexpr int PACKS = DV * (int)sizeof(T) / 16;
  static_assert(DV * sizeof(T) % 16 == 0, "whole 16-byte packs");
  const int s_pad = row_pad(S);
  const long long row = (long long)blockIdx.x * 32 + threadIdx.x / 8;
  const int l8 = threadIdx.x % 8;
  const int s = (int)(row % s_pad);
  const long long bh = row / s_pad;
  const bool real = row < n_rows && s < S;
  float acc = 0.f, l = 0.f;
  if (real) {
    const int h = (int)(bh % H), b = (int)(bh / H);
    if (l8 == 0) l = lse[bh * S + s];
    const T* orow = o + b * st.o.b + h * st.o.h + s * st.o.s;
    const T* drow = dout + b * st.dout.b + h * st.dout.h + s * st.dout.s;
#pragma unroll
    for (int p = l8; p < PACKS; p += 8)
      acc = dot_pack(*reinterpret_cast<const uint4*>(orow + p * 16 / sizeof(T)),
                     *reinterpret_cast<const uint4*>(drow + p * 16 / sizeof(T)),
                     acc, o);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (row < n_rows && l8 == 0) {
    float* rec = rows + row / ROW_TILE * 2 * ROW_TILE + row % ROW_TILE;
    rec[0] = real ? l * LOG2E : INFINITY;
    rec[ROW_TILE] = real ? acc : 0.f;
  }
}

// ---------------------------------------------------------------------------
// bf16 on mma.sync m16n8k16, D a multiple of 16.
// ---------------------------------------------------------------------------

// Q and K tiles of 64 padded rows of D, dO and V of DV, then lse (times
// log2 e) and delta of 64 rows.
template <int D, int DV>
constexpr int mma_smem_bytes() {
  return 2 * BM * (D + 8) * 2 + 2 * BM * (DV + 8) * 2 + 2 * BM * 4;
}

__host__ __device__ constexpr int cmax(int a, int b) {
  return a > b ? a : b;
}
__host__ __device__ constexpr int cmin(int a, int b) {
  return a < b ? a : b;
}

// Under a sliding window (window > 0; query s sees key t only when s - t <
// window) a key tile's walk ends at the query tile (of qrows rows) that
// holds the last query its last key reaches: keys k0 .. k0 + krows - 1,
// below T; n_qt without a window.
__host__ __device__ __forceinline__ int window_end(int k0, int krows, int T,
                                                   int window, int qrows,
                                                   int n_qt) {
  if (window <= 0) return n_qt;
  const int last = cmin(k0 + krows, T) - 1 + window - 1;
  return cmin(n_qt, last / qrows + 1);
}

// ... and a query tile's walk starts at the key tile (of krows keys) that
// holds its first row's first visible key; 0 without a window.
__host__ __device__ __forceinline__ int window_start(int q0, int window,
                                                     int krows) {
  return window > 0 ? cmax(0, q0 - window + 1) / krows : 0;
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

// Rows row0 .. row0 + 63 of a (rows, W) operand with row stride `stride`
// into a padded shared tile, 16 bytes a copy; rows past the end are zeros.
template <int W>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0,
                                          int rows) {
  constexpr int LD = W + 8, PACKS = W / 8;
  for (int e = threadIdx.x; e < BM * PACKS; e += THREADS) {
    const int r = e / PACKS, c = (e % PACKS) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows)
      x = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = x;
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ rows,
             bf16* __restrict__ dk, bf16* __restrict__ dv, Layouts st, int H,
             int Hk, int S, int T, float scale, int causal, int window) {
  static_assert(D % 16 == 0 && DV % 16 == 0, "m16n8k16 steps");
  constexpr int LK = D + 8, LV = DV + 8;
  constexpr int NK = D / 8, NV = DV / 8;      // 8-column blocks of dK, dV
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + BM * LK;
  bf16* qs = vs + BM * LV;
  bf16* ds = qs + BM * LK;                               // dO
  float* ls = reinterpret_cast<float*>(ds + BM * LV);    // lse * log2(e)
  float* es = ls + BM;                                   // delta

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int k0 = kt * BM, kw = warp * 16;   // the warp's keys k0 + kw + 0..15
  const float sl2 = scale * LOG2E;

  load_tile<D>(ks, k + b * st.k.b + hk * st.k.h, st.k.s, k0, T);
  load_tile<DV>(vs, v + b * st.v.b + hk * st.v.h, st.v.s, k0, T);

  float dka[NK][4], dva[NV][4];
#pragma unroll
  for (int u = 0; u < NK; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[u][e] = 0.f;
#pragma unroll
  for (int u = 0; u < NV; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[u][e] = 0.f;

  const int G = H / Hk;
  const int n_qt = (S + BM - 1) / BM;
  const int qt0 = causal ? k0 / BM : 0;     // queries before k0 see no key
  const int qt1 = window_end(k0, BM, T, window, BM, n_qt);
#pragma unroll 1
  for (int hh = 0; hh < G; ++hh) {
    const int h = hk * G + hh;
    const bf16* qh = q + b * st.q.b + h * st.q.h;
    const bf16* doh = dout + b * st.dout.b + h * st.dout.h;
    const float* rh = head_records(rows, b, H, h, S);
#pragma unroll 1
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * BM;
      __syncthreads();                      // the previous tiles are read
      load_tile<D>(qs, qh, st.q.s, q0, S);
      load_tile<DV>(ds, doh, st.dout.s, q0, S);
      if (threadIdx.x < BM) {
        const int r = q0 + threadIdx.x;
        ls[threadIdx.x] = r < S ? rec_lse(rh, r) : 0.f;
        es[threadIdx.x] = r < S ? rec_delta(rh, r) : 0.f;
      }
      __syncthreads();
#pragma unroll 1
      for (int sub = 0; sub < BM / SUB; ++sub) {
        const int qs0 = sub * SUB;
        // Every key of the warp after every query of the step, or a window
        // or more behind it: p = 0.
        if (causal && q0 + qs0 + SUB - 1 < k0 + kw) continue;
        if (window > 0 && q0 + qs0 - (k0 + kw + 15) >= window) continue;
        // S^T = K Q^T over D and dP^T = V dO^T over DV: 16 keys x 16
        // queries, the two products side by side where both widths run.
        float sa[2][4], pa[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sa[n][e] = pa[n][e] = 0.f;
#pragma unroll
        for (int c = 0; c < cmax(D, DV) / 16; ++c) {
          uint32_t ak[4], av[4];
          if (c < D / 16) frag_a<LK>(ak, ks, kw, c * 16, g, t4);
          if (c < DV / 16) frag_a<LV>(av, vs, kw, c * 16, g, t4);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            uint32_t b0, b1;
            if (c < D / 16) {
              frag_b_rows<LK>(b0, b1, qs, qs0 + n * 8, c * 16, g, t4);
              mma_bf16(sa[n], ak, b0, b1);
            }
            if (c < DV / 16) {
              frag_b_rows<LV>(b0, b1, ds, qs0 + n * 8, c * 16, g, t4);
              mma_bf16(pa[n], av, b0, b1);
            }
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
            const bool keep = key < T && row < S && (!causal || key <= row)
                              && (window <= 0 || row - key < window);
            const float p = keep ? exp2f(fmaf(sa[n][e], sl2, -ls[qi])) : 0.f;
            pa[n][e] = p * (pa[n][e] - es[qi]);
            sa[n][e] = p;
          }
        // dV += bf16(P^T) dO (DV wide) and dK += bf16(dS^T) Q (D wide)
        // over the 16 queries.
        const uint32_t pf[4] = {pack_f32(sa[0][0], sa[0][1]),
                                pack_f32(sa[0][2], sa[0][3]),
                                pack_f32(sa[1][0], sa[1][1]),
                                pack_f32(sa[1][2], sa[1][3])};
        const uint32_t df[4] = {pack_f32(pa[0][0], pa[0][1]),
                                pack_f32(pa[0][2], pa[0][3]),
                                pack_f32(pa[1][0], pa[1][1]),
                                pack_f32(pa[1][2], pa[1][3])};
#pragma unroll
        for (int u = 0; u < cmax(NK, NV); ++u) {
          uint32_t b0, b1;
          if (u < NV) {
            frag_b_cols<LV>(b0, b1, ds, qs0, u * 8, g, t4);
            mma_bf16(dva[u], pf, b0, b1);
          }
          if (u < NK) {
            frag_b_cols<LK>(b0, b1, qs, qs0, u * 8, g, t4);
            mma_bf16(dka[u], df, b0, b1);
          }
        }
      }
    }
  }

  bf16* dkh = dk + b * st.dk.b + hk * st.dk.h;
  bf16* dvh = dv + b * st.dv.b + hk * st.dv.h;
  const int r0 = k0 + kw + g, r1 = r0 + 8;
#pragma unroll
  for (int u = 0; u < cmax(NK, NV); ++u) {
    const int c = u * 8 + t4 * 2;
    if (r0 < T) {
      if (u < NK)
        *reinterpret_cast<uint32_t*>(dkh + r0 * st.dk.s + c) =
            pack_f32(dka[u][0] * scale, dka[u][1] * scale);
      if (u < NV)
        *reinterpret_cast<uint32_t*>(dvh + r0 * st.dv.s + c) =
            pack_f32(dva[u][0], dva[u][1]);
    }
    if (r1 < T) {
      if (u < NK)
        *reinterpret_cast<uint32_t*>(dkh + r1 * st.dk.s + c) =
            pack_f32(dka[u][2] * scale, dka[u][3] * scale);
      if (u < NV)
        *reinterpret_cast<uint32_t*>(dvh + r1 * st.dv.s + c) =
            pack_f32(dva[u][2], dva[u][3]);
    }
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS)
bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ rows,
           bf16* __restrict__ dq, Layouts st, int H, int Hk, int S, int T,
           float scale, int causal, int window) {
  static_assert(D % 16 == 0 && DV % 16 == 0, "m16n8k16 steps");
  constexpr int LK = D + 8, LV = DV + 8;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ds = qs + BM * LK;                               // dO
  bf16* ks = ds + BM * LV;
  bf16* vs = ks + BM * LK;

  const int qt = gridDim.x - 1 - blockIdx.x;      // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = qt * BM, qw = warp * 16;
  const int r0 = q0 + qw + g, r1 = r0 + 8;  // this thread's query rows
  const float sl2 = scale * LOG2E;

  load_tile<D>(qs, q + b * st.q.b + h * st.q.h, st.q.s, q0, S);
  load_tile<DV>(ds, dout + b * st.dout.b + h * st.dout.h, st.dout.s, q0, S);
  const float* rh = head_records(rows, b, H, h, S);
  const float l0 = r0 < S ? rec_lse(rh, r0) : 0.f;
  const float l1 = r1 < S ? rec_lse(rh, r1) : 0.f;
  const float e0 = r0 < S ? rec_delta(rh, r0) : 0.f;
  const float e1 = r1 < S ? rec_delta(rh, r1) : 0.f;
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
  for (int kt = window_start(q0, window, BM); kt < n_kt; ++kt) {
    const int k0 = kt * BM;
    __syncthreads();                        // the previous K and V are read
    load_tile<D>(ks, kh, st.k.s, k0, T);
    load_tile<DV>(vs, vh, st.v.s, k0, T);
    __syncthreads();
#pragma unroll 1
    for (int sub = 0; sub < BM / SUB; ++sub) {
      const int ks0 = sub * SUB;
      // Every key of the step after every query of the warp, or a window
      // or more behind it: p = 0.
      if (causal && k0 + ks0 > q0 + qw + 15) continue;
      if (window > 0 && q0 + qw - (k0 + ks0 + 15) >= window) continue;
      // S = Q K^T over D and dP = dO V^T over DV: 16 queries x 16 keys.
      float sa[2][4], pa[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[n][e] = pa[n][e] = 0.f;
#pragma unroll
      for (int c = 0; c < cmax(D, DV) / 16; ++c) {
        uint32_t aq[4], ad[4];
        if (c < D / 16) frag_a<LK>(aq, qs, qw, c * 16, g, t4);
        if (c < DV / 16) frag_a<LV>(ad, ds, qw, c * 16, g, t4);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          uint32_t b0, b1;
          if (c < D / 16) {
            frag_b_rows<LK>(b0, b1, ks, ks0 + n * 8, c * 16, g, t4);
            mma_bf16(sa[n], aq, b0, b1);
          }
          if (c < DV / 16) {
            frag_b_rows<LV>(b0, b1, vs, ks0 + n * 8, c * 16, g, t4);
            mma_bf16(pa[n], ad, b0, b1);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? r0 : r1;
          const int key = k0 + ks0 + n * 8 + t4 * 2 + (e & 1);
          const bool keep = row < S && key < T && (!causal || key <= row)
                            && (window <= 0 || row - key < window);
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
        frag_b_cols<LK>(b0, b1, ks, ks0, u * 8, g, t4);
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
// bf16 on wgmma fed by TMA: (D, D) for D in {64, 128}, and (192, 128).
// ---------------------------------------------------------------------------

constexpr int WG_TILE = 64;          // rows of every tile, keys and queries
constexpr int WG_THREADS = 384;      // producer warpgroup + 2 consumers
// The rings' stages: dK/dV's of Q and dO (each with its 64 row records)
// and dQ's of K and V.
constexpr int KV_STAGES = 3;
constexpr int DQ_STAGES = 3;
// Registers per thread after the hand-over: 128 x 24 + 256 x 240 <= 64 K.
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
// At (192, 128) both grids launch in groups of HEAD_GROUP KV heads
// (bwd_plan's HEAD_GROUP).
constexpr int HEAD_GROUP = 8;
// bwd_plan's launch order of the tiles (kernels/flash_attn_bwd.py
// MAX_ORDER): the dK/dV grid's key tiles and the dQ grid's query tiles,
// longest walk first; n_kt (n_q) 0 past MAX_ORDER tiles, where rank r
// takes key tile r (query tile n_q - 1 - r), the order without a window.
constexpr int MAX_ORDER = 512;
struct TileOrder {
  int n_kt, n_q;
  unsigned short kt[MAX_ORDER], qt[MAX_ORDER];
};

__device__ __forceinline__ int key_tile(const TileOrder& o, int rank) {
  return o.n_kt ? o.kt[rank] : rank;
}

__device__ __forceinline__ int query_tile(const TileOrder& o, int rank,
                                          int n_q) {
  return o.n_q ? o.qt[rank] : n_q - 1 - rank;
}

// Shared memory at (D, DV): 64-row tiles of whole 64-column swizzle chunks
// (8 KB each), Q and K tiles D wide (TILE), dO and V tiles DV wide
// (TILE_V).  dK/dV at (D, D): the block's 64 keys (KEYS) of K and V, the
// ring's Q and dO and each stage's 64 row records (512 bytes), 1 KB to
// align; at the end one consumer's float32 partial dK goes over K and V
// and the other's dV over the ring, whose stages are all read by then: 67
// KB at (64, 64), 131 KB at (128, 128).  dK/dV at (192, 128) (SPLIT): 128
// keys, 64 a consumer, a ring of two stages, and each consumer's float32
// P^T and bf16 P^T and dS^T: 226 KB.  dQ: the block's 128 rows of Q and
// dO, the ring's K and V: 81 KB at (64, 64), 161 KB at (128, 128), 201 KB
// at (192, 128).
template <int D, int DV>
struct BwdShape {
  static constexpr bool SPLIT = D != DV;
  static constexpr int KEYS = SPLIT ? 2 * WG_TILE : WG_TILE;
  static constexpr int RING = SPLIT ? 2 : KV_STAGES;
  static constexpr uint32_t TILE = WG_TILE * D * 2;
  static constexpr uint32_t TILE_V = WG_TILE * DV * 2;
  static constexpr uint32_t STAGE = TILE + TILE_V;       // Q, dO or K, V
  static constexpr uint32_t ROWS_BYTES = 2 * WG_TILE * 4; // 64 records
  // Each consumer's 64 x 64 scores as float32 P^T and as bf16 P^T and
  // dS^T (SPLIT); at (D, D) the partials go over K and V and the ring.
  static constexpr int SCORE_BYTES = SPLIT ? 2 * WG_TILE * WG_TILE * (4 + 4)
                                           : 0;
  static constexpr int PARTIAL_BYTES = 128 * (D / 2) * 4;
  static constexpr int KV_SMEM = KEYS / WG_TILE * STAGE
                                 + RING * (STAGE + ROWS_BYTES)
                                 + SCORE_BYTES + 1024;
  static constexpr int DQ_SMEM = (2 + DQ_STAGES) * STAGE + 1024;
  static_assert(D % 64 == 0 && DV % 64 == 0, "whole swizzle chunks");
  static_assert(SPLIT || (PARTIAL_BYTES <= 2 * TILE
                          && PARTIAL_BYTES <= RING * STAGE),
                "the partials fit over K and V and over the ring");
};

// acc (64 x 64) = A B^T over D features, A and B 64-row tiles K-major in
// shared memory: D / 16 steps of 16 features; a step advances 32 bytes
// inside a 64-column chunk (the hardware swizzles the full address),
// chunks are 8 KB apart.
template <int D>
__device__ __forceinline__ void issue_abt(float (&acc)[32], uint32_t a_s,
                                          uint32_t b_s) {
  const uint64_t da = sw128_desc(a_s, 16, 1024), db = sw128_desc(b_s, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * (WG_TILE * 128) + (kk % 4) * 32;
    wgmma_ss(acc, sw128_step(da, off), sw128_step(db, off), kk > 0);
  }
}

// acc (64 x D) += A B: A the 64 x 64 bf16 fragments in registers (step
// kk's are columns 16 kk .. 16 kk + 15 of an accumulator tile), B a 64-row
// tile read N-major through the transpose flag, 16 rows a step.
template <int D>
__device__ __forceinline__ void issue_ab(float (&acc)[D / 2],
                                         const uint32_t (&af)[4][4],
                                         uint32_t b_s) {
  const uint64_t db = sw128_desc(b_s, WG_TILE * 128, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(acc, af[kk], sw128_step(db, kk * 16 * 128));
}

// A 64 x 64 accumulator tile rounded to bf16 as A fragments.
__device__ __forceinline__ void pack_frags(const float (&acc)[32],
                                           uint32_t (&af)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      af[kk][e] = pack_f32(acc[8 * kk + 2 * e], acc[8 * kk + 2 * e + 1]);
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The 4 warps of consumer wg alone.
__device__ __forceinline__ void consumer_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
}

// A 64 x 64 accumulator tile rounded to bf16 into a 64-row tile of
// 128-byte rows in the 128-byte swizzle (K-major, as wgmma reads an A
// operand from shared memory): this thread's rows warp * 16 + g and + 8.
__device__ __forceinline__ void store_sw128(const float (&acc)[32],
                                            uint8_t* tile, int warp, int g,
                                            int t4) {
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int r = warp * 16 + g + ((e % 4) >= 2 ? 8 : 0);
    *reinterpret_cast<uint32_t*>(tile + r * 128 + (((e / 4) ^ g) << 4)
                                 + t4 * 4) = pack_f32(acc[e], acc[e + 1]);
  }
}

// acc (64 x 2 NA) += A B: A such a 64 x 64 tile in shared memory, B 64
// rows of a tile read N-major through the transpose flag, 16 a step.
template <int NA>
__device__ __forceinline__ void issue_ab_ss(float (&acc)[NA], uint32_t a_s,
                                            uint32_t b_s) {
  const uint64_t da = sw128_desc(a_s, 16, 1024);
  const uint64_t db = sw128_desc(b_s, WG_TILE * 128, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_tb(acc, sw128_step(da, kk * 32), sw128_step(db, kk * 16 * 128));
}

// p = 0 in a 64 x 64 tile of P^T (keys key0 + 0..7 and + 8..15 of this
// thread's rows, queries row0 + 0, 1 + 8 j of its columns) where the key
// lies past T, after the query under causal masking, or a window or more
// behind it.
__device__ __forceinline__ void mask_scores_t(float (&p)[32], int key0,
                                              int row0, int T, int causal,
                                              int window) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int key = key0 + ((e % 4) >= 2 ? 8 : 0);
    const int row = row0 + (e / 4) * 8 + (e % 2);
    if (key >= T || (causal && key > row)
        || (window > 0 && row - key >= window))
      p[e] = 0.f;
  }
}

// The producer's part of the dK/dV kernels, one thread: K and V of the
// block's keys once, then each item's Q and dO tiles by TMA and its 64 row
// records (lse times log2 e, then delta; +inf and 0 past row S) by one bulk
// copy, all completing on the stage's `full` barrier, once the stage's
// `empty` barrier says its last item is read.
template <int D, int DV>
__device__ __forceinline__ void dkdv_produce(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, const float* __restrict__ rows, uint32_t k_s,
    uint32_t v_s, uint32_t ring, uint32_t rec_s, uint32_t kv_full,
    uint32_t full, uint32_t empty, int b, int hk, int k0, int H, int G,
    int S, int qt0, int nq, int n_items) {
  using W = BwdShape<D, DV>;
  constexpr int RING = W::RING;
  mbar_expect_tx(kv_full, W::KEYS / WG_TILE * W::STAGE);
  for (int w = 0; w < W::KEYS / WG_TILE; ++w) {  // keys past T zero-filled
    for (int c = 0; c < D / 64; ++c)
      tma_load(k_s + w * W::TILE + c * (WG_TILE * 128), tk, kv_full, c * 64,
               hk, k0 + w * WG_TILE, b);
    for (int c = 0; c < DV / 64; ++c)
      tma_load(v_s + w * W::TILE_V + c * (WG_TILE * 128), tv, kv_full,
               c * 64, hk, k0 + w * WG_TILE, b);
  }
  const int s_pad = row_pad(S);
  for (int i = 0; i < n_items; ++i) {
    const int s = i % RING;
    const int h = hk * G + i / nq, q0 = (qt0 + i % nq) * WG_TILE;
    const uint32_t q_t = ring + s * W::STAGE, bar = full + 8 * s;
    mbar_wait(empty + 8 * s, ((i / RING) & 1) ^ 1);
    mbar_expect_tx(bar, W::STAGE + W::ROWS_BYTES);
    for (int c = 0; c < D / 64; ++c)
      tma_load(q_t + c * (WG_TILE * 128), tq, bar, c * 64, h, q0, b);
    for (int c = 0; c < DV / 64; ++c)
      tma_load(q_t + W::TILE + c * (WG_TILE * 128), tdo, bar, c * 64, h, q0,
               b);
    bulk_load(rec_s + s * W::ROWS_BYTES,
              rows + (((long long)b * H + h) * s_pad + q0) * 2, W::ROWS_BYTES,
              bar);
  }
}

// P^T and dS^T of one 64 x 64 item in place (sa: S^T, pa: dP^T; keys
// key0 + 0..7 and + 8..15 of this thread's rows, queries row0 + 0, 1 + 8 j
// of its columns, their records rec), for the (D, D) consumers; an item
// that reaches past T, above the diagonal or behind a window masks its
// keys (a branch the whole warpgroup takes alike, around no wgmma).
__device__ __forceinline__ void item_scores_t(float (&sa)[32],
                                              float (&pa)[32],
                                              const float* rec, int k0,
                                              int q0, int key0, int row0,
                                              int t4, int T, int causal,
                                              int window, float sl2) {
#pragma unroll
  for (int e = 0; e < 32; e += 4) {   // queries (e / 4) 8 + 2 t4 + 0, 1
    const float2 l = *reinterpret_cast<const float2*>(rec + e * 2 + t4 * 2);
    sa[e] = exp2_p(fmaf(sa[e], sl2, -l.x));
    sa[e + 1] = exp2_p(fmaf(sa[e + 1], sl2, -l.y));
    sa[e + 2] = exp2_p(fmaf(sa[e + 2], sl2, -l.x));
    sa[e + 3] = exp2_p(fmaf(sa[e + 3], sl2, -l.y));
  }
  if (k0 + WG_TILE > T || (causal && k0 + WG_TILE - 1 > q0)
      || (window > 0 && q0 + WG_TILE - 1 - k0 >= window))
    mask_scores_t(sa, key0, row0, T, causal, window);
  // The deltas are read here, not beside the lse values: held across the
  // mask they take 16 registers, and at (128, 128) ptxas spilled.
  asm volatile("" ::: "memory");
#pragma unroll
  for (int e = 0; e < 32; e += 4) {
    const float2 d = *reinterpret_cast<const float2*>(rec + WG_TILE + e * 2
                                                      + t4 * 2);
    pa[e] = sa[e] * (pa[e] - d.x);
    pa[e + 1] = sa[e + 1] * (pa[e + 1] - d.y);
    pa[e + 2] = sa[e + 2] * (pa[e + 2] - d.x);
    pa[e + 3] = sa[e + 3] * (pa[e + 3] - d.y);
  }
}

// dK and dV of one 64-key tile at (D, D): block i takes key tile i / (B
// Hk) of batch row and KV head i % (B Hk) (bwd_plan in
// kernels/flash_attn_bwd.py: under causal masking the longest walks
// first).  K and V stay in shared memory; the (head, query tile) items
// that see them stream through the ring, taken by the two consumers in
// turn; each consumer holds float32 dK and dV of all 64 keys, and the two
// halves are summed at the end; a consumer waits for one item's products
// before it issues the next item's.
template <int D>
__device__ __forceinline__ void dkdv_shared(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, const float* __restrict__ rows,
    bf16* __restrict__ dk, bf16* __restrict__ dv, const Layouts& st, int B,
    int H, int Hk, int S, int T, float scale, int causal, int window,
    const TileOrder& ord) {
  using W = BwdShape<D, D>;
  constexpr int RING = W::RING;
  constexpr int NA = D / 2;                   // dK (or dV) floats a thread
  extern __shared__ uint8_t bwd_smem[];
  // mbarriers: K/V landed; per stage Q, dO and records landed, read.
  __shared__ __align__(8) uint64_t bars[1 + 2 * RING];
  const uint32_t raw = smem_u32(bwd_smem);
  const uint32_t k_s = (raw + 1023) & ~1023u;
  uint8_t* base = bwd_smem + (k_s - raw);
  const uint32_t v_s = k_s + W::TILE;
  const uint32_t ring = k_s + 2 * W::TILE;    // stage s: Q, then dO
  const uint32_t rec_s = ring + RING * W::STAGE;
  const float* recs = reinterpret_cast<const float*>(base + (rec_s - k_s));
  float* red_k = reinterpret_cast<float*>(base);          // over K and V
  float* red_v = reinterpret_cast<float*>(base + (ring - k_s));  // the ring
  const uint32_t kv_full = smem_u32(&bars[0]);
  const uint32_t full = smem_u32(&bars[1]);                        // + 8 s
  const uint32_t empty = smem_u32(&bars[1 + RING]);

  const int n_qt = (S + WG_TILE - 1) / WG_TILE;
  const int G = H / Hk;
  const int bh = blockIdx.x % (B * Hk);
  const int kt = key_tile(ord, blockIdx.x / (B * Hk));
  const int b = bh / Hk, hk = bh % Hk, k0 = kt * WG_TILE;
  // Under causal masking the query tiles from the one holding row k0 on;
  // under a window up to the one its last key reaches.
  const int qt0 = causal ? min(kt, n_qt) : 0;
  const int nq = max(0, window_end(k0, WG_TILE, T, window, WG_TILE, n_qt)
                        - qt0);
  const int n_items = G * nq;                 // (head, query tile) pairs

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < RING; ++s) {
      mbar_init(full + 8 * s, 1);             // the producer's arrival
      mbar_init(empty + 8 * s, 4);            // the 4 warps of one consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0)
      dkdv_produce<D, D>(tq, tk, tv, tdo, rows, k_s, v_s, ring, rec_s,
                         kv_full, full, empty, b, hk, k0, H, G, S, qt0, nq,
                         n_items);
    return;
  }

  // Consumers: warpgroup wg takes items wg, wg + 2, ...
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(CONSUMER_REGS));
  const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const float sl2 = scale * LOG2E;
  float dka[NA], dva[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(kv_full, 0);
#pragma unroll 1
  for (int i = wg; i < n_items; i += 2) {
    const int s = i % RING;
    const int q0 = (qt0 + i % nq) * WG_TILE;
    const uint32_t q_t = ring + s * W::STAGE, do_t = q_t + W::TILE;
    mbar_wait(full + 8 * s, (i / RING) & 1);
    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries.
    float sa[32], pa[32];
    wgmma_fence();
    issue_abt<D>(sa, k_s, q_t);
    issue_abt<D>(pa, v_s, do_t);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sa);
    fence_regs(pa);
    item_scores_t(sa, pa, recs + s * 2 * WG_TILE, k0, q0, k0 + warp * 16 + g,
                  q0 + t4 * 2, t4, T, causal, window, sl2);
    // dV += bf16(P^T) dO and dK += bf16(dS^T) Q over the 64 queries.
    uint32_t pf[4][4], df[4][4];
    pack_frags(sa, pf);
    pack_frags(pa, df);
    wgmma_fence();
    issue_ab<D>(dva, pf, do_t);
    issue_ab<D>(dka, df, q_t);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(pf);
    fence_regs(df);
    __syncwarp();                           // every lane's records are read
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  // Both consumers are done with K, V and the ring: consumer 0 hands its
  // dK over K and V, consumer 1 its dV over the ring; each adds the
  // other's half (a + b == b + a: the same bits whichever adds) and writes
  // one gradient.
  consumers_sync();
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    if (wg == 0) red_k[i * 128 + tid] = dka[i];
    else red_v[i * 128 + tid] = dva[i];
  }
  consumers_sync();
  const int r0 = k0 + warp * 16 + g, r1 = r0 + 8;
  bf16* out = wg == 0 ? dv + b * st.dv.b + hk * st.dv.h
                      : dk + b * st.dk.b + hk * st.dk.h;
  const long long os = wg == 0 ? st.dv.s : st.dk.s;
  const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
  for (int u = 0; u < D / 8; ++u) {
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * u + e;
      x[e] = (wg == 0 ? dva[i] + red_v[i * 128 + tid]
                      : dka[i] + red_k[i * 128 + tid]) * mul;
    }
    const int col = u * 8 + t4 * 2;
    if (r0 < T)
      *reinterpret_cast<uint32_t*>(out + r0 * os + col) = pack_f32(x[0], x[1]);
    if (r1 < T)
      *reinterpret_cast<uint32_t*>(out + r1 * os + col) = pack_f32(x[2], x[3]);
  }
}

// dK and dV of one 128-key tile at (192, 128), 64 keys a consumer: block
// i takes the (batch row, KV head, key tile) of bwd_plan's order (groups
// of HEAD_GROUP KV heads, key tile by key tile within a group).  Both
// consumers walk every (head, query tile) item of the ring, each against
// its own 64 keys of K and V, and write their own rows: no partials to
// hand over.  A consumer's dK (96 floats a thread) and dV (64) leave room
// for one 64 x 64 score tile and no fragments: an item runs S^T = K Q^T;
// P^T, kept as float32 in the consumer's stash and as bf16 in a swizzled
// shared tile; dP^T = V dO^T beside dV += bf16(P^T) dO; dS^T = P^T (dP^T
// - delta) from the stash, as bf16 into a second tile; and dK +=
// bf16(dS^T) Q, in flight during the next item's P^T.  Every elementwise
// step has a product in flight, and P^T and dS^T round to bf16 where the
// (D, D) kernel rounds them.
template <int D, int DV>
__device__ __forceinline__ void dkdv_split(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, const float* __restrict__ rows,
    bf16* __restrict__ dk, bf16* __restrict__ dv, const Layouts& st, int B,
    int H, int Hk, int S, int T, float scale, int causal, int window,
    const TileOrder& ord) {
  using W = BwdShape<D, DV>;
  constexpr int RING = W::RING;
  extern __shared__ uint8_t bwd_smem[];
  // mbarriers: K/V landed; per stage Q, dO and records landed, read.
  __shared__ __align__(8) uint64_t bars[1 + 2 * RING];
  const uint32_t raw = smem_u32(bwd_smem);
  const uint32_t k_s = (raw + 1023) & ~1023u;  // K of keys 0-63, 64-127
  const uint32_t v_s = k_s + 2 * W::TILE;      // V of the same
  const uint32_t ring = v_s + 2 * W::TILE_V;   // stage s: Q, then dO
  constexpr uint32_t SCORES = WG_TILE * WG_TILE * 2;  // a bf16 score tile
  const uint32_t pt_s = ring + RING * W::STAGE;  // bf16 P^T, one a consumer
  const uint32_t ds_s = pt_s + 2 * SCORES;       // bf16 dS^T, likewise
  const uint32_t rec_s = ds_s + 2 * SCORES;     // each stage's records
  uint8_t* base = bwd_smem + (k_s - raw);
  const float* recs = reinterpret_cast<const float*>(base + (rec_s - k_s));
  float* stash = reinterpret_cast<float*>(base + (rec_s - k_s)
                                          + RING * W::ROWS_BYTES);
  const uint32_t kv_full = smem_u32(&bars[0]);
  const uint32_t full = smem_u32(&bars[1]);                        // + 8 s
  const uint32_t empty = smem_u32(&bars[1 + RING]);

  // Block -> (batch row, KV head, key tile): batch rows in turn, KV heads
  // in groups of HEAD_GROUP, key tile by key tile within a group.
  const int n_kt = (T + W::KEYS - 1) / W::KEYS;
  const int b = blockIdx.x / (Hk * n_kt), rem = blockIdx.x % (Hk * n_kt);
  const int g0 = rem / (HEAD_GROUP * n_kt) * HEAD_GROUP;
  const int gs = min(HEAD_GROUP, Hk - g0);
  const int kt = key_tile(ord, (rem - g0 * n_kt) / gs);
  const int hk = g0 + (rem - g0 * n_kt) % gs;
  const int k0 = kt * W::KEYS;
  const int n_qt = (S + WG_TILE - 1) / WG_TILE;
  const int G = H / Hk;
  // Under causal masking the query tiles from the one holding row k0 on;
  // under a window up to the one its last key reaches.
  const int qt0 = causal ? min(kt * (W::KEYS / WG_TILE), n_qt) : 0;
  const int nq = max(0, window_end(k0, W::KEYS, T, window, WG_TILE, n_qt)
                        - qt0);
  const int n_items = G * nq;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < RING; ++s) {
      mbar_init(full + 8 * s, 1);             // the producer's arrival
      mbar_init(empty + 8 * s, 8);            // the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0)
      dkdv_produce<D, DV>(tq, tk, tv, tdo, rows, k_s, v_s, ring, rec_s,
                          kv_full, full, empty, b, hk, k0, H, G, S, qt0, nq,
                          n_items);
    return;
  }

  // Consumer wg takes keys kw .. kw + 63 of every item.  No wgmma is
  // issued under a condition (ptxas serialises every wgmma of a kernel
  // that does, C7520): a consumer also runs the items none of its keys see
  // (consumer 1's first query tile of each head under causal masking;
  // keys past T), where p = 0 adds exact zeros, and the first item's
  // "last dK" multiplies a zeroed dS^T.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(CONSUMER_REGS));
  const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const float sl2 = scale * LOG2E;
  const int kw = k0 + wg * WG_TILE;
  const uint32_t kw_s = k_s + wg * W::TILE, vw_s = v_s + wg * W::TILE_V;
  const uint32_t pt_w = pt_s + wg * SCORES, ds_w = ds_s + wg * SCORES;
  uint8_t* pt = base + (pt_w - k_s);
  uint8_t* ds = base + (ds_w - k_s);
  float* my_stash = stash + wg * WG_TILE * WG_TILE + tid;  // + 128 e
  float dka[D / 2], dva[DV / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dva[i] = 0.f;
#pragma unroll
  for (int j = 0; j < (int)SCORES / 4 / 128; ++j)
    reinterpret_cast<uint32_t*>(ds)[tid + 128 * j] = 0u;
  fence_async_smem();
  consumer_sync(wg);
  // The Q tile that the last item's dS^T multiplies (at first this
  // consumer's K tile, which has landed, against zeros), and that item's
  // stage, released once its dK product ends.
  uint32_t p_q = kw_s;
  int held = -1;
  mbar_wait(kv_full, 0);
#pragma unroll 1
  for (int i = 0; i < n_items; ++i) {
    const int s = i % RING, q0 = (qt0 + i % nq) * WG_TILE;
    mbar_wait(full + 8 * s, (i / RING) & 1);
    const uint32_t q_t = ring + s * W::STAGE, do_t = q_t + W::TILE;
    const float* rec = recs + s * 2 * WG_TILE;
    // An item that reaches past T, above the diagonal or behind a window
    // masks its keys (a branch the whole warpgroup takes alike).
    const bool edge = kw + WG_TILE > T
                      || (causal && kw + WG_TILE - 1 > q0)
                      || (window > 0 && q0 + WG_TILE - 1 - kw >= window);
    // S^T = K Q^T (64 keys x 64 queries), then the last item's dK +=
    // bf16(dS^T) Q, in flight during this item's P^T.  K's and V's
    // descriptors are built anew each item (opaque): held across the
    // loop they spill.
    float sa[32];
    wgmma_fence();
    issue_abt<D>(sa, opaque(kw_s), q_t);
    wgmma_commit();
    issue_ab_ss(dka, ds_w, p_q);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sa);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int qi = (e / 4) * 8 + t4 * 2 + (e % 2);
      sa[e] = exp2_p(fmaf(sa[e], sl2, -rec[qi]));
    }
    if (edge)
      mask_scores_t(sa, kw + warp * 16 + g, q0 + t4 * 2, T, causal, window);
#pragma unroll
    for (int e = 0; e < 32; ++e) my_stash[128 * e] = sa[e];
    store_sw128(sa, pt, warp, g, t4);          // bf16(P^T), the last dV's
    wgmma_wait<0>();                           // operand long since read
    fence_regs(dka);
    if (held >= 0) {                // the last item's products have ended
      __syncwarp();                 // every lane's records are read
      if (lane == 0) mbar_arrive(empty + 8 * held);
    }
    fence_async_smem();
    consumer_sync(wg);              // all of P^T is written
    // dP^T = V dO^T, then dV += bf16(P^T) dO, in flight during dS^T.
    float pa[32];
    wgmma_fence();
    issue_abt<DV>(pa, opaque(vw_s), do_t);
    wgmma_commit();
    issue_ab_ss(dva, pt_w, do_t);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(pa);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int qi = (e / 4) * 8 + t4 * 2 + (e % 2);
      pa[e] = my_stash[128 * e] * (pa[e] - rec[WG_TILE + qi]);
    }
    store_sw128(pa, ds, warp, g, t4);          // bf16(dS^T): the last dK
    wgmma_wait<0>();                           // ended in the P^T step
    fence_regs(dva);
    fence_async_smem();
    consumer_sync(wg);              // all of dS^T is written
    p_q = q_t;
    held = s;
  }
  wgmma_fence();                    // the last item's dK (the producer
  issue_ab_ss(dka, ds_w, p_q);      // loads nothing more: no release)
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dka);
  if (kw >= T) return;
  const int r0 = kw + warp * 16 + g, r1 = r0 + 8;
  bf16* dkh = dk + b * st.dk.b + hk * st.dk.h;
  bf16* dvh = dv + b * st.dv.b + hk * st.dv.h;
#pragma unroll
  for (int u = 0; u < DV / 8; ++u) {
    const int col = u * 8 + t4 * 2;
    if (r0 < T)
      *reinterpret_cast<uint32_t*>(dvh + r0 * st.dv.s + col) =
          pack_f32(dva[4 * u], dva[4 * u + 1]);
    if (r1 < T)
      *reinterpret_cast<uint32_t*>(dvh + r1 * st.dv.s + col) =
          pack_f32(dva[4 * u + 2], dva[4 * u + 3]);
  }
#pragma unroll
  for (int u = 0; u < D / 8; ++u) {
    const int col = u * 8 + t4 * 2;
    if (r0 < T)
      *reinterpret_cast<uint32_t*>(dkh + r0 * st.dk.s + col) =
          pack_f32(dka[4 * u] * scale, dka[4 * u + 1] * scale);
    if (r1 < T)
      *reinterpret_cast<uint32_t*>(dkh + r1 * st.dk.s + col) =
          pack_f32(dka[4 * u + 2] * scale, dka[4 * u + 3] * scale);
  }
}

// dK and dV: the shared-tile design at (D, D), the split one at (192, 128).
template <int D, int DV>
__global__ void __launch_bounds__(WG_THREADS, 1)
bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ rows, bf16* __restrict__ dk,
               bf16* __restrict__ dv, Layouts st, int B, int H, int Hk, int S,
               int T, float scale, int causal, int window,
               const __grid_constant__ TileOrder ord) {
  if constexpr (BwdShape<D, DV>::SPLIT)
    dkdv_split<D, DV>(tq, tk, tv, tdo, rows, dk, dv, st, B, H, Hk, S, T,
                      scale, causal, window, ord);
  else
    dkdv_shared<D>(tq, tk, tv, tdo, rows, dk, dv, st, B, H, Hk, S, T, scale,
                   causal, window, ord);
}

// dS = P (dP - delta) in place in pa for one consumer's 64 queries (rows
// r0, r1 of this thread, lse l0, l1 times log2 e, delta e0, e1) against
// keys k0 .. k0 + 63; a tile that reaches past T, above the diagonal or
// behind a window masks its keys (p = 0).
__device__ __forceinline__ void dq_scores(float (&sa)[32],
                                          float (&pa)[32], int k0, int T,
                                          int causal, int window, int wg_row0,
                                          int r0, int r1, int t4, float sl2,
                                          float l0, float l1, float e0,
                                          float e1) {
#pragma unroll
  for (int e = 0; e < 32; ++e)
    sa[e] = exp2_p(fmaf(sa[e], sl2, -((e % 4) < 2 ? l0 : l1)));
  // A branch the whole warpgroup takes alike, around no wgmma.
  if (k0 + WG_TILE > T || (causal && k0 + WG_TILE - 1 > wg_row0)
      || (window > 0 && wg_row0 + WG_TILE - 1 - k0 >= window)) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int key = k0 + (e / 4) * 8 + t4 * 2 + (e % 2);
      const int row = (e % 4) < 2 ? r0 : r1;
      if (key >= T || (causal && key > row)
          || (window > 0 && row - key >= window))
        sa[e] = 0.f;
    }
  }
#pragma unroll
  for (int e = 0; e < 32; ++e)
    pa[e] = sa[e] * (pa[e] - ((e % 4) < 2 ? e0 : e1));
}

// dQ of 128 query rows of one (batch row, head), 64 a consumer: S and dP
// recomputed against each 64-key tile of the ring, dQ += bf16(dS) K.  At
// (D, D) block (x, y) takes (batch row, head) x and the y-th latest query
// tile; at (192, 128) block x takes the (batch row, head, query tile) of
// bwd_plan's order (groups of the query heads of HEAD_GROUP KV heads, the
// latest query tiles first within a group).
template <int D, int DV>
__global__ void __launch_bounds__(WG_THREADS, 1)
bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tdo,
             const float* __restrict__ rows, bf16* __restrict__ dq,
             Layouts st, int H, int Hk, int S, int T, float scale, int causal,
             int window, const __grid_constant__ TileOrder ord) {
  using W = BwdShape<D, DV>;
  extern __shared__ uint8_t bwd_smem[];
  // mbarriers: Q/dO landed; per stage K landed, V landed, K read, V read.
  __shared__ __align__(8) uint64_t bars[1 + 4 * DQ_STAGES];
  const uint32_t q_s = (smem_u32(bwd_smem) + 1023) & ~1023u;  // 2 tiles
  const uint32_t do_s = q_s + 2 * W::TILE;                     // 2 tiles
  const uint32_t ring = do_s + 2 * W::TILE_V;  // stage s: K, then V
  const uint32_t q_full = smem_u32(&bars[0]);
  const uint32_t k_full = smem_u32(&bars[1]);                  // + 8 s
  const uint32_t v_full = smem_u32(&bars[1 + DQ_STAGES]);
  const uint32_t k_empty = smem_u32(&bars[1 + 2 * DQ_STAGES]);
  const uint32_t v_empty = smem_u32(&bars[1 + 3 * DQ_STAGES]);

  int b, h, qt;
  if constexpr (W::SPLIT) {
    const int n_q = (S + 2 * WG_TILE - 1) / (2 * WG_TILE);
    const int gh = HEAD_GROUP * (H / Hk);        // query heads a group
    b = blockIdx.x / (H * n_q);
    const int rem = blockIdx.x % (H * n_q);
    const int h0 = rem / (gh * n_q) * gh, gs = min(gh, H - h0);
    qt = query_tile(ord, (rem - h0 * n_q) / gs, n_q);
    h = h0 + (rem - h0 * n_q) % gs;
  } else {
    qt = query_tile(ord, blockIdx.y, gridDim.y);   // heaviest tiles first
    b = blockIdx.x / H;
    h = blockIdx.x % H;
  }
  const int hk = h / (H / Hk);
  const int q0 = qt * 2 * WG_TILE;
  // Key tiles j0 .. j0 + n_kv - 1: under a window from the one holding the
  // first row's first visible key, under causal masking up to the last
  // row's (at least one: a window needs S <= T).
  const int j0 = window_start(q0, window, WG_TILE);
  int kv_end = (T + WG_TILE - 1) / WG_TILE;
  if (causal)
    kv_end = min(kv_end, (min(q0 + 2 * WG_TILE, S) - 1) / WG_TILE + 1);
  const int n_kv = kv_end - j0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);          // the 8 consumer warps
      mbar_init(v_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * W::STAGE);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < cmax(D, DV) / 64; ++c) {
          const uint32_t off = c * (WG_TILE * 128);
          if (c < D / 64)
            tma_load(q_s + w * W::TILE + off, tq, q_full, c * 64, h,
                     q0 + w * WG_TILE, b);
          if (c < DV / 64)
            tma_load(do_s + w * W::TILE_V + off, tdo, q_full, c * 64, h,
                     q0 + w * WG_TILE, b);
        }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % DQ_STAGES, k0 = (j0 + j) * WG_TILE;
        const uint32_t free_parity = ((j / DQ_STAGES) & 1) ^ 1;
        const uint32_t k_t = ring + s * W::STAGE;
        mbar_wait(k_empty + 8 * s, free_parity);
        mbar_expect_tx(k_full + 8 * s, W::TILE);
        for (int c = 0; c < D / 64; ++c)
          tma_load(k_t + c * (WG_TILE * 128), tk, k_full + 8 * s, c * 64, hk,
                   k0, b);
        mbar_wait(v_empty + 8 * s, free_parity);
        mbar_expect_tx(v_full + 8 * s, W::TILE_V);
        for (int c = 0; c < DV / 64; ++c)
          tma_load(k_t + W::TILE + c * (WG_TILE * 128), tv, v_full + 8 * s,
                   c * 64, hk, k0, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(CONSUMER_REGS));
  const int wg = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wg_row0 = q0 + wg * WG_TILE;
  const int r0 = wg_row0 + warp * 16 + g, r1 = r0 + 8;
  const float sl2 = scale * LOG2E;
  // The rows' records (rows past the padded tile, in a 128-row block's
  // second half, read none: their p is 0 by their zero-filled scores).
  const float* rh = head_records(rows, b, H, h, S);
  const float l0 = r0 < S ? rec_lse(rh, r0) : 0.f;
  const float l1 = r1 < S ? rec_lse(rh, r1) : 0.f;
  const float e0 = r0 < S ? rec_delta(rh, r0) : 0.f;
  const float e1 = r1 < S ? rec_delta(rh, r1) : 0.f;

  const uint32_t q_t = q_s + wg * W::TILE, do_t = do_s + wg * W::TILE_V;
  float dqa[D / 2], sa[32], pa[32];
  uint32_t df[4][4];               // bf16(dS) of the last tile, A fragments
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  mbar_wait(q_full, 0);

  // Tile 0 alone, so that in the loop every wgmma issued is waited for on
  // every path (a wait that ptxas cannot prove makes it serialise every
  // wgmma of the kernel).
  mbar_wait(k_full, 0);
  mbar_wait(v_full, 0);
  wgmma_fence();
  issue_abt<D>(sa, q_t, ring);
  issue_abt<DV>(pa, do_t, ring + W::TILE);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sa);
  fence_regs(pa);
  if (lane == 0) mbar_arrive(v_empty);                // V_0 is read
  dq_scores(sa, pa, j0 * WG_TILE, T, causal, window, wg_row0, r0, r1, t4, sl2,
            l0, l1, e0, e1);
  pack_frags(pa, df);
#pragma unroll 1
  for (int j = 1; j < n_kv; ++j) {
    const int s = j % DQ_STAGES, sp = (j - 1) % DQ_STAGES;
    const uint32_t parity = (j / DQ_STAGES) & 1;
    const uint32_t k_t = ring + s * W::STAGE;
    mbar_wait(k_full + 8 * s, parity);
    mbar_wait(v_full + 8 * s, parity);
    // S = Q K_j^T and dP = dO V_j^T (64 queries x 64 keys), then dQ +=
    // bf16(dS_{j-1}) K_{j-1}, in flight during this tile's dS.  At (192,
    // 128) Q's and dO's descriptors are built anew each tile (opaque):
    // held across the loop they spill.
    wgmma_fence();
    issue_abt<D>(sa, W::SPLIT ? opaque(q_t) : q_t, k_t);
    issue_abt<DV>(pa, W::SPLIT ? opaque(do_t) : do_t, k_t + W::TILE);
    wgmma_commit();
    issue_ab<D>(dqa, df, ring + sp * W::STAGE);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sa);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(v_empty + 8 * s);      // V_j is read
    dq_scores(sa, pa, (j0 + j) * WG_TILE, T, causal, window, wg_row0, r0, r1,
              t4, sl2, l0, l1, e0, e1);
    wgmma_wait<0>();
    fence_regs(dqa);
    fence_regs(df);
    if (lane == 0) mbar_arrive(k_empty + 8 * sp);     // K_{j-1} is read
    pack_frags(pa, df);
  }
  wgmma_fence();                   // the last tile's dQ
  issue_ab<D>(dqa, df, ring + ((n_kv - 1) % DQ_STAGES) * W::STAGE);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dqa);
  fence_regs(df);

  bf16* dqh = dq + b * st.dq.b + h * st.dq.h;
#pragma unroll
  for (int u = 0; u < D / 8; ++u) {
    const int col = u * 8 + t4 * 2;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(dqh + r0 * st.dq.s + col) =
          pack_f32(dqa[4 * u] * scale, dqa[4 * u + 1] * scale);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(dqh + r1 * st.dq.s + col) =
          pack_f32(dqa[4 * u + 2] * scale, dqa[4 * u + 3] * scale);
  }
}

// ---------------------------------------------------------------------------
// float32 (and bf16 at D = 8 and 40 and at (24, 16)) on FMAs.
// ---------------------------------------------------------------------------

// Two tiles of 32 rows of D floats (K and Q) and two of DV (V and dO), rows
// padded by one float, two 32 x 32 score tiles (padded likewise), lse and
// delta of 32 rows.
template <int D, int DV>
struct FmaShape {
  static constexpr int LK = D + 1;
  static constexpr int LV = DV + 1;
  static constexpr int LP = FB + 1;
  static constexpr int EK = FB * D / THREADS;   // dK (or dQ) floats a thread
  static constexpr int EV = FB * DV / THREADS;  // dV floats a thread
  static constexpr int SMEM =
      (2 * FB * LK + 2 * FB * LV + 2 * FB * LP + 2 * FB) * 4;
  static_assert(FB * D % THREADS == 0 && FB * DV % THREADS == 0,
                "whole accumulators a thread");
};

template <typename T, int W>
__device__ __forceinline__ void load_tile_f(float* dst, const T* src,
                                            long long stride, int row0,
                                            int rows) {
  for (int e = threadIdx.x; e < FB * W; e += THREADS) {
    const int r = e / W, c = e % W;
    dst[r * (W + 1) + c] =
        row0 + r < rows ? to_f32(src[(row0 + r) * stride + c]) : 0.f;
  }
}

// s = a . b over D features and dp = c . e over DV: one loop of both
// chains where the widths meet, then the wider one's rest (each sum in
// increasing feature order either way).
template <int D, int DV>
__device__ __forceinline__ void fma_scores(float& s, float& dp,
                                           const float* a, const float* b,
                                           const float* c, const float* e) {
  constexpr int DM = cmin(D, DV);
#pragma unroll 8
  for (int f = 0; f < DM; ++f) {
    s = fmaf(a[f], b[f], s);
    dp = fmaf(c[f], e[f], dp);
  }
#pragma unroll 8
  for (int f = DM; f < D; ++f) s = fmaf(a[f], b[f], s);
#pragma unroll 8
  for (int f = DM; f < DV; ++f) dp = fmaf(c[f], e[f], dp);
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_fma(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ rows,
             T* __restrict__ dk, T* __restrict__ dv, Layouts st, int H,
             int Hk, int S, int Tk, float scale, int causal, int window) {
  using F = FmaShape<D, DV>;
  constexpr int LK = F::LK, LV = F::LV, LP = F::LP, EK = F::EK, EV = F::EV;
  extern __shared__ __align__(16) uint8_t smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + FB * LK;
  float* qs = vs + FB * LV;
  float* ds = qs + FB * LK;                 // dO
  float* pt = ds + FB * LV;                 // P^T [key][query], as v's dtype
  float* dst = pt + FB * LP;                // dS^T [key][query]
  float* ls = dst + FB * LP;                // lse * log2(e)
  float* es = ls + FB;                      // delta

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * FB;
  const float sl2 = scale * LOG2E;
  // Scores: key `me` against queries 8 part .. 8 part + 7.
  const int me = threadIdx.x % FB, part = threadIdx.x / FB;
  load_tile_f<T, D>(ks, k + b * st.k.b + hk * st.k.h, st.k.s, k0, Tk);
  load_tile_f<T, DV>(vs, v + b * st.v.b + hk * st.v.h, st.v.s, k0, Tk);

  float dka[EK], dva[EV];
#pragma unroll
  for (int e = 0; e < EK; ++e) dka[e] = 0.f;
#pragma unroll
  for (int e = 0; e < EV; ++e) dva[e] = 0.f;

  const int G = H / Hk;
  const int n_qt = (S + FB - 1) / FB;
  const int qt0 = causal ? k0 / FB : 0;
  const int qt1 = window_end(k0, FB, Tk, window, FB, n_qt);
#pragma unroll 1
  for (int hh = 0; hh < G; ++hh) {
    const int h = hk * G + hh;
    const T* qh = q + b * st.q.b + h * st.q.h;
    const T* doh = dout + b * st.dout.b + h * st.dout.h;
    const float* rh = head_records(rows, b, H, h, S);
#pragma unroll 1
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * FB;
      __syncthreads();                      // the previous tiles are read
      load_tile_f<T, D>(qs, qh, st.q.s, q0, S);
      load_tile_f<T, DV>(ds, doh, st.dout.s, q0, S);
      if (threadIdx.x < FB) {
        const int r = q0 + threadIdx.x;
        ls[threadIdx.x] = r < S ? rec_lse(rh, r) : 0.f;
        es[threadIdx.x] = r < S ? rec_delta(rh, r) : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < 8; ++i) {
        const int qi = part * 8 + i, row = q0 + qi, key = k0 + me;
        float s = 0.f, dp = 0.f;
        fma_scores<D, DV>(s, dp, ks + me * LK, qs + qi * LK, vs + me * LV,
                          ds + qi * LV);
        const bool keep = key < Tk && row < S && (!causal || key <= row)
                          && (window <= 0 || row - key < window);
        const float p = keep ? exp2f(fmaf(s, sl2, -ls[qi])) : 0.f;
        pt[me * LP + qi] = as_v(p, v);
        dst[me * LP + qi] = p * (dp - es[qi]);
      }
      __syncthreads();
      // dV (DV wide) and dK (D wide) of this thread's elements.
#pragma unroll
      for (int e = 0; e < cmax(EK, EV); ++e) {
        const int idx = threadIdx.x + THREADS * e;
        const int kv = idx / DV, fv = idx % DV, kk = idx / D, fk = idx % D;
        float a = e < EV ? dva[e] : 0.f, c = e < EK ? dka[e] : 0.f;
#pragma unroll 8
        for (int qi = 0; qi < FB; ++qi) {
          if (e < EV) a = fmaf(pt[kv * LP + qi], ds[qi * LV + fv], a);
          if (e < EK) c = fmaf(dst[kk * LP + qi], qs[qi * LK + fk], c);
        }
        if (e < EV) dva[e] = a;
        if (e < EK) dka[e] = c;
      }
    }
  }

  T* dkh = dk + b * st.dk.b + hk * st.dk.h;
  T* dvh = dv + b * st.dv.b + hk * st.dv.h;
#pragma unroll
  for (int e = 0; e < cmax(EK, EV); ++e) {
    const int idx = threadIdx.x + THREADS * e;
    const int kk = k0 + idx / D, kv = k0 + idx / DV;
    if (e < EK && kk < Tk) store(dkh + kk * st.dk.s + idx % D, dka[e] * scale);
    if (e < EV && kv < Tk) store(dvh + kv * st.dv.s + idx % DV, dva[e]);
  }
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS)
bwd_dq_fma(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ rows,
           T* __restrict__ dq, Layouts st, int H, int Hk, int S, int Tk,
           float scale, int causal, int window) {
  using F = FmaShape<D, DV>;
  constexpr int LK = F::LK, LV = F::LV, LP = F::LP, E = F::EK;
  extern __shared__ __align__(16) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ds = qs + FB * LK;                 // dO
  float* ks = ds + FB * LV;
  float* vs = ks + FB * LK;
  float* dss = vs + FB * LV;                // dS [query][key]
  float* ls = dss + 2 * FB * LP;            // lse * log2(e)
  float* es = ls + FB;                      // delta

  const int qt = gridDim.x - 1 - blockIdx.x;      // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int q0 = qt * FB;
  // Scores: query `me` against keys 8 part .. 8 part + 7.
  const int me = threadIdx.x % FB, part = threadIdx.x / FB;
  load_tile_f<T, D>(qs, q + b * st.q.b + h * st.q.h, st.q.s, q0, S);
  load_tile_f<T, DV>(ds, dout + b * st.dout.b + h * st.dout.h, st.dout.s, q0,
                     S);
  if (threadIdx.x < FB) {
    const int r = q0 + threadIdx.x;
    const float* rh = head_records(rows, b, H, h, S);
    ls[threadIdx.x] = r < S ? rec_lse(rh, r) : 0.f;
    es[threadIdx.x] = r < S ? rec_delta(rh, r) : 0.f;
  }
  const float sl2 = scale * LOG2E;
  const T* kh = k + b * st.k.b + hk * st.k.h;
  const T* vh = v + b * st.v.b + hk * st.v.h;

  float dqa[E];
#pragma unroll
  for (int e = 0; e < E; ++e) dqa[e] = 0.f;

  int n_kt = (Tk + FB - 1) / FB;
  if (causal) n_kt = min(n_kt, (min(q0 + FB, S) - 1) / FB + 1);
#pragma unroll 1
  for (int kt = window_start(q0, window, FB); kt < n_kt; ++kt) {
    const int k0 = kt * FB;
    __syncthreads();                        // the previous K, V, dS are read
    load_tile_f<T, D>(ks, kh, st.k.s, k0, Tk);
    load_tile_f<T, DV>(vs, vh, st.v.s, k0, Tk);
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < 8; ++i) {
      const int kj = part * 8 + i, key = k0 + kj, row = q0 + me;
      float s = 0.f, dp = 0.f;
      fma_scores<D, DV>(s, dp, qs + me * LK, ks + kj * LK, ds + me * LV,
                        vs + kj * LV);
      const bool keep = row < S && key < Tk && (!causal || key <= row)
                        && (window <= 0 || row - key < window);
      const float p = keep ? exp2f(fmaf(s, sl2, -ls[me])) : 0.f;
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
        c = fmaf(dss[qr * LP + kj], ks[kj * LK + f], c);
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

template <typename T>
struct Args {
  const T *q, *k, *v, *o, *dout;
  const float* lse;
  float* rows;                   // the row records (head_records)
  T *dq, *dk, *dv;
  Layouts st;
  int B, H, Hk, S, Tk, D, DV;
  float scale;
  int causal, window;
  cudaStream_t stream;
};

template <typename T, int DV>
int launch_rows(const Args<T>& a) {
  const long long rows = (long long)a.B * a.H * row_pad(a.S);
  const long long blocks = (rows + 31) / 32;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  bwd_delta_rows_kernel<T, DV><<<(unsigned)blocks, 256, 0, a.stream>>>(
      a.o, a.dout, a.lse, a.rows, a.st, a.H, a.S, rows);
  return (int)cudaGetLastError();
}

template <int D, int DV = D>
int launch_mma(const Args<bf16>& a) {
  static unsigned long long kv_configured = 0, q_configured = 0;
  constexpr int smem = mma_smem_bytes<D, DV>();
  cudaError_t err = allow_smem(bwd_dkdv_mma<D, DV>, smem, &kv_configured);
  if (err == cudaSuccess) err = allow_smem(bwd_dq_mma<D, DV>, smem,
                                           &q_configured);
  if (err != cudaSuccess) return (int)err;
  int rc = launch_rows<bf16, DV>(a);
  if (rc) return rc;
  bwd_dkdv_mma<D, DV><<<dim3((a.Tk + BM - 1) / BM, a.Hk, a.B), THREADS,
                        smem, a.stream>>>(a.q, a.k, a.v, a.dout, a.rows, a.dk,
                                          a.dv, a.st, a.H, a.Hk, a.S, a.Tk,
                                          a.scale, a.causal, a.window);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  bwd_dq_mma<D, DV><<<dim3((a.S + BM - 1) / BM, a.H, a.B), THREADS, smem,
                      a.stream>>>(a.q, a.k, a.v, a.dout, a.rows, a.dq, a.st,
                                  a.H, a.Hk, a.S, a.Tk, a.scale, a.causal,
                                  a.window);
  return (int)cudaGetLastError();
}

// The wgmma kernels at (D, DV).  keys, group, grid and the tile orders are
// bwd_plan's (the wrapper's plan: keys a dK/dV block, KV heads a launch
// group, the dK/dV grid, key tiles and query tiles longest walk first, or
// none past MAX_ORDER), checked against this source's.
template <int D, int DV>
int launch_wgmma(const Args<bf16>& a, int keys, int group, long long grid,
                 const unsigned short* kt_order, int n_kt_order,
                 const unsigned short* qt_order, int n_q_order) {
  using W = BwdShape<D, DV>;
  const long long n_kt = (a.Tk + W::KEYS - 1) / W::KEYS;
  const long long kv_grid = n_kt * a.B * a.Hk;
  const long long n_q = (a.S + 2 * WG_TILE - 1) / (2 * WG_TILE);
  const long long dq_blocks = (long long)a.B * a.H * (W::SPLIT ? n_q : 1);
  if (keys != W::KEYS || group != (W::SPLIT ? HEAD_GROUP : 0)
      || grid != kv_grid || kv_grid > 2147483647LL
      || dq_blocks > 2147483647LL || (!W::SPLIT && n_q > 65535))
    return (int)cudaErrorInvalidValue;
  // A table lists every tile once (or is absent past MAX_ORDER).
  TileOrder ord{n_kt_order, n_q_order, {}, {}};
  if ((n_kt_order != 0 && n_kt_order != n_kt)
      || (n_q_order != 0 && n_q_order != n_q)
      || (n_kt_order == 0 && n_kt <= MAX_ORDER)
      || (n_q_order == 0 && n_q <= MAX_ORDER) || n_kt_order > MAX_ORDER
      || n_q_order > MAX_ORDER)
    return (int)cudaErrorInvalidValue;
  unsigned seen_k[MAX_ORDER / 32] = {}, seen_q[MAX_ORDER / 32] = {};
  for (int i = 0; i < n_kt_order; ++i) {
    const unsigned x = kt_order[i];
    if (x >= (unsigned)n_kt || (seen_k[x / 32] >> (x % 32) & 1u))
      return (int)cudaErrorInvalidValue;
    seen_k[x / 32] |= 1u << (x % 32);
    ord.kt[i] = (unsigned short)x;
  }
  for (int i = 0; i < n_q_order; ++i) {
    const unsigned x = qt_order[i];
    if (x >= (unsigned)n_q || (seen_q[x / 32] >> (x % 32) & 1u))
      return (int)cudaErrorInvalidValue;
    seen_q[x / 32] |= 1u << (x % 32);
    ord.qt[i] = (unsigned short)x;
  }
  const Layouts& st = a.st;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, a.q, D, a.H, a.S, a.B, st.q.h, st.q.s, st.q.b, WG_TILE)
      || !make_map(&tdo, a.dout, DV, a.H, a.S, a.B, st.dout.h, st.dout.s,
                   st.dout.b, WG_TILE)
      || !make_map(&tk, a.k, D, a.Hk, a.Tk, a.B, st.k.h, st.k.s, st.k.b,
                   WG_TILE)
      || !make_map(&tv, a.v, DV, a.Hk, a.Tk, a.B, st.v.h, st.v.s, st.v.b,
                   WG_TILE))
    return (int)cudaErrorInvalidValue;
  static unsigned long long kv_configured = 0, q_configured = 0;
  cudaError_t err = allow_smem(bwd_dkdv_wgmma<D, DV>, W::KV_SMEM,
                               &kv_configured);
  if (err == cudaSuccess) err = allow_smem(bwd_dq_wgmma<D, DV>, W::DQ_SMEM,
                                           &q_configured);
  if (err != cudaSuccess) return (int)err;
  int rc = launch_rows<bf16, DV>(a);
  if (rc) return rc;
  bwd_dkdv_wgmma<D, DV><<<(unsigned)kv_grid, WG_THREADS, W::KV_SMEM,
                          a.stream>>>(
      tq, tk, tv, tdo, a.rows, a.dk, a.dv, st, a.B, a.H, a.Hk, a.S, a.Tk,
      a.scale, a.causal, a.window, ord);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  // (D, D): (b, h) on x, query tiles on y, the heaviest (causal) first;
  // (192, 128): one axis in bwd_plan's order.
  const dim3 dq_grid = W::SPLIT ? dim3((unsigned)dq_blocks)
                                : dim3((unsigned)dq_blocks, (unsigned)n_q);
  bwd_dq_wgmma<D, DV><<<dq_grid, WG_THREADS, W::DQ_SMEM, a.stream>>>(
      tq, tk, tv, tdo, a.rows, a.dq, st, a.H, a.Hk, a.S, a.Tk, a.scale,
      a.causal, a.window, ord);
  return (int)cudaGetLastError();
}

template <typename T, int D, int DV = D>
int launch_fma(const Args<T>& a) {
  static unsigned long long kv_configured = 0, q_configured = 0;
  constexpr int smem = FmaShape<D, DV>::SMEM;
  cudaError_t err = allow_smem(bwd_dkdv_fma<T, D, DV>, smem, &kv_configured);
  if (err == cudaSuccess) err = allow_smem(bwd_dq_fma<T, D, DV>, smem,
                                           &q_configured);
  if (err != cudaSuccess) return (int)err;
  int rc = launch_rows<T, DV>(a);
  if (rc) return rc;
  bwd_dkdv_fma<T, D, DV><<<dim3((a.Tk + FB - 1) / FB, a.Hk, a.B), THREADS,
                           smem, a.stream>>>(a.q, a.k, a.v, a.dout, a.rows,
                                             a.dk, a.dv, a.st, a.H, a.Hk,
                                             a.S, a.Tk, a.scale, a.causal,
                                             a.window);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  bwd_dq_fma<T, D, DV><<<dim3((a.S + FB - 1) / FB, a.H, a.B), THREADS,
                         smem, a.stream>>>(a.q, a.k, a.v, a.dout, a.rows,
                                           a.dq, a.st, a.H, a.Hk, a.S, a.Tk,
                                           a.scale, a.causal, a.window);
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
          const T* dout, const float* lse, float* rows, T* dq, T* dk,
          T* dv, const long long* strides, int B, int H, int Hk, int S,
          int Tk, int D, int DV, float scale, int causal, int window,
          cudaStream_t stream) {
  a = Args<T>{q, k, v, o, dout, lse, rows, dq, dk, dv,
              layouts_from(strides), B, H, Hk, S, Tk, D, DV, scale, causal,
              window, stream};
  // Heads and batch rows run on the grid's y and z axes; a window needs S
  // <= T, as the forward's.
  return !(B <= 0 || S <= 0 || Tk <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0
           || H > 65535 || B > 65535 || window < 0 || (window > 0 && S > Tk));
}

}  // namespace

// strides: 24 element strides (batch, head, row) of q, k, v, out, dout, dq,
// dk, dv.  lse: the forward's (B, H, S) float32 row log-sum-exp; rows a
// (B, H, S padded to whole 64-row tiles, 2) float32 scratch (the pre-pass's
// row records).  (D, DV): (D, D) for D one of 8, 16, 32, 40,
// 64, 80, 128, 192, or (192, 128) or (24, 16) (any other ->
// cudaErrorInvalidValue); B, S, Tk > 0 (the wrapper returns zero gradients
// for an empty problem without a launch).  window > 0: query s sees key t
// only when s - t < window, as in the forward (needs S <= Tk).
extern "C" int flash_attn_bwd_f32(const float* q, const float* k,
                                  const float* v, const float* o,
                                  const float* dout, const float* lse,
                                  float* rows, float* dq, float* dk,
                                  float* dv, const long long* strides, int B,
                                  int H, int Hk, int S, int Tk, int D, int DV,
                                  float scale, int causal, int window,
                                  cudaStream_t stream) {
  Args<float> a;
  if (!fill(a, q, k, v, o, dout, lse, rows, dq, dk, dv, strides, B, H, Hk,
            S, Tk, D, DV, scale, causal, window, stream))
    return (int)cudaErrorInvalidValue;
  if (D == 192 && DV == 128) return launch_fma<float, 192, 128>(a);
  if (D == 24 && DV == 16) return launch_fma<float, 24, 16>(a);
  if (DV != D) return (int)cudaErrorInvalidValue;
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

// keys, group, grid, the key-tile and query-tile orders and their lengths:
// bwd_plan's keys a dK/dV block, KV heads a launch group, dK/dV grid and
// tiles longest walk first at the wgmma pairs ((64, 64), (128, 128) and
// (192, 128)), ignored at the others.
extern "C" int flash_attn_bwd_bf16(const bf16* q, const bf16* k,
                                   const bf16* v, const bf16* o,
                                   const bf16* dout, const float* lse,
                                   float* rows, bf16* dq, bf16* dk, bf16* dv,
                                   const long long* strides, int B, int H,
                                   int Hk, int S, int Tk, int D, int DV,
                                   float scale, int causal, int window,
                                   int keys, int group, long long grid,
                                   const unsigned short* kt_order,
                                   int n_kt_order,
                                   const unsigned short* qt_order,
                                   int n_q_order, cudaStream_t stream) {
  Args<bf16> a;
  if (!fill(a, q, k, v, o, dout, lse, rows, dq, dk, dv, strides, B, H, Hk,
            S, Tk, D, DV, scale, causal, window, stream))
    return (int)cudaErrorInvalidValue;
  // Multi-head latent attention: DeepSeek-V3's pair on the wgmma kernels
  // (dkdv_split), its smoke config's on the FMAs (24 is no multiple of
  // 16).
  if (D == 192 && DV == 128)
    return launch_wgmma<192, 128>(a, keys, group, grid, kt_order,
                                  n_kt_order, qt_order, n_q_order);
  if (D == 24 && DV == 16) return launch_fma<bf16, 24, 16>(a);
  if (DV != D) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 8: return launch_fma<bf16, 8>(a);
    case 16: return launch_mma<16>(a);
    case 32: return launch_mma<32>(a);
    case 40: return launch_fma<bf16, 40>(a);
    case 64:
      return launch_wgmma<64, 64>(a, keys, group, grid, kt_order, n_kt_order,
                                  qt_order, n_q_order);
    case 80: return launch_mma<80>(a);
    case 128:
      return launch_wgmma<128, 128>(a, keys, group, grid, kt_order,
                                    n_kt_order, qt_order, n_q_order);
    // dK and dV of 64 keys at 192 features need 192 float32 registers a
    // thread beside the scores: the mma.sync kernels.
    case 192: return launch_mma<192>(a);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the wgmma kernels at (D, DV): which 0 the dK/dV
// kernel, 1 the dQ kernel (0 at a pair without them).
extern "C" int flash_attn_bwd_wgmma_smem(int D, int DV, int which) {
  if (D == 192 && DV == 128)
    return which ? BwdShape<192, 128>::DQ_SMEM : BwdShape<192, 128>::KV_SMEM;
  if (DV != D) return 0;
  switch (D) {
    case 64: return which ? BwdShape<64, 64>::DQ_SMEM
                          : BwdShape<64, 64>::KV_SMEM;
    case 128: return which ? BwdShape<128, 128>::DQ_SMEM
                           : BwdShape<128, 128>::KV_SMEM;
  }
  return 0;
}

extern "C" const char* flash_attn_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
