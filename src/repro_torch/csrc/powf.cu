// powf: out[i] = x[i] ** y in float32, bit for bit the C library's powf.
//
// Replaces the host step of the Pareto straggler model
// (src/repro/core/workloads.py::straggler_arrivals, `** (-1.0 / alpha)`),
// where XLA's CPU backend calls the C library's powf.  glibc's powf (2.28
// and later, sysdeps/ieee754/flt-32/e_powf.c, from Arm's
// optimized-routines) is not correctly rounded, so matching it means
// doing what it does: log2(x) from a 16-entry (1/c, log2 c) table and a
// degree-5 polynomial, y * log2(x), and 2^t from a 32-entry table and a
// degree-3 polynomial, all in double precision, rounded once to float.
//
// The operations follow the x86-64 build glibc 2.36 picks on a CPU with
// FMA (__powf_fma): every multiply-add it fuses (vfmadd) is __fma_rn
// here, every other step an explicitly rounded __dmul_rn / __dadd_rn /
// __dsub_rn, so nvcc's own contraction cannot change a result.  The
// constants were read from that build's .rodata (the addresses its
// disassembly references); the exp2 table also equals
// asuint64(2^(i/32)) - (i << 47) exactly, which checks the reading.
// Special cases (zero, subnormal, negative, infinite and NaN operands,
// overflow and underflow) follow the C source in round-to-nearest; NaN
// payloads may differ from the host's.
//
// Design.  Large arrays take powf_vec_kernel: each thread holds two
// 16-byte packs of bases (__ldcs, streaming) and loads the next trip's
// packs before it computes this trip's, so 32 bytes a thread stay in
// flight; it runs the special-case tests of its 8 bases, and when none
// applies (the Pareto draws) their 8 log2 / exp2 chains as one
// straight-line block, overflow and underflow selected rather than
// branched to, so independent FP64 chains interleave; it stores with
// __stcs.  Two waves of resident blocks (three 256-thread blocks an SM)
// walk the array; each block first copies the two tables into shared
// memory.  The conversions of k and z to double are bit moves and one
// add (int_to_double, normal_to_double), and exp2 adds the exponent in
// the high word only, so the FP64 pipe's slow conversions drop to one a
// base.  A base pointer off 16 bytes takes a scalar prologue (the
// wrapper allocates `out` with the same offset), the last n % 4 bases a
// scalar epilogue.  Arrays under one trip of one block per SM take
// powf_scalar_kernel, one base a thread over many SMs, which keeps the
// straggler model's 8192 bases as fast as before.
//
// Bound at 2^24 bases (the larger of two): bytes, 8 a base at 3.35 TB/s,
// 0.0401 ms; the FP64 pipe, 23 instructions a base (9 fused multiply-
// adds, 5 adds, 5 multiplies, 4 compares; cuobjdump -sass) at 64 a clock
// per SM, plus one conversion at 16, 0.027 ms at 1.98 GHz.  On an H100
// SXM at 700 W (examples/kernel_times.py --only powf, in turns with the
// previous one-base-a-thread kernel in one run) it takes 0.0494 ms (81 %
// of the bytes bound) against torch.pow's 0.0516 and the previous
// kernel's 0.0673; at 8192 bases 0.0021 ms against 0.0022.  Tables
// gathered from device memory, tables read by __shfl_sync (registers
// spilled), one or four packs a thread, one wave or one block a trip,
// and no prefetch were slower when the design was chosen.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PACKS = 2;   // 16-byte packs of bases a thread a trip

// log2 table: (1/c, log2 c) for 16 subintervals of [0x3f330000, 2x).
__device__ const double LOG2_INVC[16] = {
    0x1.661ec79f8f3bep+0, 0x1.571ed4aaf883dp+0, 0x1.49539f0f010b0p+0,
    0x1.3c995b0b80385p+0, 0x1.30d190c8864a5p+0, 0x1.25e227b0b8ea0p+0,
    0x1.1bb4a4a1a343fp+0, 0x1.12358f08ae5bap+0, 0x1.0953f419900a7p+0,
    0x1.0000000000000p+0, 0x1.e608cfd9a47acp-1, 0x1.ca4b31f026aa0p-1,
    0x1.b2036576afce6p-1, 0x1.9c2d163a1aa2dp-1, 0x1.886e6037841edp-1,
    0x1.767dcf5534862p-1};
__device__ const double LOG2_LOGC[16] = {
    -0x1.efec65b963019p-2, -0x1.b0b6832d4fca4p-2, -0x1.7418b0a1fb77bp-2,
    -0x1.39de91a6dcf7bp-2, -0x1.01d9bf3f2b631p-2, -0x1.97c1d1b3b7af0p-3,
    -0x1.2f9e393af3c9fp-3, -0x1.960cbbf788d5cp-4, -0x1.a6f9db6475fcep-5,
    0x0.0p+0, 0x1.338ca9f24f53dp-4, 0x1.476a9543891bap-3,
    0x1.e840b4ac4e4d2p-3, 0x1.40645f0c6651cp-2, 0x1.88e9c2c1b9ff8p-2,
    0x1.ce0a44eb17bccp-2};
constexpr double LOG2_A0 = 0x1.27616c9496e0bp-2;
constexpr double LOG2_A1 = -0x1.71969a075c67ap-2;
constexpr double LOG2_A2 = 0x1.ec70a6ca7baddp-2;
constexpr double LOG2_A3 = -0x1.7154748bef6c8p-1;
constexpr double LOG2_A4 = 0x1.71547652ab82bp+0;

// exp2 table: asuint64(2^(i/32)) - (i << 47).
__device__ const uint64_t EXP2_T[32] = {
    0x3ff0000000000000ull, 0x3fefd9b0d3158574ull, 0x3fefb5586cf9890full,
    0x3fef9301d0125b51ull, 0x3fef72b83c7d517bull, 0x3fef54873168b9aaull,
    0x3fef387a6e756238ull, 0x3fef1e9df51fdee1ull, 0x3fef06fe0a31b715ull,
    0x3feef1a7373aa9cbull, 0x3feedea64c123422ull, 0x3feece086061892dull,
    0x3feebfdad5362a27ull, 0x3feeb42b569d4f82ull, 0x3feeab07dd485429ull,
    0x3feea47eb03a5585ull, 0x3feea09e667f3bcdull, 0x3fee9f75e8ec5f74ull,
    0x3feea11473eb0187ull, 0x3feea589994cce13ull, 0x3feeace5422aa0dbull,
    0x3feeb737b0cdc5e5ull, 0x3feec49182a3f090ull, 0x3feed503b23e255dull,
    0x3feee89f995ad3adull, 0x3feeff76f2fb5e47ull, 0x3fef199bdd85529cull,
    0x3fef3720dcef9069ull, 0x3fef5818dcfba487ull, 0x3fef7c97337b9b5full,
    0x3fefa4afa2a490daull, 0x3fefd0765b6e4540ull};
constexpr double EXP2_C0 = 0x1.c6af84b912394p-5;
constexpr double EXP2_C1 = 0x1.ebfce50fac4f3p-3;
constexpr double EXP2_C2 = 0x1.62e42ff0c52d6p-1;
constexpr double SHIFT = 0x1.8p+47;   // 0x1.8p52 / 32
constexpr uint32_t SIGN_BIAS = 1u << 16;

// Where the tables are read: device memory through L1, or shared memory
// (copied once per block).
struct GlobalTables {
  __device__ double invc(int i) const { return LOG2_INVC[i]; }
  __device__ double logc(int i) const { return LOG2_LOGC[i]; }
  __device__ uint64_t exp2t(int i) const { return EXP2_T[i]; }
};

struct SharedTables {
  double* inv;
  double* lg;
  uint64_t* t;
  __device__ void init() {
    __shared__ double s_inv[16], s_lg[16];
    __shared__ uint64_t s_t[32];
    if (threadIdx.x < 16) {
      s_inv[threadIdx.x] = LOG2_INVC[threadIdx.x];
      s_lg[threadIdx.x] = LOG2_LOGC[threadIdx.x];
    }
    if (threadIdx.x < 32) s_t[threadIdx.x] = EXP2_T[threadIdx.x];
    __syncthreads();
    inv = s_inv;
    lg = s_lg;
    t = s_t;
  }
  __device__ double invc(int i) const { return inv[i]; }
  __device__ double logc(int i) const { return lg[i]; }
  __device__ uint64_t exp2t(int i) const { return t[i]; }
};


// (double)k for |k| < 2^31, one add on the FP64 pipe instead of a
// conversion: 2^52 + 2^31 + k is exact, then 2^52 + 2^31 comes off.
__device__ __forceinline__ double int_to_double(int k) {
  return __dsub_rn(__hiloint2double(0x43300000, (int)(0x80000000u ^ k)),
                   0x1.00000800p+52);
}

// (double)f for a positive normal float, by moving its bits: the
// exponent rebiased from 127 to 1023, the mantissa shifted into place.
__device__ __forceinline__ double normal_to_double(uint32_t f) {
  return __hiloint2double((int)((f >> 3) + ((1023u - 127u) << 20)),
                          (int)(f << 29));
}

template <class Tables>
__device__ __forceinline__ double log2_inline(const Tables& tab,
                                              uint32_t ix) {
  const uint32_t tmp = ix - 0x3f330000u;
  const int i = (tmp >> 19) & 15;
  const uint32_t top = tmp & 0xff800000u;
  const uint32_t iz = ix - top;
  const int k = (int32_t)top >> 23;
  const double invc = tab.invc(i), logc = tab.logc(i);
  const double z = normal_to_double(iz);   // iz lies in [0x3f330000, 2x)
  const double r = __fma_rn(z, invc, -1.0);
  const double y0 = __dadd_rn(int_to_double(k), logc);
  const double y = __fma_rn(r, LOG2_A0, LOG2_A1);
  const double p = __fma_rn(r, LOG2_A2, LOG2_A3);
  const double r2 = __dmul_rn(r, r);
  double q = __fma_rn(r, LOG2_A4, y0);
  const double r4 = __dmul_rn(r2, r2);
  q = __fma_rn(r2, p, q);
  return __fma_rn(y, r4, q);
}

template <class Tables>
__device__ __forceinline__ float exp2_inline(const Tables& tab, double xd,
                                             uint32_t sign_bias) {
  double kd = __dadd_rn(xd, SHIFT);
  // Only the low word of ki matters: ki % 32 picks the entry, and
  // (ki + sign_bias) << 47 keeps bits 0-16 of the sum, in the high word.
  const uint32_t ki = (uint32_t)__double2loint(kd);
  kd = __dsub_rn(kd, SHIFT);
  const double r = __dsub_rn(xd, kd);
  const uint64_t t = tab.exp2t((int)(ki % 32));
  const double s = __hiloint2double(
      (int)((uint32_t)(t >> 32) + ((ki + sign_bias) << 15)), (int)(uint32_t)t);
  const double z = __fma_rn(r, EXP2_C0, EXP2_C1);
  const double r2 = __dmul_rn(r, r);
  double y = __fma_rn(r, EXP2_C2, 1.0);
  y = __fma_rn(z, r2, y);
  return __double2float_rn(__dmul_rn(y, s));
}

// 0 if not an integer, 1 if odd, 2 if even.
__device__ __forceinline__ int checkint(uint32_t iy) {
  const int e = iy >> 23 & 0xff;
  if (e < 0x7f) return 0;
  if (e > 0x7f + 23) return 2;
  if (iy & ((1u << (0x7f + 23 - e)) - 1)) return 0;
  if (iy & (1u << (0x7f + 23 - e))) return 1;
  return 2;
}

__device__ __forceinline__ bool zeroinfnan(uint32_t ix) {
  return 2 * ix - 1 >= 2u * 0x7f800000u - 1;
}

__device__ __forceinline__ bool is_signaling(uint32_t ix) {
  return 2 * (ix ^ 0x00400000u) > 2u * 0x7fc00000u;
}

// The C library's overflow / underflow results (math_err.c): a product
// that rounds to +-inf, +-0 or +-2^-149.
__device__ __forceinline__ float xflow(uint32_t sign, float v) {
  return __fmul_rn(sign ? -v : v, v);
}

// The special cases of powf before its core: returns true with the
// result in `out` when (x, y) is one, else leaves in `ix` the bits the
// core takes (a negative base's sign dropped, a subnormal normalized)
// and in `sign_bias` the sign of the result.
__device__ __forceinline__ bool powf_special(float x, float y, uint32_t& ix,
                                             uint32_t& sign_bias,
                                             float& out) {
  sign_bias = 0;
  ix = __float_as_uint(x);
  const uint32_t iy = __float_as_uint(y);
  if (ix - 0x00800000u >= 0x7f800000u - 0x00800000u || zeroinfnan(iy)) {
    if (zeroinfnan(iy)) {
      if (2 * iy == 0) {
        out = is_signaling(ix) ? x + y : 1.0f;
      } else if (ix == 0x3f800000u) {
        out = is_signaling(iy) ? x + y : 1.0f;
      } else if (2 * ix > 2u * 0x7f800000u || 2 * iy > 2u * 0x7f800000u) {
        out = x + y;
      } else if (2 * ix == 2u * 0x3f800000u) {
        out = 1.0f;
      } else if ((2 * ix < 2u * 0x3f800000u) == !(iy & 0x80000000u)) {
        out = 0.0f;
      } else {
        out = __fmul_rn(y, y);
      }
      return true;
    }
    if (zeroinfnan(ix)) {
      float x2 = __fmul_rn(x, x);
      if ((ix & 0x80000000u) && checkint(iy) == 1) x2 = -x2;
      out = (iy & 0x80000000u) ? __fdiv_rn(1.0f, x2) : x2;
      return true;
    }
    // x and y are nonzero and finite.
    if (ix & 0x80000000u) {
      const int yint = checkint(iy);
      if (yint == 0) {
        out = __int_as_float(0x7fc00000);   // invalid
        return true;
      }
      if (yint == 1) sign_bias = SIGN_BIAS;
      ix &= 0x7fffffffu;
    }
    if (ix < 0x00800000u) {   // subnormal: normalize, negative exponent
      ix = __float_as_uint(__fmul_rn(__uint_as_float(ix), 0x1p23f));
      ix &= 0x7fffffffu;
      ix -= 23u << 23;
    }
  }
  return false;
}

// The core of powf for a base that is not a special case: log2, the
// product, then exp2 or the overflow / underflow result (selected, not
// branched to).
template <class Tables>
__device__ __forceinline__ float powf_core(const Tables& tab, uint32_t ix,
                                           float y, uint32_t sign_bias) {
  const double logx = log2_inline(tab, ix);
  const double ylogx = __dmul_rn((double)y, logx);
  float r = exp2_inline(tab, ylogx, sign_bias);
  const uint32_t neg = sign_bias != 0;
  const bool big = ((uint64_t)__double_as_longlong(ylogx) >> 47 & 0xffff)
                   >= ((uint64_t)__double_as_longlong(126.0) >> 47);
  if (big && ylogx > 0x1.fffffffd1d571p+6) r = xflow(neg, 0x1p97f);
  if (big && ylogx <= -150.0) r = xflow(neg, 0x1p-95f);
  if (big && ylogx > -150.0 && ylogx < -149.0) r = xflow(neg, 0x1.4p-75f);
  return r;
}

// powf of N bases held by one thread.  When every base is positive,
// normal and finite and y is not zero, infinite or NaN (the Pareto
// draws), no special case can arise: the N cores run as one
// straight-line block.  Otherwise each base takes its special-case
// tests first.
template <int N, class Tables>
__device__ __forceinline__ void powf_n(const Tables& tab, float* v,
                                       float y) {
  bool plain = !zeroinfnan(__float_as_uint(y));
#pragma unroll
  for (int k = 0; k < N; ++k)
    plain &= __float_as_uint(v[k]) - 0x00800000u
             < 0x7f800000u - 0x00800000u;
  if (plain) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      v[k] = powf_core(tab, __float_as_uint(v[k]), y, 0u);
    return;
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    uint32_t ix, sb;
    float sp;
    if (powf_special(v[k], y, ix, sb, sp))
      v[k] = sp;
    else
      v[k] = powf_core(tab, ix, y, sb);
  }
}

// One base a thread, tables read from device memory (they stay in L1):
// small arrays, where a call is one short chain of latency per thread.
// The loop bound is uniform across the block (lanes past n compute on
// 1.0 and store nothing).
__global__ void __launch_bounds__(THREADS)
powf_scalar_kernel(const float* __restrict__ x, float y,
                   float* __restrict__ out, long long n) {
  const GlobalTables tab{};
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long base = (long long)blockIdx.x * THREADS; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    float v = i < n ? __ldg(x + i) : 1.0f;
    powf_n<1>(tab, &v, y);
    if (i < n) out[i] = v;
  }
}

// PACKS 16-byte packs a thread a trip, the next trip's packs loaded
// before this trip's arithmetic: `head` scalar bases first (until
// x + head is 16-byte aligned; out has the same offset), then the packs,
// then the n % 4 bases left, the ragged ends in warp 0 of block 0.
// Three blocks an SM (at most 85 registers a thread).
__global__ void __launch_bounds__(THREADS, 3)
powf_vec_kernel(const float* __restrict__ x, float y,
                float* __restrict__ out, long long n, int head) {
  SharedTables tab;
  tab.init();
  const long long nv = (n - head) / 4;
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    const int t = threadIdx.x;
    const int tail = (int)(n - head - nv * 4);
    const long long i = t < head ? t
                        : t < head + tail ? head + nv * 4 + (t - head)
                                          : -1;
    float v = i >= 0 ? x[i] : 1.0f;
    powf_n<1>(tab, &v, y);
    if (i >= 0) out[i] = v;
  }
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  float4* ov = reinterpret_cast<float4*>(out + head);
  const float4 ones = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  const long long step = (long long)gridDim.x * THREADS * PACKS;
  const long long first = (long long)blockIdx.x * THREADS * PACKS;
  float4 next[PACKS];
#pragma unroll
  for (int j = 0; j < PACKS; ++j) {
    const long long p = first + j * THREADS + threadIdx.x;
    next[j] = p < nv ? __ldcs(xv + p) : ones;
  }
  for (long long base = first; base < nv; base += step) {
    float v[4 * PACKS];
#pragma unroll
    for (int j = 0; j < PACKS; ++j) {
      v[4 * j] = next[j].x;
      v[4 * j + 1] = next[j].y;
      v[4 * j + 2] = next[j].z;
      v[4 * j + 3] = next[j].w;
      const long long p = base + step + j * THREADS + threadIdx.x;
      next[j] = p < nv ? __ldcs(xv + p) : ones;
    }
    powf_n<4 * PACKS>(tab, v, y);
#pragma unroll
    for (int j = 0; j < PACKS; ++j) {
      const long long p = base + j * THREADS + threadIdx.x;
      if (p < nv)
        __stcs(ov + p, make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2],
                                   v[4 * j + 3]));
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

int launch_scalar(const float* x, float y, float* out, long long n,
                  cudaStream_t stream) {
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 16LL * sm_count()) blocks = 16LL * sm_count();
  powf_scalar_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(x, y, out,
                                                                n);
  return (int)cudaGetLastError();
}

// Two waves of resident blocks walk the array.
int launch_vec(const float* x, float y, float* out, long long n,
               cudaStream_t stream) {
  const uintptr_t px = reinterpret_cast<uintptr_t>(x);
  if (((px ^ reinterpret_cast<uintptr_t>(out)) & 15) != 0 || (px & 3))
    return launch_scalar(x, y, out, n, stream);
  const int head = (int)(((16 - (px & 15)) & 15) / 4);
  const long long nv = (n - head) / 4;
  long long blocks = (nv + THREADS * PACKS - 1) / (THREADS * PACKS);
  static int per_sm = 0;
  if (per_sm == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, powf_vec_kernel,
                                                  THREADS, 0);
  const long long cap = 2LL * per_sm * sm_count();
  if (blocks > cap) blocks = cap;
  powf_vec_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(x, y, out, n,
                                                            head);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int powf_f32(const float* x, float y, float* out, long long n,
                        cudaStream_t stream) {
  if (n == 0) return 0;
  // Below one run of packs a resident block per SM, one base a thread
  // spreads the call over more SMs.
  if (n < (long long)THREADS * PACKS * 4 * sm_count())
    return launch_scalar(x, y, out, n, stream);
  return launch_vec(x, y, out, n, stream);
}

extern "C" const char* powf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
