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
// Bound: operations, but tiny — about 30 double-precision operations per
// element against 8 bytes moved; at the straggler model's sizes the
// launch dominates.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;

// log2 table: (1/c, log2 c) for 16 subintervals of [0x3f330000, 2x).
__device__ const double LOG2_T[16][2] = {
    {0x1.661ec79f8f3bep+0, -0x1.efec65b963019p-2},
    {0x1.571ed4aaf883dp+0, -0x1.b0b6832d4fca4p-2},
    {0x1.49539f0f010b0p+0, -0x1.7418b0a1fb77bp-2},
    {0x1.3c995b0b80385p+0, -0x1.39de91a6dcf7bp-2},
    {0x1.30d190c8864a5p+0, -0x1.01d9bf3f2b631p-2},
    {0x1.25e227b0b8ea0p+0, -0x1.97c1d1b3b7af0p-3},
    {0x1.1bb4a4a1a343fp+0, -0x1.2f9e393af3c9fp-3},
    {0x1.12358f08ae5bap+0, -0x1.960cbbf788d5cp-4},
    {0x1.0953f419900a7p+0, -0x1.a6f9db6475fcep-5},
    {0x1.0000000000000p+0, 0x0.0p+0},
    {0x1.e608cfd9a47acp-1, 0x1.338ca9f24f53dp-4},
    {0x1.ca4b31f026aa0p-1, 0x1.476a9543891bap-3},
    {0x1.b2036576afce6p-1, 0x1.e840b4ac4e4d2p-3},
    {0x1.9c2d163a1aa2dp-1, 0x1.40645f0c6651cp-2},
    {0x1.886e6037841edp-1, 0x1.88e9c2c1b9ff8p-2},
    {0x1.767dcf5534862p-1, 0x1.ce0a44eb17bccp-2}};
__device__ const double LOG2_A[5] = {
    0x1.27616c9496e0bp-2, -0x1.71969a075c67ap-2, 0x1.ec70a6ca7baddp-2,
    -0x1.7154748bef6c8p-1, 0x1.71547652ab82bp+0};

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

__device__ __forceinline__ double log2_inline(uint32_t ix) {
  const uint32_t tmp = ix - 0x3f330000u;
  const int i = (tmp >> 19) & 15;
  const uint32_t top = tmp & 0xff800000u;
  const uint32_t iz = ix - top;
  const int k = (int32_t)top >> 23;
  const double invc = LOG2_T[i][0], logc = LOG2_T[i][1];
  const double z = (double)__uint_as_float(iz);
  const double r = __fma_rn(z, invc, -1.0);
  const double y0 = __dadd_rn((double)k, logc);
  const double y = __fma_rn(r, LOG2_A[0], LOG2_A[1]);
  const double p = __fma_rn(r, LOG2_A[2], LOG2_A[3]);
  const double r2 = __dmul_rn(r, r);
  double q = __fma_rn(r, LOG2_A[4], y0);
  const double r4 = __dmul_rn(r2, r2);
  q = __fma_rn(r2, p, q);
  return __fma_rn(y, r4, q);
}

__device__ __forceinline__ float exp2_inline(double xd, uint32_t sign_bias) {
  double kd = __dadd_rn(xd, SHIFT);
  const uint64_t ki = (uint64_t)__double_as_longlong(kd);
  kd = __dsub_rn(kd, SHIFT);
  const double r = __dsub_rn(xd, kd);
  uint64_t t = EXP2_T[ki % 32];
  t += (ki + sign_bias) << 47;
  const double s = __longlong_as_double((long long)t);
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

__device__ float powf_libm(float x, float y) {
  uint32_t sign_bias = 0;
  uint32_t ix = __float_as_uint(x);
  const uint32_t iy = __float_as_uint(y);
  if (ix - 0x00800000u >= 0x7f800000u - 0x00800000u || zeroinfnan(iy)) {
    if (zeroinfnan(iy)) {
      if (2 * iy == 0) return is_signaling(ix) ? x + y : 1.0f;
      if (ix == 0x3f800000u) return is_signaling(iy) ? x + y : 1.0f;
      if (2 * ix > 2u * 0x7f800000u || 2 * iy > 2u * 0x7f800000u)
        return x + y;
      if (2 * ix == 2u * 0x3f800000u) return 1.0f;
      if ((2 * ix < 2u * 0x3f800000u) == !(iy & 0x80000000u)) return 0.0f;
      return __fmul_rn(y, y);
    }
    if (zeroinfnan(ix)) {
      float x2 = __fmul_rn(x, x);
      if ((ix & 0x80000000u) && checkint(iy) == 1) x2 = -x2;
      return (iy & 0x80000000u) ? __fdiv_rn(1.0f, x2) : x2;
    }
    // x and y are nonzero and finite.
    if (ix & 0x80000000u) {
      const int yint = checkint(iy);
      if (yint == 0) return __int_as_float(0x7fc00000);   // invalid
      if (yint == 1) sign_bias = SIGN_BIAS;
      ix &= 0x7fffffffu;
    }
    if (ix < 0x00800000u) {   // subnormal: normalize, negative exponent
      ix = __float_as_uint(__fmul_rn(__uint_as_float(ix), 0x1p23f));
      ix &= 0x7fffffffu;
      ix -= 23u << 23;
    }
  }
  const double logx = log2_inline(ix);
  const double ylogx = __dmul_rn((double)y, logx);
  if (((uint64_t)__double_as_longlong(ylogx) >> 47 & 0xffff)
      >= ((uint64_t)__double_as_longlong(126.0) >> 47)) {
    const uint32_t neg = sign_bias != 0;
    if (ylogx > 0x1.fffffffd1d571p+6) return xflow(neg, 0x1p97f);
    if (ylogx <= -150.0) return xflow(neg, 0x1p-95f);
    if (ylogx < -149.0) return xflow(neg, 0x1.4p-75f);
  }
  return exp2_inline(ylogx, sign_bias);
}

__global__ void __launch_bounds__(THREADS)
powf_kernel(const float* __restrict__ x, float y, float* __restrict__ out,
            long long n) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride)
    out[i] = powf_libm(__ldg(x + i), y);
}

}  // namespace

extern "C" int powf_f32(const float* x, float y, float* out, long long n,
                        cudaStream_t stream) {
  if (n == 0) return 0;
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  powf_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(x, y, out, n);
  return (int)cudaGetLastError();
}

extern "C" const char* powf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
