/* powf_host: out[i] = powf(x[i], y) through the C library of the host.
 *
 * The plain version of csrc/powf.cu: one call over a whole buffer, so
 * the host's powf runs in a C loop rather than once per Python call.
 * Built with the host's C compiler (no CUDA) beside the kernels.  No
 * fast-math and no vectorization, so each element is one call of the
 * library's scalar powf, the function the kernel must equal.
 */
#include <math.h>

int powf_host(const float *x, float y, float *out, long long n) {
  for (long long i = 0; i < n; ++i) out[i] = powf(x[i], y);
  return 0;
}
