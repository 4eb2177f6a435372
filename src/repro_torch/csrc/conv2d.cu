// 3 x 3 "same" convolution with zero padding: out (B, H, W) float32.
//
// Replaces the Pallas kernel src/repro/kernels/conv2d.py::conv2d
// (_conv_kernel), the paper's Conv2D benchmark kernel.  The TPU version
// reads a zero-padded (B, H + 2, W + 2) copy that ops.conv2d
// materializes and does nine shifted multiply-accumulates per image in
// VREGs.  Here no padded copy is made: each thread computes one output
// pixel from its 3 x 3 neighbourhood, and a neighbour outside the image
// reads as zero (a masked load).  The nine taps are summed in the
// reference's order (di outer, dj inner) as a float32 multiply and then
// an add, each rounded (explicit __fmul_rn / __fadd_rn, so nvcc does not
// fuse them): the plain PyTorch version gives the same bits.  Input is
// float32, bfloat16 or float16, converted to float32 on load; the
// kernel's nine weights are float32 in registers.
//
// Design: 32 x 8 thread blocks over (W, H), one grid z slice per image;
// the nine loads of a pixel overlap its neighbours', so all but about
// one read per pixel hit L1.
//
// Bound: bytes.  One read and one write of 4 bytes per pixel for 17
// flops: at (256, 512, 512) float32 about 537 MB, 0.16 ms at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__global__ void __launch_bounds__(BX * BY)
conv2d_kernel(const T* __restrict__ img, const float* __restrict__ kernel,
              float* __restrict__ out, int H, int W) {
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  if (i >= H || j >= W) return;
  const T* plane = img + (long long)blockIdx.z * H * W;
  float acc = 0.f;
#pragma unroll
  for (int di = 0; di < 3; ++di) {
    const int r = i + di - 1;
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      const int c = j + dj - 1;
      const float v = (r >= 0 && r < H && c >= 0 && c < W)
                          ? to_f32(plane[(long long)r * W + c]) : 0.f;
      acc = __fadd_rn(acc, __fmul_rn(__ldg(kernel + di * 3 + dj), v));
    }
  }
  out[(long long)blockIdx.z * H * W + (long long)i * W + j] = acc;
}

template <typename T>
int launch(const T* img, const float* kernel, float* out, int B, int H,
           int W, cudaStream_t stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const dim3 block(BX, BY);
  const dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY, B);
  conv2d_kernel<T><<<grid, block, 0, stream>>>(img, kernel, out, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int conv2d_f32(const float* img, const float* kernel, float* out,
                          int B, int H, int W, cudaStream_t stream) {
  return launch<float>(img, kernel, out, B, H, W, stream);
}

extern "C" int conv2d_bf16(const __nv_bfloat16* img, const float* kernel,
                           float* out, int B, int H, int W,
                           cudaStream_t stream) {
  return launch<__nv_bfloat16>(img, kernel, out, B, H, W, stream);
}

extern "C" int conv2d_f16(const __half* img, const float* kernel, float* out,
                          int B, int H, int W, cudaStream_t stream) {
  return launch<__half>(img, kernel, out, B, H, W, stream);
}

extern "C" const char* conv2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
