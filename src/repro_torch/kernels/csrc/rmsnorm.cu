// Row RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py (rmsnorm_fwd
// / _kernel).  Same function: y = x * rsqrt(mean(x^2) + eps) * scale, with
// f32 math and the output in x's dtype.
//
// Design.  One CTA of 256 threads per row: each thread sums the squares of
// a strided slice in f32, the CTA reduces through warp shuffles and shared
// memory, and a second pass over the row (now in L1/L2) writes the output.
// The TPU's row tiling (block_rows) has no counterpart: rows are
// independent, so the grid is simply one CTA per row.
//
// Bound.  Pure data movement: each x element is read once and each output
// written once, 2 * N * d * itemsize bytes (+ d for the scale).  At
// (2048, 2560) bf16 that is 21 MB, ~0.006 ms at 3.35 TB/s.
//
// CUDA C++ rather than Triton, which a reduction would allow: the port's
// build is nvcc + ctypes, and a Triton kernel could no more be checked
// without the card than this one.
#include "common.cuh"

namespace {

using repro::from_f;
using repro::to_f;

constexpr int NT = 256;

template <typename T, typename TS>
__global__ void __launch_bounds__(NT) rmsnorm_kernel(
    const T* __restrict__ x, const TS* __restrict__ scale, T* __restrict__ y,
    int d, int64_t x_rs, int64_t y_rs, float eps) {
  __shared__ float red[NT / 32];
  const T* xr = x + (int64_t)blockIdx.x * x_rs;
  T* yr = y + (int64_t)blockIdx.x * y_rs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float ss = 0.f;
  for (int i = tid; i < d; i += NT) {
    const float v = to_f(xr[i]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < NT / 32 ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (lane == 0) red[0] = ss;
  }
  __syncthreads();
  const float r = rsqrtf(red[0] / (float)d + eps);
  for (int i = tid; i < d; i += NT)
    yr[i] = from_f<T>(to_f(xr[i]) * r * to_f(scale[i]));
}

template <typename T, typename TS>
int launch(const void* x, const void* scale, void* y, int N, int d,
           int64_t x_rs, int64_t y_rs, float eps, cudaStream_t stream) {
  rmsnorm_kernel<T, TS><<<N, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const TS*>(scale),
      static_cast<T*>(y), d, x_rs, y_rs, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (N, d) with row strides x_rs / y_rs and a contiguous last axis;
// scale: contiguous (d,).  dtype / scale_dtype: 0 = f32, 1 = bf16.
int repro_rmsnorm_fwd(const void* x, const void* scale, void* y, int dtype,
                      int scale_dtype, int N, int d, int64_t x_rs,
                      int64_t y_rs, float eps, void* stream) {
  if (N < 1 || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == repro::F32 && scale_dtype == repro::F32)
    return launch<float, float>(x, scale, y, N, d, x_rs, y_rs, eps, s);
  if (dtype == repro::F32 && scale_dtype == repro::BF16)
    return launch<float, bf16>(x, scale, y, N, d, x_rs, y_rs, eps, s);
  if (dtype == repro::BF16 && scale_dtype == repro::F32)
    return launch<bf16, float>(x, scale, y, N, d, x_rs, y_rs, eps, s);
  if (dtype == repro::BF16 && scale_dtype == repro::BF16)
    return launch<bf16, bf16>(x, scale, y, N, d, x_rs, y_rs, eps, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_rmsnorm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
