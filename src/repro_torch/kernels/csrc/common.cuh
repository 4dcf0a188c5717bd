// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float NEG_INF = -1e30f;   // the reference's mask value

// dtype codes passed from Python (kernels/build.py keeps the same table)
enum DType : int { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// Load 8 consecutive elements (16-byte aligned for bf16, 32 for f32).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* out) {
  float4 a = reinterpret_cast<const float4*>(p)[0];
  float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

}  // namespace repro

// Dispatch a head_dim known at compile time; unsupported values return
// cudaErrorInvalidValue (the Python wrapper checks first and raises).
#define REPRO_DISPATCH_D(D, ...)                          \
  switch (D) {                                            \
    case 16: { constexpr int kD = 16; __VA_ARGS__ } break;   \
    case 32: { constexpr int kD = 32; __VA_ARGS__ } break;   \
    case 64: { constexpr int kD = 64; __VA_ARGS__ } break;   \
    case 80: { constexpr int kD = 80; __VA_ARGS__ } break;   \
    case 96: { constexpr int kD = 96; __VA_ARGS__ } break;   \
    case 112: { constexpr int kD = 112; __VA_ARGS__ } break; \
    case 128: { constexpr int kD = 128; __VA_ARGS__ } break; \
    case 256: { constexpr int kD = 256; __VA_ARGS__ } break; \
    default: return (int)cudaErrorInvalidValue;           \
  }
