// RG-LRU linear recurrence h_t = exp(log_a_t) * h_{t-1} + b_t for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru.py (rglru_fwd /
// _kernel).  Same function: f32 inputs (B, S, dr), h_0 = 0, f32 output.
//
// Design.  The TPU kernel builds an O(c^2 * bd) closed form per chunk so
// that its matrix unit has work; on the GPU that is wasted arithmetic.
// Here the recurrence is a plain scan along S, one thread per (batch,
// channel): 32 channels per CTA, so a warp's loads of one time step are
// 128 contiguous bytes.  Each thread issues the loads of T time steps
// before it uses any of them, which keeps 2T loads in flight to hide the
// memory latency that the serial dependence on h would otherwise expose.
// Any S is accepted (odd S included).
//
// Bound.  Two f32 arrays are read and one is written once: at recurrentgemma
// prefill (1, 2048, 2560) that is 63 MB, ~0.019 ms at 3.35 TB/s.  With one
// thread per channel only dr / 32 = 80 CTAs run, on 80 of 132 SMs; the
// split-S design (chunk-local scans, then a carry pass) is later work.
#include "common.cuh"

namespace {

constexpr int NT = 32;   // channels per CTA
constexpr int T = 32;    // time steps loaded ahead

__global__ void __launch_bounds__(NT) rglru_kernel(
    const float* __restrict__ log_a, const float* __restrict__ b,
    float* __restrict__ h, int S, int dr) {
  const int c = blockIdx.x * NT + threadIdx.x;
  if (c >= dr) return;
  const int64_t base = (int64_t)blockIdx.y * S * dr + c;
  const float* la = log_a + base;
  const float* bb = b + base;
  float* hh = h + base;
  float acc = 0.f;
  for (int t0 = 0; t0 < S; t0 += T) {
    float a_r[T], b_r[T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int t = t0 + i;
      a_r[i] = t < S ? la[(int64_t)t * dr] : 0.f;
      b_r[i] = t < S ? bb[(int64_t)t * dr] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int t = t0 + i;
      if (t < S) {
        acc = fmaf(expf(a_r[i]), acc, b_r[i]);
        hh[(int64_t)t * dr] = acc;
      }
    }
  }
}

}  // namespace

extern "C" {

// log_a, b, h: contiguous (B, S, dr) f32.
int repro_rglru_fwd(const float* log_a, const float* b, float* h, int B,
                    int S, int dr, void* stream) {
  if (B < 1 || S < 1 || dr < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((dr + NT - 1) / NT, B);
  rglru_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      log_a, b, h, S, dr);
  return (int)cudaGetLastError();
}

const char* repro_rglru_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
