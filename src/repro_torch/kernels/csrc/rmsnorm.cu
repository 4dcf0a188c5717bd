// Row RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py (rmsnorm_fwd
// / _kernel).  Same function: y = x * rsqrt(mean(x^2) + eps) * scale, with
// f32 math and the output in x's dtype; x is (N, d) with a contiguous last
// axis and any row stride, the scale f32 or bf16.
//
// Design.  W = ceil(d / 512) warps (at most 8) own a row, and a CTA holds
// 8 / W of them (a warp per row at d <= 512; 5 warps, one row per CTA at
// d = 2560); CTAs stride over the rows.  x is read once, in 16-byte vectors
// (8 bf16 or 4 f32), and the row stays in registers (16 elements a thread,
// 4 CTAs an SM) between the sum of squares and the write; only rows wider
// than 4096 elements read the part past the registers a second time.  The
// scale is read in the same 16-byte vectors (where its alignment allows)
// for every row, from L1: keeping it in registers for the CTA's rows (32
// more registers a thread) ran slower on the H100.  The sum is reduced by warp shuffles, and
// through shared memory only when a row spans several warps.  Any d and any row stride: a row whose base is
// not 16-byte aligned is a scalar head (up to the first aligned element),
// aligned vectors, and a scalar tail; y is stored in vectors where its rows
// share x's alignment, else element by element.  The TPU's row tiling
// (block_rows) has no counterpart: rows are independent.
//
// Bound.  Pure data movement: each x element is read once and each output
// written once, 2 * N * d * itemsize bytes (+ d for the scale).  At
// (2048, 2560) bf16 that is 21 MB, 0.0063 ms at 3.35 TB/s (f32 0.0125).
//
// CUDA C++ rather than Triton, which a reduction would allow: the port's
// build is nvcc + ctypes, and a Triton kernel could no more be checked
// without the card than this one.
#include "common.cuh"

namespace {

using repro::from_f;
using repro::to_f;

constexpr int NT = 256;
constexpr int ROW_ELEMS = 16;    // elements of a row each thread keeps

template <typename T, int N>
struct alignas(N * sizeof(T)) Pack {
  T v[N];
};

// N elements at p as floats: one vector access when vec (p aligned to the
// pack), else N scalar ones.
template <typename T, int N>
__device__ __forceinline__ void load_n(const T* p, float (&out)[N], bool vec) {
  if (vec) {
    const Pack<T, N> pk = *reinterpret_cast<const Pack<T, N>*>(p);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f(pk.v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f(p[i]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_n(T* p, const float (&in)[N], bool vec) {
  if (vec) {
    Pack<T, N> pk;
#pragma unroll
    for (int i = 0; i < N; ++i) pk.v[i] = from_f<T>(in[i]);
    *reinterpret_cast<Pack<T, N>*>(p) = pk;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = from_f<T>(in[i]);
  }
}

// Elements of T from p up to the next 16-byte boundary (at most d).
template <typename T>
__device__ __forceinline__ int head_of(const T* p, int d) {
  constexpr int E = 16 / sizeof(T);
  const int mis = (int)((reinterpret_cast<uintptr_t>(p) / sizeof(T)) % E);
  return min(d, (E - mis) % E);
}

template <typename T, typename TS>
__global__ void __launch_bounds__(NT, 4) rmsnorm_kernel(
    const T* __restrict__ x, const TS* __restrict__ scale, T* __restrict__ y,
    int N, int d, int64_t x_rs, int64_t y_rs, float eps, int W) {
  constexpr int E = 16 / sizeof(T);       // elements per 16-byte vector
  constexpr int V = ROW_ELEMS / E;        // vectors kept in registers
  __shared__ float red[NT / 32];
  const int G = W * 32;                   // threads per row
  const int R = blockDim.x / G;           // rows per CTA per pass
  const int grp = threadIdx.x / G, g = threadIdx.x - grp * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool s_vec = reinterpret_cast<uintptr_t>(scale) %
                         (E * sizeof(TS)) == 0;
  float xv[V][E];

  for (int64_t row0 = (int64_t)blockIdx.x * R; row0 < N;
       row0 += (int64_t)gridDim.x * R) {
    const int64_t row = row0 + grp;
    const bool live = row < N;
    const T* xr = x + (live ? row : 0) * x_rs;
    T* yr = y + (live ? row : 0) * y_rs;
    const int head = head_of(xr, d);
    const int nv = (d - head) / E, tail0 = head + nv * E;
    const int tail = d - tail0;
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = k * G + g;
      if (live && i < nv) {
        load_n(xr + head + i * E, xv[k], true);
#pragma unroll
        for (int e = 0; e < E; ++e) ss = fmaf(xv[k][e], xv[k][e], ss);
      }
    }
    for (int i = V * G + g; live && i < nv; i += G) {   // d > 4096 only
      float t[E];
      load_n(xr + head + i * E, t, true);
#pragma unroll
      for (int e = 0; e < E; ++e) ss = fmaf(t[e], t[e], ss);
    }
    float hv = 0.f, tv = 0.f;             // the unaligned head and tail
    if (live && g < head) hv = to_f(xr[g]);
    if (live && g < tail) tv = to_f(xr[tail0 + g]);
    ss = fmaf(hv, hv, fmaf(tv, tv, ss));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (W > 1) {
      if (lane == 0) red[warp] = ss;
      __syncthreads();
      ss = 0.f;
      for (int w = 0; w < W; ++w) ss += red[grp * W + w];
      __syncthreads();                    // red is reused by the next pass
    }
    if (!live) continue;
    const float r = rsqrtf(ss / (float)d + eps);
    const bool y_vec = head_of(yr, d) == head;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = k * G + g;
      if (i < nv) {
        float s[E];
        load_n(scale + head + i * E, s, s_vec && head == 0);
#pragma unroll
        for (int e = 0; e < E; ++e) xv[k][e] = xv[k][e] * r * s[e];
        store_n(yr + head + i * E, xv[k], y_vec);
      }
    }
    for (int i = V * G + g; i < nv; i += G) {
      float t[E], s[E];
      load_n(xr + head + i * E, t, true);
      load_n(scale + head + i * E, s, s_vec && head == 0);
#pragma unroll
      for (int e = 0; e < E; ++e) t[e] = t[e] * r * s[e];
      store_n(yr + head + i * E, t, y_vec);
    }
    if (g < head) yr[g] = from_f<T>(hv * r * to_f(scale[g]));
    if (g < tail) yr[tail0 + g] = from_f<T>(tv * r * to_f(scale[tail0 + g]));
  }
}

int num_sms() {
  static int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

template <typename T, typename TS>
int launch(const void* x, const void* scale, void* y, int N, int d,
           int64_t x_rs, int64_t y_rs, float eps, cudaStream_t stream) {
  const int W = d > 7 * 32 * ROW_ELEMS
                    ? 8 : (d + 32 * ROW_ELEMS - 1) / (32 * ROW_ELEMS);
  const int R = 8 / W;                                    // rows per CTA
  const int64_t need = ((int64_t)N + R - 1) / R;
  const int64_t cap = (int64_t)num_sms() * 16;            // CTAs stride on
  const int grid = (int)(need < cap ? need : cap);
  rmsnorm_kernel<T, TS><<<grid, W * 32 * R, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const TS*>(scale),
      static_cast<T*>(y), N, d, x_rs, y_rs, eps, W);
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
