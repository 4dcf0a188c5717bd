// One-token attention over a KV cache (flash-decoding) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode_fwd / _kernel).  Same function: q (B,H,D) scaled by
// D^-0.5, cache slots > pos masked, softmax in f32, output in q's dtype,
// and the per-head log-sum-exp m + log(max(l, 1e-30)) in f32.
//
// Design.  The TPU kernel walks Smax sequentially inside a (B, H) grid;
// on Hopper that leaves most SMs idle at small batch, so Smax is split
// across CTAs (flash-decoding).  Pass 1: one CTA per (batch, kv head,
// 128-key chunk) reads its K/V chunk once for all G query heads of the
// group, computes the chunk's scores, its max m, sum l and unnormalized
// p.V in f32, and writes those partials.  Pass 2 combines the chunks of
// each (batch, head) with the same LSE contract that a sequence-sharded
// combine uses (tests: test_flash_decode_lse_combine).  Only chunks that
// hold a slot <= pos are launched, so the work follows pos, not Smax.
//
// Bound.  Each cache byte is used for 2G flops, so the kernel is bound by
// the bytes of the K/V prefix it reads: (pos+1) * KV * D * 2 * itemsize
// per batch row.
#include "common.cuh"

namespace {

using repro::NEG_INF;
using repro::from_f;
using repro::load8;
using repro::to_f;

constexpr int CHUNK = 128;  // keys per CTA in pass 1 (= threads)
constexpr int MAX_G = 8;    // query heads per kv head handled in registers

template <typename T, int D>
__global__ void __launch_bounds__(CHUNK) fd_partial_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, float* __restrict__ o_part,
    float* __restrict__ m_part, float* __restrict__ l_part, int H, int G,
    int n_keys, int nsplit, int64_t q_sb, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    float scale) {
  extern __shared__ float smem[];
  float* qs = smem;               // G x D, scaled
  float* sc = qs + G * D;         // G x CHUNK scores, then p
  __shared__ float m_s[MAX_G], l_s[MAX_G];

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int j0 = split * CHUNK;
  const int n_here = min(CHUNK, n_keys - j0);  // valid keys in this chunk

  for (int idx = tid; idx < G * D; idx += CHUNK) {
    const int g = idx / D, d = idx - (idx / D) * D;
    qs[idx] = to_f(q[b * q_sb + (kvh * G + g) * q_sh + d]) * scale;
  }
  __syncthreads();

  // pass 1a: one key per thread, all G heads of the group
  {
    float s[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) s[g] = 0.f;
    if (tid < n_here) {
      const T* kr = k + b * k_sb + (int64_t)(j0 + tid) * k_ss + kvh * k_sh;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 8) {
        float kv[8];
        load8(kr + d0, kv);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g < G) {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              s[g] = fmaf(qs[g * D + d0 + e], kv[e], s[g]);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) sc[g * CHUNK + tid] = tid < n_here ? s[g] : NEG_INF;
  }
  __syncthreads();

  // pass 1b: per head max, p = exp(s - m) (0 where masked), sum
  for (int g = warp; g < G; g += CHUNK / 32) {
    float mx = NEG_INF;
    for (int j = lane; j < CHUNK; j += 32) mx = fmaxf(mx, sc[g * CHUNK + j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < CHUNK; j += 32) {
      const float p = j < n_here ? expf(sc[g * CHUNK + j] - mx) : 0.f;
      sc[g * CHUNK + j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = sum;
    }
  }
  __syncthreads();

  // pass 1c: unnormalized p.V; thread -> head_dim column
  for (int d = tid; d < D; d += CHUNK) {
    float acc[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;
    const T* vc = v + b * v_sb + (int64_t)j0 * v_ss + kvh * v_sh + d;
    for (int j = 0; j < n_here; ++j) {
      const float vv = to_f(vc[j * v_ss]);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) acc[g] = fmaf(sc[g * CHUNK + j], vv, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        const int64_t row = ((int64_t)b * H + kvh * G + g) * nsplit + split;
        o_part[row * D + d] = acc[g];
      }
    }
  }
  if (tid < G) {
    const int64_t row = ((int64_t)b * H + kvh * G + tid) * nsplit + split;
    m_part[row] = m_s[tid];
    l_part[row] = l_s[tid];
  }
}

template <typename T>
__global__ void __launch_bounds__(128) fd_combine_kernel(
    const float* __restrict__ o_part, const float* __restrict__ m_part,
    const float* __restrict__ l_part, T* __restrict__ o,
    float* __restrict__ lse, int H, int D, int nsplit, int64_t o_sb,
    int64_t o_sh) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int64_t base = ((int64_t)b * H + h) * nsplit;
  float M = NEG_INF;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, m_part[base + s]);
  float L = 0.f;
  for (int s = 0; s < nsplit; ++s)
    L += expf(m_part[base + s] - M) * l_part[base + s];
  const float l = fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < nsplit; ++s)
      acc = fmaf(expf(m_part[base + s] - M), o_part[(base + s) * D + d], acc);
    o[b * o_sb + h * o_sh + d] = from_f<T>(acc / l);
  }
  if (threadIdx.x == 0 && lse != nullptr) lse[(int64_t)b * H + h] = M + logf(l);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           float* o_part, float* m_part, float* l_part, int B, int H, int KV,
           int n_keys, const int64_t* st, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const int nsplit = (n_keys + CHUNK - 1) / CHUNK;
  // at most MAX_G * (D + CHUNK) floats = 8 KB: under the 48 KB default
  const size_t smem = sizeof(float) * (G * D + G * CHUNK);
  fd_partial_kernel<T, D><<<dim3(nsplit, KV, B), CHUNK, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), o_part, m_part, l_part, H, G, n_keys, nsplit,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fd_combine_kernel<T><<<dim3(H, B), 128, 0, stream>>>(
      o_part, m_part, l_part, static_cast<T*>(o), lse, H, D, nsplit, st[8],
      st[9]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int repro_flash_decode_chunk() { return CHUNK; }
int repro_flash_decode_max_g() { return MAX_G; }

// n_keys = min(pos + 1, Smax): slots [0, n_keys) are attended.
// Element strides, in order: q (b, h), k (b, s, h), v (b, s, h), o (b, h);
// the head_dim axis is contiguous.  o_part is (B, H, nsplit, D) f32,
// m_part / l_part (B, H, nsplit) f32, lse (B, H) f32 or null.
int repro_flash_decode_fwd(const void* q, const void* k, const void* v,
                           void* o, float* lse, float* o_part, float* m_part,
                           float* l_part, int dtype, int B, int H, int KV,
                           int n_keys, int D, const int64_t* strides,
                           float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % KV != 0 || H / KV > MAX_G || n_keys < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == repro::BF16) {
    REPRO_DISPATCH_D(D, return launch<__nv_bfloat16, kD>(
        q, k, v, o, lse, o_part, m_part, l_part, B, H, KV, n_keys, strides,
        scale, s);)
  } else if (dtype == repro::F32) {
    REPRO_DISPATCH_D(D, return launch<float, kD>(
        q, k, v, o, lse, o_part, m_part, l_part, B, H, KV, n_keys, strides,
        scale, s);)
  }
  return (int)cudaErrorInvalidValue;
}

const char* repro_flash_decode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
