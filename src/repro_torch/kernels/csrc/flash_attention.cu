// Causal / sliding-window GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_fwd / _kernel).  Same function: q is scaled by D^-0.5
// before QK^T, masked scores are -1e30, p is zeroed by the mask, the
// online-softmax state (m, l, acc) is f32, l is clamped at 1e-30, and the
// output is written in q's dtype.  Query head h reads kv head h / G.
//
// Design.  One CTA per (q-tile of BQ rows, head, batch); the TPU's
// sequential k-block grid axis becomes a loop inside the CTA.  K and V
// tiles of 32 keys are staged through shared memory as f32 (the reference
// upcasts q/k/v before both dots), and both products are f32 FMA on the
// CUDA cores: 128 threads, each owning BQ/16 query rows x (4 key columns
// of S, D/8 columns of the output accumulator).  BQ is 64, and 32 for
// D=256 (recurrentgemma's heads): there a 64-row tile would hold 128 f32
// accumulators per thread and 137 KB of shared memory, one CTA per SM;
// 32 rows halve both (100 KB, two CTAs per SM).  K tiles wholly above the causal
// diagonal or wholly outside the window are skipped, which is exact: such
// a tile leaves (m, l, acc) unchanged in the reference too.  Any S is
// accepted; the ragged last tile is masked.
//
// Bound.  At the prefill shape (S=2048, H=32, D=128, bf16) the work is
// ~34 GFLOP against ~2 MB of q/k/v/o, so the kernel is bound by
// operations; f32 FMA without tensor cores is the price of this first,
// simple version (wgmma on bf16 tiles is later work).
#include "common.cuh"

namespace {

using repro::NEG_INF;
using repro::from_f;
using repro::to_f;

constexpr int BK = 32;    // keys per staged tile
constexpr int NT = 128;   // threads: 16 row groups x 8 column lanes

// query rows per CTA
template <int D>
__host__ __device__ constexpr int block_q() { return D > 128 ? 32 : 64; }

template <int D>
constexpr size_t smem_bytes() {
  // Qs (BQ x D+1) + Ks (BK x D+1) + Vs (BK x D) + Ps (BQ x BK+1), f32
  constexpr int BQ = block_q<D>();
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) fa_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int G, int Sq, int Sk,
    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
    int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb,
    int64_t o_sh, int64_t o_ss, int causal, int window, float scale) {
  constexpr int BQ = block_q<D>();
  constexpr int RQ = BQ / 16;   // query rows per thread
  constexpr int DP = D + 1;     // padded rows: column reads hit 32 banks
  constexpr int PP = BK + 1;
  constexpr int NJ = BK / 8;    // S columns per thread
  constexpr int ND = D / 8;     // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * D;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;      // rows ty*RQ .. ty*RQ+RQ-1
  const int tx = tid & 7;       // columns tx + 8*j

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  T* ob = o + b * o_sb + h * o_sh;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx - (idx / D) * D;
    const int qi = q0 + r;
    Qs[r * DP + c] = qi < Sq ? to_f(qb[qi * q_ss + c]) * scale : 0.f;
  }

  float m_i[RQ], l_i[RQ], acc[RQ][ND];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < ND; ++jj) acc[i][jj] = 0.f;
  }

  // key range that can be unmasked for some row of this tile
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_stop = causal ? min(Sk, q_last + 1) : Sk;
  const int k_start = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int k0 = (k_start / BK) * BK; k0 < k_stop; k0 += BK) {
    __syncthreads();   // the previous tile's Ks/Vs/Ps are consumed
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, c = idx - (idx / D) * D;
      const int kj = k0 + r;
      const bool in = kj < Sk;
      Ks[r * DP + c] = in ? to_f(kb[kj * k_ss + c]) : 0.f;
      Vs[r * D + c] = in ? to_f(vb[kj * v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[RQ][NJ];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[NJ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty * RQ + i) * DP + d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = Ks[(tx + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty * RQ + i;
      bool ok[NJ];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = k0 + tx + 8 * j;
        ok[j] = col < Sk && (!causal || row >= col) &&
                (window <= 0 || row - col < window);
        s[i][j] = ok[j] ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 8 lanes sharing a row are consecutive lanes of one warp
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * RQ + i) * PP + tx + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < ND; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty * RQ + i) * PP + c];
#pragma unroll
      for (int jj = 0; jj < ND; ++jj) {
        const float vv = Vs[c * D + tx + 8 * jj];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row < Sq) {
      const float inv = 1.f / fmaxf(l_i[i], 1e-30f);
#pragma unroll
      for (int jj = 0; jj < ND; ++jj)
        ob[row * o_ss + tx + 8 * jj] = from_f<T>(acc[i][jj] * inv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int Sq, int Sk, const int64_t* st, int causal,
           int window, float scale, cudaStream_t stream) {
  constexpr int BQ = block_q<D>();
  const size_t smem = smem_bytes<D>();
  // once per instantiation: opt in to more than 48 KB of shared memory
  static const cudaError_t attr = cudaFuncSetAttribute(
      fa_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H / KV, Sq, Sk, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Element strides, in order: q (b, h, s), k (b, h, s), v (b, h, s),
// o (b, h, s); the head_dim axis is contiguous in every tensor.
int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* o, int dtype, int B, int H, int KV,
                              int Sq, int Sk, int D, const int64_t* strides,
                              int causal, int window, float scale,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::BF16) {
    REPRO_DISPATCH_D(D, return launch<__nv_bfloat16, kD>(
        q, k, v, o, B, H, KV, Sq, Sk, strides, causal, window, scale, s);)
  } else if (dtype == repro::F32) {
    REPRO_DISPATCH_D(D, return launch<float, kD>(
        q, k, v, o, B, H, KV, Sq, Sk, strides, causal, window, scale, s);)
  }
  return (int)cudaErrorInvalidValue;
}

const char* repro_flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
