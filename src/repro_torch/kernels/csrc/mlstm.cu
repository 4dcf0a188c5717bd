// Stabilized chunkwise mLSTM forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm.py
// (mlstm_chunkwise_fwd / _kernel).  Same per-chunk math (that of
// repro.models.xlstm.mlstm_chunk): for a chunk of c rows with b = cumsum(lf),
// D[j,l] = li_l + b_j - b_l for l <= j and -30 above the diagonal,
// m_j = max(max_l D[j,l], m + b_j), S = exp(D - m_j) * (q k^T),
// h = (S v + exp(m + b_j - m_j) q C) / max(|exp(m + b_j - m_j) q.n +
// sum_l S[j,l]|, exp(-m_j)), then the state (C, n, m) moves to the chunk's
// end.  q is pre-scaled; all inputs, the state and h are f32, and every
// product is f32 FMA (no TF32), as the reference's f32 dots.
//
// Design.  The TPU kernel keeps C (dh x dh f32) in VMEM for one (b, h); at
// xlstm-125m dh = 384, so C is 576 KB, more than the 227 KB of shared
// memory a Hopper CTA may have.  But columns of C, of num and of h depend
// only on the same columns of v (and of C); the scores, the denominator,
// n and m depend only on q, k, li and lf.  So each CTA owns (b, h, a tile
// of 64 value columns): its 384 x 64 f32 slice of C (96 KB) lives in shared
// memory for the whole sequence, and every CTA of a (b, h) recomputes the
// same scores, n and m (same arithmetic, so the same bits).  At B=1, H=4,
// dh=384 that gives 24 CTAs.  The kernel's own chunk is C = 64 rows (the
// clause's chunk is not read; results do not depend on it beyond rounding
// and the -30 mask terms, test_mlstm_chunk_invariance).  Per chunk:
//   1. one thread forms the gate quantities (cumsum, the row max m_j as a
//      prefix max of li_l - b_l, the state and key weights, the carry),
//      which need no q.k product;
//   2. the key dim is walked in slabs of 32: q and k slabs are staged in
//      shared memory and 256 threads accumulate 4 x 4 tiles of q k^T and of
//      q C (and q.n);
//   3. P = exp(D - m_j) * (q k^T) goes to shared memory, then P v and the
//      normalisation give h;
//   4. C and n are decayed and updated from k (scaled by the key weights)
//      and the staged v tile.
// A ragged last chunk (S not a multiple of 64) is a shorter chunk.
//
// Bound.  Per (b, h) and chunk of c rows: 2c^2 dh (q k^T) + 2c^2 dh (P v)
// + 2c dh^2 (q C) + 2c dh^2 (C update) flops, 5.6 GFLOP per call at
// (1, 4, 2048, 384) with c = 64, against 50 MB of q, k, v and h: bound
// by operations at the f32 rate outside the tensor cores (67 TFLOP/s,
// 0.084 ms).  The design recomputes q k^T in each of the dh / 64 value
// tiles; tensor-core (TF32 or split-bf16) products are later work.
#include "common.cuh"

namespace {

constexpr int CH = 64;      // chunk rows
constexpr int VT = 64;      // value columns per CTA
constexpr int DS = 32;      // key-dim slab
constexpr int NT = 256;     // 16 x 16 threads, 4 x 4 outputs each
constexpr int MAX_DH = 512;
constexpr float LOG_EPS = -30.f;
constexpr float NEG_BIG = -3.0e38f;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

size_t smem_floats(int dh) {
  const int dkp = round_up(dh, DS);
  // Cs, ns, Qs, Ks, Ps, Vs, 5 gate rows + carry
  return (size_t)dkp * VT + dkp + 2 * CH * (DS + 1) + CH * (CH + 1) +
         CH * VT + 5 * CH + 1;
}

__global__ void __launch_bounds__(NT) mlstm_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ li,
    const float* __restrict__ lf, float* __restrict__ h, int S, int dh,
    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
    int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t i_sb,
    int64_t i_sh, int64_t i_ss, int64_t f_sb, int64_t f_sh, int64_t f_ss,
    int64_t h_sb, int64_t h_sh, int64_t h_ss) {
  constexpr int QP = DS + 1;   // padded slab rows
  constexpr int PP = CH + 1;
  const int dkp = round_up(dh, DS);
  extern __shared__ float smem[];
  float* Cs = smem;                 // dkp x VT: this CTA's columns of C
  float* ns = Cs + dkp * VT;        // dkp
  float* Qs = ns + dkp;             // CH x QP
  float* Ks = Qs + CH * QP;         // CH x QP
  float* Ps = Ks + CH * QP;         // CH x PP
  float* Vs = Ps + CH * PP;         // CH x VT
  float* g_li = Vs + CH * VT;       // li of the chunk
  float* g_b = g_li + CH;           // lf, then its cumsum
  float* g_m = g_b + CH;            // m_j
  float* g_sw = g_m + CH;           // exp(m + b_j - m_j)
  float* g_kw = g_sw + CH;          // exp(li_l + total - b_l - m_new)
  float* g_carry = g_kw + CH;       // exp(m + total - m_new)

  const int v0 = blockIdx.x * VT;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* qb = q + bb * q_sb + hh * q_sh;
  const float* kb = k + bb * k_sb + hh * k_sh;
  const float* vb = v + bb * v_sb + hh * v_sh;
  const float* ib = li + bb * i_sb + hh * i_sh;
  const float* fb = lf + bb * f_sb + hh * f_sh;
  float* hb = h + bb * h_sb + hh * h_sh;

  for (int i = tid; i < dkp * VT; i += NT) Cs[i] = 0.f;
  for (int i = tid; i < dkp; i += NT) ns[i] = 0.f;
  float m_run = 0.f;          // the state's m, kept by thread 0

  for (int t0 = 0; t0 < S; t0 += CH) {
    const int cl = min(CH, S - t0);
    __syncthreads();          // the previous chunk is done with smem
    if (tid < CH) {
      g_li[tid] = tid < cl ? ib[(int64_t)(t0 + tid) * i_ss] : 0.f;
      g_b[tid] = tid < cl ? fb[(int64_t)(t0 + tid) * f_ss] : 0.f;
    }
    __syncthreads();
    // 1. gate quantities (O(c), serial: a few microseconds per chunk)
    if (tid == 0) {
      float cum = 0.f, pm = NEG_BIG;
      for (int j = 0; j < cl; ++j) {
        cum += g_b[j];
        g_b[j] = cum;
        pm = fmaxf(pm, g_li[j] - cum);     // max_{l<=j} D[j,l] = cum + pm
        float mj = fmaxf(cum + pm, m_run + cum);
        if (j < cl - 1) mj = fmaxf(mj, LOG_EPS);   // masked entries of row j
        g_m[j] = mj;
        g_sw[j] = expf(m_run + cum - mj);
      }
      const float total = cum;
      float mx = NEG_BIG;
      for (int l = 0; l < cl; ++l) mx = fmaxf(mx, g_li[l] + (total - g_b[l]));
      const float m_new = fmaxf(m_run + total, mx);
      g_carry[0] = expf(m_run + total - m_new);
      for (int l = 0; l < cl; ++l)
        g_kw[l] = expf(g_li[l] + (total - g_b[l]) - m_new);
      m_run = m_new;
    }

    // 2. q k^T, q C and q.n over key-dim slabs
    float s[4][4], a[4][4], qn[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qn[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = a[i][j] = 0.f;
    }
    for (int d0 = 0; d0 < dkp; d0 += DS) {
      __syncthreads();        // slabs consumed; gates visible
      for (int idx = tid; idx < CH * DS; idx += NT) {
        const int r = idx / DS, cc = idx - (idx / DS) * DS;
        const bool in = r < cl && d0 + cc < dh;
        const int64_t t = t0 + r;
        Qs[r * QP + cc] = in ? qb[t * q_ss + d0 + cc] : 0.f;
        Ks[r * QP + cc] = in ? kb[t * k_ss + d0 + cc] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int cc = 0; cc < DS; ++cc) {
        float qv[4], kv[4], cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QP + cc];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kv[j] = Ks[(tx + 16 * j) * QP + cc];
          cv[j] = Cs[(d0 + cc) * VT + tx + 16 * j];
        }
        const float nv = ns[d0 + cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qn[i] = fmaf(qv[i], nv, qn[i]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            a[i][j] = fmaf(qv[i], cv[j], a[i][j]);
          }
        }
      }
    }

    // 3. P = exp(D - m_j) * (q k^T); row sums; P v; h
    float rs[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = ty + 16 * i;
      rs[i] = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int l = tx + 16 * jj;
        float p = 0.f;
        if (j < cl && l < cl) {
          const float dv = l <= j ? g_li[l] + g_b[j] - g_b[l] : LOG_EPS;
          p = expf(dv - g_m[j]) * s[i][jj];
        }
        Ps[j * PP + l] = p;
        rs[i] += p;
      }
      // the 16 threads of a row are lanes 0-15 or 16-31 of one warp
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], off);
    }
    for (int idx = tid; idx < CH * VT; idx += NT) {
      const int r = idx / VT, cc = idx - (idx / VT) * VT;
      Vs[idx] = r < cl && v0 + cc < dh
                    ? vb[(int64_t)(t0 + r) * v_ss + v0 + cc] : 0.f;
    }
    __syncthreads();
    float o[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) o[i][jj] = 0.f;
    for (int l = 0; l < cl; ++l) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PP + l];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float vv = Vs[l * VT + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][jj] = fmaf(pv[i], vv, o[i][jj]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = ty + 16 * i;
      if (j < cl) {
        const float sw = g_sw[j];
        const float den = fmaxf(fabsf(qn[i] * sw + rs[i]), expf(-g_m[j]));
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int col = v0 + tx + 16 * jj;
          if (col < dh)
            hb[(int64_t)(t0 + j) * h_ss + col] = (o[i][jj] + sw * a[i][jj]) /
                                                 den;
        }
      }
    }

    // 4. state update (not needed after the last chunk)
    if (t0 + CH < S) {
      const float carry = g_carry[0];
      for (int d0 = 0; d0 < dkp; d0 += DS) {
        __syncthreads();      // Ks free; all reads of Cs / ns are done
        for (int idx = tid; idx < CH * DS; idx += NT) {
          const int r = idx / DS, cc = idx - (idx / DS) * DS;
          Ks[r * QP + cc] = r < cl && d0 + cc < dh
              ? g_kw[r] * kb[(int64_t)(t0 + r) * k_ss + d0 + cc] : 0.f;
        }
        __syncthreads();
        const int cc = tid >> 3;               // key row of C in the slab
        float acc[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = 0.f;
        for (int l = 0; l < cl; ++l) {
          const float kv = Ks[l * QP + cc];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[e] = fmaf(kv, Vs[l * VT + (tid & 7) + 8 * e], acc[e]);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float* cp = Cs + (d0 + cc) * VT + (tid & 7) + 8 * e;
          *cp = carry * *cp + acc[e];
        }
        if (tid < DS) {
          float sum = 0.f;
          for (int l = 0; l < cl; ++l) sum += Ks[l * QP + tid];
          ns[d0 + tid] = carry * ns[d0 + tid] + sum;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

int repro_mlstm_chunk() { return CH; }
int repro_mlstm_max_dh() { return MAX_DH; }

// q, k, v: (B, H, S, dh) f32 with element strides (b, h, s) in st[0..8]
// and a contiguous last axis; li, lf: (B, H, S) f32, strides st[9..14];
// h: (B, H, S, dh) f32, strides st[15..17].
int repro_mlstm_fwd(const float* q, const float* k, const float* v,
                    const float* li, const float* lf, float* h, int B, int H,
                    int S, int dh, const int64_t* st, void* stream) {
  if (B < 1 || H < 1 || S < 1 || dh < 1 || dh > MAX_DH)
    return (int)cudaErrorInvalidValue;
  // once: opt in to the shared memory of the largest dh (180 KB)
  static const cudaError_t attr = cudaFuncSetAttribute(
      mlstm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(smem_floats(MAX_DH) * sizeof(float)));
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = smem_floats(dh) * sizeof(float);
  dim3 grid((dh + VT - 1) / VT, H, B);
  mlstm_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, li, lf, h, S, dh, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14],
      st[15], st[16], st[17]);
  return (int)cudaGetLastError();
}

const char* repro_mlstm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
