// Stabilized chunkwise mLSTM forward for Hopper (sm_90a), chunk-parallel on
// the tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm.py
// (mlstm_chunkwise_fwd / _kernel).  Same per-chunk math (that of
// repro.models.xlstm.mlstm_chunk): for a chunk of c rows with b = cumsum(lf),
// D[j,l] = li_l + b_j - b_l for l <= j and -30 above the diagonal,
// m_j = max(max_l D[j,l], m + b_j), S = exp(D - m_j) * (q k^T),
// h = (S v + exp(m + b_j - m_j) q C) / max(|exp(m + b_j - m_j) q.n +
// sum_l S[j,l]|, exp(-m_j)), then the state (C, n, m) moves to the chunk's
// end.  q is pre-scaled; inputs, state and h are f32.  The kernel's own
// chunk is CH = 64 rows (the clause's chunk is not read: results change with
// the chunk only by rounding and the e^-30 mask terms, which it keeps at its
// own chunk boundaries, test_mlstm_chunk_invariance).
//
// Design: the chunk-parallel form (as the xLSTM authors' "Tiled Flash
// Linear Attention" kernels), three launches per call (the first two only
// when S > 64):
//   1. mlstm_gates_kernel, one CTA per (b, h): for every full chunk, a warp
//      forms b = cumsum(lf), total, the key weights kwlog_l = li_l + total -
//      b_l, their max mx and w_l = exp(kwlog_l - mx) with warp scans; then
//      one thread carries the stabilizer across the chunks, m' = max(m +
//      total, mx), with the rescaling weights a = exp(m + total - m') and
//      bw = exp(mx - m').  Every exponent is <= 0 by construction.
//   2. mlstm_state_kernel, grid (32-key x 64-value tiles of C, H, B), four
//      warps: each CTA walks the chunks 0..NC-2 (all full) in order, forms
//      its tile of the chunk-local dC = (k * w)^T v on the tensor cores and
//      rescales the running state held in registers, C' = a C + bw dC (n
//      the same way, as a column of ones beside v).  The state entering
//      chunk c+1 goes to a workspace slot.  The chunk-local dC and the scan
//      across chunks are fused: dC never reaches device memory.  A chunk's
//      steps depend on one another (wait, product, rescale, store), so the
//      CTAs are small and share SMs: 288 at (1, 4, 2048, 384).
//   3. mlstm_out_kernel, grid (value tiles, NC, B*H): one CTA per (b, h,
//      chunk) holds all dh <= 384 value columns (64 x 384 f32 accumulators
//      over 8 warps, 235 registers a thread), so q k^T is computed once per
//      chunk.  It walks the key dim in 32-wide slabs (q, k and the entering
//      C and n fed by cp.async into a two-stage ring): q k^T and q C on the
//      tensor cores, q.n on the FMA units; then P = exp(D - m_j) * (q k^T)
//      (masked entries kept) goes to shared memory, P v is added to
//      exp(m + b_j - m_j) q C, and h is normalised.  dh > 384 takes two
//      value tiles of 256 (q k^T twice).  128 CTAs at (1, 4, 2048, 384).
// Workspace: (B*H, NC-1) slots of DP*DP + DP floats, DP = dh rounded up to
// 8, 75.5 MB at (1, 4, 2048, 384), written once and read once; plus the
// gates (a few KB).  The chunk of 64 rather than 128 halves the in-chunk
// quadratic work and doubles the CTAs of step 3 at the cost of twice the
// stored states.
//
// Arithmetic: every product (dC, q k^T, q C, P v) runs on mma.sync
// m16n8k8 TF32 from registers as a 3xTF32 split, a = hi + lo with
// hi = tf32(a), lo = tf32(a - hi), a.b ~ hi.hi' + hi.lo' + lo.hi', summed
// in f32: the reference's f32 dot contract (one TF32 pass would keep ~3
// digits).  mma.sync rather than wgmma: TF32 wgmma takes both operands
// K-major from shared memory, and v and C are N-major as they sit, so they
// would need a transposed copy; mma.sync loads its fragments from padded
// (conflict-free) shared memory in any orientation.
//
// Bound.  Per (b, h) and chunk of c rows: 2c^2 dh (q k^T) + 2c^2 dh (P v)
// + 2c dh^2 (q C, not in the first chunk) + 2c dh^2 (dC, not in the last)
// flops, 5.5 GFLOP at (1, 4, 2048, 384), x3 under the split: 0.033 ms at
// the TF32 tensor-core rate (495 TFLOP/s dense); 50 MB of q, k, v, h is
// 0.015 ms at 3.35 TB/s.  Bound by operations.  (At the f32 rate outside
// the tensor cores, 67 TFLOP/s, the same work is 0.082 ms.)
#include "common.cuh"

namespace {

constexpr int CH = 64;       // chunk rows
constexpr int NT = 256;      // 8 warps
constexpr int DS = 32;       // key-dim slab of the output kernel
constexpr int SO = 2;        // stages of the output kernel's ring
// the largest head dim, set by kernels/build.py (MLSTM_MAX_DH), which the
// wrapper checks before a launch
#ifndef REPRO_MLSTM_MAX_DH
#error "REPRO_MLSTM_MAX_DH is not defined: build with kernels/build.py"
#endif
constexpr int MAX_DH = REPRO_MLSTM_MAX_DH;
constexpr float LOG_EPS = -30.f;
constexpr float NEG_BIG = -3.0e38f;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// --- 3xTF32 on mma.sync ---------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A fragment (16 x 8) split into its TF32 high and low parts; mma3 adds
// A times a B fragment (8 x 8, split here), small terms first.
struct Frag {
  uint32_t hi[4], lo[4];
};
__device__ __forceinline__ void split_a(const float (&ar)[4], Frag& f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(ar[i], f.hi[i], f.lo[i]);
}
__device__ __forceinline__ void mma3(float (&d)[4], const Frag& a, float b0,
                                     float b1) {
  uint32_t bh[2], bl[2];
  split(b0, bh[0], bl[0]);
  split(b1, bh[1], bl[1]);
  mma_tf32(d, a.lo, bh);
  mma_tf32(d, a.hi, bl);
  mma_tf32(d, a.hi, bh);
}

// --- asynchronous copies ----------------------------------------------------

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy an nrows x ncols tile into shared memory (row stride ds) from
// src[r * ss + c]; entries with r >= rv or c >= cv are zero-filled.  vec:
// 16-byte copies (src 16-byte aligned, ss, cv and ncols multiples of 4).
template <int NTH = NT>
__device__ __forceinline__ void load_tile(float* dst, int ds, const float* src,
                                          int64_t ss, int nrows, int ncols,
                                          int rv, int cv, bool vec) {
  if (vec) {
    const int c4 = ncols >> 2;
    for (int i = threadIdx.x; i < nrows * c4; i += NTH) {
      const int r = i / c4, c = (i - r * c4) * 4;
      const bool ok = r < rv && c < cv;
      cp16(dst + r * ds + c, ok ? src + r * ss + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * ncols; i += NTH) {
      const int r = i / ncols, c = i - r * ncols;
      const bool ok = r < rv && c < cv;
      cp4(dst + r * ds + c, ok ? src + r * ss + c : src, ok);
    }
  }
}

// Inclusive scans over the 64 rows of a chunk held by threads 0..63 (warps 0
// and 1); every thread of the block must call them (they synchronise).
// red: 1 float of shared scratch, free on entry.
__device__ __forceinline__ float chunk_cumsum(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (warp == 0 && lane == 31) *red = x;
  __syncthreads();
  if (warp == 1) x += *red;
  return x;
}
__device__ __forceinline__ float chunk_prefix_max(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x = fmaxf(x, y);
  }
  if (warp == 0 && lane == 31) *red = x;
  __syncthreads();
  if (warp == 1) x = fmaxf(x, *red);
  return x;
}

struct Strides {
  int64_t b, h, s;
};

// --- 1. gates of the full chunks and the scan of m -------------------------

// Per (b, h): for each full chunk c < NS, b = cumsum(lf), total = b[63],
// kwlog_l = li_l + (total - b_l), mx = max kwlog, and the key weights
// w_l = exp(kwlog_l - mx) (wbuf); then, serially over the chunks, the
// stabilizer m' = max(m + total, mx) and the rescaling weights
// a = exp(m + total - m'), bw = exp(mx - m') (rec = {mx, total, a, bw}),
// and m' as the m entering chunk c + 1 (mbuf).
__global__ void __launch_bounds__(NT) mlstm_gates_kernel(
    const float* __restrict__ li, const float* __restrict__ lf,
    float* __restrict__ wbuf, float4* __restrict__ rec,
    float* __restrict__ mbuf, int NC, int H, Strides is, Strides fs) {
  const int bh = blockIdx.x, bb = bh / H, hh = bh - bb * H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* ib = li + bb * is.b + hh * is.h;
  const float* fb = lf + bb * fs.b + hh * fs.h;
  const int NS = NC - 1;
  float* wb = wbuf + (int64_t)bh * NS * CH;
  float4* rb = rec + (int64_t)bh * NS;
  for (int c = warp; c < NS; c += NT / 32) {   // a warp per chunk, 2 rows
    const int64_t t = (int64_t)c * CH + 2 * lane;  // a lane
    const float i0 = ib[t * is.s], i1 = ib[(t + 1) * is.s];
    const float f0 = fb[t * fs.s], f1 = fb[(t + 1) * fs.s];
    float x = f0 + f1;                          // inclusive scan of pairs
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    const float prev = __shfl_up_sync(0xffffffffu, x, 1);
    const float b0 = (lane ? prev : 0.f) + f0, b1 = x;
    const float total = __shfl_sync(0xffffffffu, x, 31);
    const float k0 = i0 + (total - b0), k1 = i1 + (total - b1);
    float mx = fmaxf(k0, k1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    *reinterpret_cast<float2*>(wb + (int64_t)c * CH + 2 * lane) =
        make_float2(expf(k0 - mx), expf(k1 - mx));
    if (lane == 0) rb[c] = make_float4(mx, total, 0.f, 0.f);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = 0.f;
    mbuf[(int64_t)bh * NC] = 0.f;
    for (int c = 0; c < NS; ++c) {
      float4 r = rb[c];
      const float m_new = fmaxf(m + r.y, r.x);
      r.z = expf(m + r.y - m_new);              // exponents <= 0
      r.w = expf(r.x - m_new);
      rb[c] = r;
      m = m_new;
      mbuf[(int64_t)bh * NC + c + 1] = m;
    }
  }
}

// --- 2. chunk-local dC and the rescaling, tile by tile ---------------------

// A CTA of 4 warps owns a TK x TV tile of the state (2 x 2 warps of 16 keys
// by 32 values).  The work of a chunk is short and its steps depend on one
// another (wait, product, rescale, store), so the kernel is bound by that
// latency: small CTAs let several share an SM and hide it for each other.
constexpr int TK = 32, TV = 64;
constexpr int NT_S = (TK / 16) * (TV / 32) * 32;
constexpr int KS = TK + 8, VS = TV + 8;       // conflict-free fragments
constexpr int STAGE_FLOATS = CH * KS + CH * VS + CH + 4;   // k, v, w, rec

size_t state_smem_bytes() { return (size_t)2 * STAGE_FLOATS * 4; }

__global__ void __launch_bounds__(NT_S, 4) mlstm_state_kernel(
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ wbuf, const float* __restrict__ rec,
    float* __restrict__ state, int dh, int DP, int NC, int H, int vec,
    Strides ks, Strides vs) {
  extern __shared__ __align__(16) float smem[];
  const int ntv = (DP + TV - 1) / TV;
  const int kt = blockIdx.x / ntv, vt = blockIdx.x - kt * ntv;
  const int key0 = kt * TK, val0 = vt * TV;
  const int hh = blockIdx.y, bb = blockIdx.z, bh = bb * H + hh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int wm = warp % (TK / 16), wn = warp / (TK / 16);  // 16 x 32 each
  // n = the column of ones appended to v: warps wn == 0 of value tile 0
  const bool with_n = vt == 0 && wn == 0;
  const float* kb = k + bb * ks.b + hh * ks.h + key0;
  const float* vb = v + bb * vs.b + hh * vs.h + val0;
  const int NS = NC - 1;                  // chunks whose end state is kept
  const float* wb = wbuf + (int64_t)bh * NS * CH;
  const float* rb = rec + (int64_t)bh * NS * 4;
  const int64_t SL = (int64_t)DP * DP + DP;
  float* st = state + (int64_t)bh * NS * SL;

  auto issue = [&](int c) {
    float* sb = smem + (c & 1) * STAGE_FLOATS;
    const int64_t t0 = (int64_t)c * CH;
    load_tile<NT_S>(sb, KS, kb + t0 * ks.s, ks.s, CH, TK, CH, dh - key0,
                    vec);
    load_tile<NT_S>(sb + CH * KS, VS, vb + t0 * vs.s, vs.s, CH, TV, CH,
                    dh - val0, vec);
    load_tile<NT_S>(sb + CH * (KS + VS), CH, wb + t0, 0, 1, CH, 1, CH, true);
    load_tile<NT_S>(sb + CH * (KS + VS + 1), 4, rb + 4 * c, 0, 1, 4, 1, 4,
                    true);
  };

  float crun[4][4], nrun[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) crun[j][e] = 0.f;
  issue(0);
  cp_commit();
  for (int c = 0; c < NS; ++c) {
    cp_wait<0>();
    __syncthreads();          // chunk c landed; chunk c - 1's stage is free
    if (c + 1 < NS) issue(c + 1);
    cp_commit();
    const float* K = smem + (c & 1) * STAGE_FLOATS;
    const float* V = K + CH * KS;
    const float* w = V + CH * VS;
    const float a = w[CH + 2], bw = w[CH + 3];

    float acc[4][4], nacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 2
    for (int l0 = 0; l0 < CH; l0 += 8) {
      // A[key][l] = k[l][key] * w_l
      const float w0 = w[l0 + tig], w1 = w[l0 + tig + 4];
      const float* k0 = K + (l0 + tig) * KS + wm * 16 + grp;
      const float* k1 = k0 + 4 * KS;
      const float ar[4] = {k0[0] * w0, k0[8] * w0, k1[0] * w1, k1[8] * w1};
      Frag fa;
      split_a(ar, fa);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* v0 = V + (l0 + tig) * VS + wn * 32 + 8 * j + grp;
        mma3(acc[j], fa, v0[0], v0[4 * VS]);
      }
      if (with_n) {           // B = a column of ones: sum_l A[key][l]
        const float one = grp == 0 ? 1.f : 0.f;
        mma3(nacc, fa, one, one);
      }
    }
    // C <- a C + bw dC; store the state entering chunk c + 1
    float* sc = st + (int64_t)c * SL;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = val0 + wn * 32 + 8 * j + 2 * tig;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = key0 + wm * 16 + grp + 8 * hr;
        const float x0 = a * crun[j][2 * hr] + bw * acc[j][2 * hr];
        const float x1 = a * crun[j][2 * hr + 1] + bw * acc[j][2 * hr + 1];
        crun[j][2 * hr] = x0;
        crun[j][2 * hr + 1] = x1;
        if (row < DP && col < DP)
          *reinterpret_cast<float2*>(sc + (int64_t)row * DP + col) =
              make_float2(x0, x1);
      }
    }
    if (with_n && tig == 0) { // column 0 of the ones tile: rows grp, grp + 8
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = key0 + wm * 16 + grp + 8 * hr;
        nrun[hr] = a * nrun[hr] + bw * nacc[2 * hr];
        if (row < DP) sc[(int64_t)DP * DP + row] = nrun[hr];
      }
    }
  }
}

// --- 3. outputs from the entering states ------------------------------------

template <int NTILE>
struct OutShape {
  static constexpr int VW = 16 * NTILE;   // value columns per CTA
  static constexpr int CS = VW + 8;       // C / v slab row stride
  static constexpr int QS = DS + 4;       // q / k slab row stride
  static constexpr int PS = CH + 4;       // P row stride
  static constexpr int STAGE = 2 * CH * QS + DS * CS + DS;  // Q, K, C, n
  static constexpr int FLOATS = SO * STAGE + CH * PS + 6 * CH + 4;
  static_assert(SO * DS >= CH, "the v slabs of a chunk fill the C buffers");
};

template <int NTILE>
__global__ void __launch_bounds__(NT, 1) mlstm_out_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ li,
    const float* __restrict__ lf, float* __restrict__ h,
    const float* __restrict__ state, const float* __restrict__ mbuf, int S,
    int dh, int DP, int NC, int H, int vec, Strides qs, Strides ks,
    Strides vs, Strides is, Strides fs, Strides hs) {
  using O = OutShape<NTILE>;
  constexpr int VW = O::VW, CS = O::CS, QS = O::QS, PS = O::PS;
  extern __shared__ __align__(16) float smem[];
  float* Ps = smem + SO * O::STAGE;        // CH x PS
  float* g_li = Ps + CH * PS;
  float* g_b = g_li + CH;
  float* g_m = g_b + CH;                   // m_j
  float* g_sw = g_m + CH;                  // exp(m + b_j - m_j)
  float* g_qn = g_sw + CH;                 // q.n
  float* g_rs = g_qn + CH;                 // row sums of P
  float* red = g_rs + CH;
  auto stage_q = [&](int s) { return smem + s * O::STAGE; };
  auto stage_k = [&](int s) { return smem + s * O::STAGE + CH * QS; };
  auto stage_c = [&](int s) { return smem + s * O::STAGE + 2 * CH * QS; };
  auto stage_n = [&](int s) {
    return smem + s * O::STAGE + 2 * CH * QS + DS * CS;
  };

  const int c = blockIdx.y, bh = blockIdx.z;
  const int bb = bh / H, hh = bh - bb * H;
  const int v0 = blockIdx.x * VW;
  const int t0 = c * CH, cl = min(CH, S - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int r0 = wm * 16 + grp;            // this thread's rows r0, r0 + 8
  const int cw = wn * (VW / 2);            // this warp's first value column
  const float* qb = q + bb * qs.b + hh * qs.h + (int64_t)t0 * qs.s;
  const float* kb = k + bb * ks.b + hh * ks.h + (int64_t)t0 * ks.s;
  const float* vb = v + bb * vs.b + hh * vs.h + (int64_t)t0 * vs.s + v0;
  const float* ib = li + bb * is.b + hh * is.h;
  const float* fb = lf + bb * fs.b + hh * fs.h;
  const bool has_state = c > 0;
  const int64_t SL = (int64_t)DP * DP + DP;
  const float* stc =
      has_state ? state + ((int64_t)bh * (NC - 1) + c - 1) * SL : state;
  const float m_in = has_state ? mbuf[(int64_t)bh * NC + c] : 0.f;
  const int nslab = (dh + DS - 1) / DS;

  auto issue = [&](int i) {
    const int s = i % SO, d0 = i * DS;
    load_tile(stage_q(s), QS, qb + d0, qs.s, CH, DS, cl, dh - d0, vec);
    load_tile(stage_k(s), QS, kb + d0, ks.s, CH, DS, cl, dh - d0, vec);
    if (has_state) {
      load_tile(stage_c(s), CS, stc + (int64_t)d0 * DP + v0, DP, DS, VW,
                DP - d0, DP - v0, true);
      load_tile(stage_n(s), DS, stc + (int64_t)DP * DP + d0, 0, 1, DS, 1,
                DP - d0, true);
    }
  };
#pragma unroll
  for (int i = 0; i < SO - 1; ++i) {
    if (i < nslab) issue(i);
    cp_commit();
  }

  // gates of the chunk (threads 0..63)
  float li_v = 0.f, lf_v = 0.f;
  if (tid < cl) {
    li_v = ib[(int64_t)(t0 + tid) * is.s];
    lf_v = fb[(int64_t)(t0 + tid) * fs.s];
  }
  const float cum = chunk_cumsum(lf_v, red);
  const float pm = chunk_prefix_max(tid < cl ? li_v - cum : NEG_BIG, red + 1);
  if (tid < CH) {
    float mj = fmaxf(cum + pm, m_in + cum);   // max_{l<=j} D[j,l], state
    if (tid < cl - 1) mj = fmaxf(mj, LOG_EPS);  // masked entries of row j
    g_li[tid] = li_v;
    g_b[tid] = cum;
    g_m[tid] = mj;
    g_sw[tid] = expf(m_in + cum - mj);
  }

  float sacc[4][4], acc[NTILE][4], qn = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NTILE; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // q k^T, q C and q.n over the key dim
  for (int i = 0; i < nslab; ++i) {
    cp_wait<SO - 2>();
    __syncthreads();          // slab i landed; slab i - 1's stage is free
    if (i + SO - 1 < nslab) issue(i + SO - 1);
    cp_commit();
    const float* Q = stage_q(i % SO);
    const float* Kt = stage_k(i % SO);
    const float* C = stage_c(i % SO);
#pragma unroll
    for (int kk = 0; kk < DS; kk += 8) {
      const float* qa = Q + r0 * QS + kk + tig;
      const float ar[4] = {qa[0], qa[8 * QS], qa[4], qa[8 * QS + 4]};
      Frag fa;
      split_a(ar, fa);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* kp = Kt + (wn * 32 + 8 * j + grp) * QS + kk + tig;
        mma3(sacc[j], fa, kp[0], kp[4]);
      }
      if (has_state) {
#pragma unroll
        for (int j = 0; j < NTILE; ++j) {
          const float* cp = C + (kk + tig) * CS + cw + 8 * j + grp;
          mma3(acc[j], fa, cp[0], cp[4 * CS]);
        }
      }
    }
    if (has_state) {          // 4 threads per row, DS / 4 dims each
      constexpr int QN = DS / 4;
      const float* qr = Q + (tid >> 2) * QS + (tid & 3) * QN;
      const float* nr = stage_n(i % SO) + (tid & 3) * QN;
#pragma unroll
      for (int e = 0; e < QN; ++e) qn = fmaf(qr[e], nr[e], qn);
    }
  }
  __syncthreads();                         // every stage consumed

  // v slabs of DS rows into the stages' C buffers, behind P's math
  const int nl = (cl + DS - 1) / DS;
  for (int s = 0; s < nl; ++s)
    load_tile(stage_c(s), CS, vb + (int64_t)s * DS * vs.s, vs.s, DS, VW,
              cl - s * DS, dh - v0, vec);
  cp_commit();
  qn += __shfl_xor_sync(0xffffffffu, qn, 1);
  qn += __shfl_xor_sync(0xffffffffu, qn, 2);
  if ((tid & 3) == 0) g_qn[tid >> 2] = has_state ? qn : 0.f;
  if (tid < CH) g_rs[tid] = 0.f;
  __syncthreads();

  // P = exp(D - m_j) * (q k^T), masked entries (D = -30) kept, columns past
  // the chunk's end zero; row sums
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e >> 1);
      const int l = wn * 32 + 8 * j + 2 * tig + (e & 1);
      float p = 0.f;
      if (r < cl && l < cl) {
        const float dv = l <= r ? g_li[l] + g_b[r] - g_b[l] : LOG_EPS;
        p = expf(dv - g_m[r]) * sacc[j][e];
      }
      Ps[r * PS + l] = p;
      rs[e >> 1] += p;
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 1);
    rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 2);
  }
  if (tig == 0) {
    atomicAdd(&g_rs[r0], rs[0]);
    atomicAdd(&g_rs[r0 + 8], rs[1]);
  }
  // num = exp(m + b_j - m_j) q C + P v
  if (has_state) {
    const float sw0 = g_sw[r0], sw1 = g_sw[r0 + 8];
#pragma unroll
    for (int j = 0; j < NTILE; ++j) {
      acc[j][0] *= sw0;
      acc[j][1] *= sw0;
      acc[j][2] *= sw1;
      acc[j][3] *= sw1;
    }
  }
  cp_wait<0>();
  __syncthreads();                         // P, row sums and v ready
  for (int s = 0; s < nl; ++s) {
    const float* Vt = stage_c(s);
#pragma unroll
    for (int kk = 0; kk < DS; kk += 8) {
      const float* pa = Ps + r0 * PS + s * DS + kk + tig;
      const float ar[4] = {pa[0], pa[8 * PS], pa[4], pa[8 * PS + 4]};
      Frag fa;
      split_a(ar, fa);
#pragma unroll
      for (int j = 0; j < NTILE; ++j) {
        const float* vp = Vt + (kk + tig) * CS + cw + 8 * j + grp;
        mma3(acc[j], fa, vp[0], vp[4 * CS]);
      }
    }
  }

  // h = num / max(|sw q.n + sum_l P|, exp(-m_j))
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 8 * hr;
    if (r >= cl) continue;
    const float den = fmaxf(fabsf(g_qn[r] * g_sw[r] + g_rs[r]),
                            expf(-g_m[r]));
    float* hrow = h + bb * hs.b + hh * hs.h + (int64_t)(t0 + r) * hs.s;
#pragma unroll
    for (int j = 0; j < NTILE; ++j) {
      const int col = v0 + cw + 8 * j + 2 * tig;
      if (col < dh) hrow[col] = acc[j][2 * hr] / den;
      if (col + 1 < dh) hrow[col + 1] = acc[j][2 * hr + 1] / den;
    }
  }
}

template <int NTILE>
int launch_out(dim3 grid, cudaStream_t stream, const float* q, const float* k,
               const float* v, const float* li, const float* lf, float* h,
               const float* state, const float* mbuf, int S, int dh, int DP,
               int NC, int H, int vec, const Strides* st) {
  const int bytes = OutShape<NTILE>::FLOATS * (int)sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(
      mlstm_out_kernel<NTILE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return (int)attr;
  mlstm_out_kernel<NTILE><<<grid, NT, bytes, stream>>>(
      q, k, v, li, lf, h, state, mbuf, S, dh, DP, NC, H, vec, st[0], st[1],
      st[2], st[3], st[4], st[5]);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

int repro_mlstm_chunk() { return CH; }

// Floats of workspace one call needs: one m per chunk, the states entering
// chunks 1..NC-1 (C and n, DP = dh rounded up to 8), and the gates of the
// full chunks.
int64_t repro_mlstm_workspace(int B, int H, int S, int dh) {
  const int64_t NC = (S + CH - 1) / CH, DP = round_up(dh, 8);
  // m per chunk; states; {mx, total, a, bw} and key weights per full chunk
  return round_up(B * H * (int)NC, 4) + (int64_t)B * H * (NC - 1) *
         (DP * DP + DP + 4 + CH);
}

// q, k, v: (B, H, S, dh) f32 with element strides (b, h, s) in st[0..8]
// and a contiguous last axis; li, lf: (B, H, S) f32, strides st[9..14];
// h: (B, H, S, dh) f32, strides st[15..17]; work: repro_mlstm_workspace
// floats.  Two launches (the state kernel only when S > 64).
int repro_mlstm_fwd(const float* q, const float* k, const float* v,
                    const float* li, const float* lf, float* h, float* work,
                    int B, int H, int S, int dh, const int64_t* st,
                    void* stream) {
  if (B < 1 || H < 1 || S < 1 || dh < 1 || dh > MAX_DH)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides ss[6] = {{st[0], st[1], st[2]},    {st[3], st[4], st[5]},
                         {st[6], st[7], st[8]},    {st[9], st[10], st[11]},
                         {st[12], st[13], st[14]}, {st[15], st[16], st[17]}};
  // 16-byte copies of q, k, v when their rows allow them
  bool vec = dh % 4 == 0;
  for (int t = 0; t < 3; ++t)
    vec = vec && ss[t].b % 4 == 0 && ss[t].h % 4 == 0 && ss[t].s % 4 == 0;
  vec = vec && aligned16(q) && aligned16(k) && aligned16(v);
  const int NC = (S + CH - 1) / CH, DP = round_up(dh, 8);
  // m per chunk, then the state slots (16-byte aligned)
  float* mbuf = work;
  float* state = work + round_up(B * H * NC, 4);
  if (NC > 1) {
    const int NS = NC - 1;
    float4* rec = reinterpret_cast<float4*>(state + (int64_t)B * H * NS *
                                            (DP * DP + DP));
    float* wbuf = reinterpret_cast<float*>(rec + (int64_t)B * H * NS);
    mlstm_gates_kernel<<<B * H, NT, 0, s>>>(li, lf, wbuf, rec, mbuf, NC, H,
                                           ss[3], ss[4]);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    static const cudaError_t attr = cudaFuncSetAttribute(
        mlstm_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)state_smem_bytes());
    if (attr != cudaSuccess) return (int)attr;
    const int tiles = ((DP + TK - 1) / TK) * ((DP + TV - 1) / TV);
    mlstm_state_kernel<<<dim3(tiles, H, B), NT_S, state_smem_bytes(), s>>>(
        k, v, wbuf, reinterpret_cast<const float*>(rec), state, dh, DP, NC,
        H, vec, ss[1], ss[2]);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int BH = B * H;
  if (DP <= 64)
    return launch_out<4>(dim3(1, NC, BH), s, q, k, v, li, lf, h, state, mbuf,
                         S, dh, DP, NC, H, vec, ss);
  if (DP <= 128)
    return launch_out<8>(dim3(1, NC, BH), s, q, k, v, li, lf, h, state, mbuf,
                         S, dh, DP, NC, H, vec, ss);
  if (DP <= 256)
    return launch_out<16>(dim3(1, NC, BH), s, q, k, v, li, lf, h, state,
                          mbuf, S, dh, DP, NC, H, vec, ss);
  if (DP <= 384)
    return launch_out<24>(dim3(1, NC, BH), s, q, k, v, li, lf, h, state,
                          mbuf, S, dh, DP, NC, H, vec, ss);
  return launch_out<16>(dim3((DP + 255) / 256, NC, BH), s, q, k, v, li, lf,
                        h, state, mbuf, S, dh, DP, NC, H, vec, ss);
}

const char* repro_mlstm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
