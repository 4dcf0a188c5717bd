// One-token attention over a KV cache (flash-decoding) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode_fwd / _kernel).  Same function: q (B,H,D) scaled by
// D^-0.5 reads kv head h // G, cache slots > pos are masked, softmax and
// both products in f32, output in q's dtype, and the per-head log-sum-exp
// m + log(max(l, 1e-30)) in f32.  Any number G of query heads per kv head.
//
// Bound.  Each cache byte is used for 2G flops, far below the ~295
// flops/byte at which the tensor cores would limit, so the kernel is bound
// by the bytes of the K/V prefix it reads, (pos+1) * KV * D * 2 * itemsize
// per batch row, and at small pos by latency.  It runs on the CUDA cores.
//
// Design: one launch per call, no scratch.
// - A CTA of 8 warps takes one (batch, kv head, slice of the group's query
//   heads) and a range of keys.  A key row is read by a group of D/8 lanes
//   (rounded up to a power of two; 16 at D=128, so a warp reads two rows
//   at once), each lane holding 8 columns: 16 bytes in bf16, two 16-byte
//   pieces in f32 (lane i takes pieces i and i + D/8).  Neighbouring lanes
//   copy neighbouring 16-byte pieces of one row into shared memory with
//   cp.async, a ring of 3 iterations ahead; each lane reads back only the
//   pieces it copied, so the ring needs no barrier.
// - Each row group ("subgroup") takes T=4 keys an iteration, with its own
//   online softmax in registers (m, l and the p.V columns of every head of
//   the slice).  The q.k partials of the (head, key) pairs are reduced
//   across the group by a reduce-scatter (each shuffle level halves the
//   pairs a lane keeps), so that the softmax of each pair is computed in
//   one lane; p is then broadcast for p.V.  The loops over the slice's
//   heads carry no head guard, which would keep the compiler from
//   interleaving the shuffle chains (a head past the slice has q = 0 and
//   is never written).
// - The subgroups of a warp combine by xor shuffles, the warps of a CTA
//   through shared memory (the ring, now free).
// - Splits: where B * KV * slices CTAs would leave the card idle, the keys
//   of each (batch, kv head, slice) are split over up to 8 CTAs (a power
//   of two, aiming at 2 CTAs an SM in all, at least one iteration of keys
//   a CTA), launched as one thread-block cluster along the split axis.
//   Each CTA walks its range of chunks with the online softmax; the
//   cluster's rank 0 reads the others' (m, l, acc) through distributed
//   shared memory and writes o and lse.  Nothing goes through device
//   memory, so there is no second launch and no counter to reset (the
//   other in-launch combine, the last-arriving CTA, needs both scratch and
//   a persistent counter).
// - Slices: a group is cut into slices of at most GMAX=4 heads along the
//   grid's y axis (recurrentgemma-2b's 10 heads: 4, 3 and 3, each slice
//   re-reading the kv head's K/V, from L2 after the first).  Where every
//   CTA would walk a single chunk and the card would still be idle (the
//   admission decode of granite-8b at pos ~63: 8 CTAs), a slice is one
//   head, so each CTA's serial work is 4x shorter: 32 CTAs.
// - exp is 2^x by the SFU (ex2.approx) of scores pre-scaled by log2(e).
#include "common.cuh"

#include <algorithm>

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

using repro::NEG_INF;
using repro::from_f;

constexpr int NW = 8;            // warps per CTA
constexpr int NT = NW * 32;
constexpr int GMAX = 4;          // query heads of a slice, in registers
constexpr int T = 4;             // keys a row group walks per iteration
constexpr int STAGES = 3;        // iterations of K/V in flight (cp.async)
constexpr int MAX_CLUSTER = 8;   // CTAs per (batch, kv head, slice)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// lanes of a row group at head_dim D: D/8 rounded up to a power of two
__host__ __device__ constexpr int row_lanes(int D) {
  return D <= 16 ? 2 : D <= 32 ? 4 : D <= 64 ? 8 : D <= 128 ? 16 : 32;
}

template <int D>
struct Geo {
  static constexpr int NPL = D / 8;           // active lanes of a row
  static constexpr int LPR = row_lanes(D);    // lanes of a row group
  static constexpr int RPW = 32 / LPR;        // rows a warp reads at once
  static constexpr int NSG = NW * RPW;        // row groups of a CTA
  static constexpr int CH = NSG * T;          // keys of a CTA iteration
  static_assert(D % 8 == 0 && NPL <= 32, "head_dim");
};

// 8 elements of a row, as loaded
template <typename E> struct Raw;
template <> struct Raw<__nv_bfloat16> { uint4 a; };
template <> struct Raw<float> { float4 a, b; };

// 16 bytes global -> shared, asynchronously; zeros where !valid
__device__ __forceinline__ void cp16(uint4* dst, const void* src,
                                     bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16-byte pieces of a row per lane: 1 in bf16, 2 in f32
template <typename E>
constexpr int kPieces = sizeof(E) == 2 ? 1 : 2;

template <typename E>
__device__ __forceinline__ void read_raw(const uint4* p, int stride,
                                         Raw<E>& r);
template <>
__device__ __forceinline__ void read_raw(const uint4* p, int,
                                         Raw<__nv_bfloat16>& r) {
  r.a = *p;
}
template <>
__device__ __forceinline__ void read_raw(const uint4* p, int stride,
                                         Raw<float>& r) {
  r.a = *reinterpret_cast<const float4*>(p);
  r.b = *reinterpret_cast<const float4*>(p + stride);
}
__device__ __forceinline__ void zero_raw(Raw<__nv_bfloat16>& r) {
  r.a = make_uint4(0u, 0u, 0u, 0u);
}
__device__ __forceinline__ void zero_raw(Raw<float>& r) {
  r.a = r.b = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void unpack(const Raw<__nv_bfloat16>& r,
                                       float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void unpack(const Raw<float>& r, float (&f)[8]) {
  f[0] = r.a.x; f[1] = r.a.y; f[2] = r.a.z; f[3] = r.a.w;
  f[4] = r.b.x; f[5] = r.b.y; f[6] = r.b.z; f[7] = r.b.w;
}

// head_dim column of element e of lane i's 8
template <typename E, int NPL>
__device__ __forceinline__ int col(int i, int e) {
  if constexpr (sizeof(E) == 2) return 8 * i + e;
  else return e < 4 ? 4 * i + e : 4 * (i + NPL) + e - 4;
}

// 2^x by the SFU (exact enough for the f32 contract: ~2^-22 relative)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Reduce v over the LPR lanes of a row group.  While a lane holds more
// than one value, each level halves them (reduce-scatter: the lane keeps
// the upper half of the pairs if its bit OFF is set, and sends the other
// half); then plain sums.  Afterwards value i of lane li is the total of
// pair (li / DUP) * NV + i, with NV = N / min(LPR, N), DUP = max(1, LPR / N).
template <int OFF, int N, int NA>
__device__ __forceinline__ void reduce_scatter(float (&v)[NA], int lane) {
  if constexpr (OFF > 0) {
    if constexpr (N > 1) {
      const bool hi = lane & OFF;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = hi ? v[i] : v[i + N / 2];
        const float keep = hi ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      reduce_scatter<OFF / 2, N / 2, NA>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      reduce_scatter<OFF / 2, 1, NA>(v, lane);
    }
  }
}

// Shared memory of one CTA: the K/V ring, STAGES x T x {K, V} x pieces x
// NT 16-byte slots (each lane reads back only the slots it filled), reused
// after the walk for the warps' p.V columns and the CTA's.
template <typename E, int D, int GS>
constexpr int smem_bytes(int stages) {
  const int ring = stages * T * 2 * kPieces<E> * NT * 16;
  const int comb = (NW + 1) * GS * D * 4;
  return ring > comb ? ring : comb;
}

template <typename E, int D, int GS>
__global__ void __launch_bounds__(NT, 2) fd_kernel(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, E* __restrict__ o, float* __restrict__ lse,
    int H, int G, int nslice, int n_keys, int nchunks, int64_t q_sb,
    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
    int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_sh, float scale) {
  using Gm = Geo<D>;
  constexpr int NPL = Gm::NPL, LPR = Gm::LPR, RPW = Gm::RPW;
  constexpr int NSG = Gm::NSG, CH = Gm::CH, P = kPieces<E>;
  // pairs (head, key) of an iteration; after the reduction a lane holds NV
  // of them (HPL heads, TPL keys each), DUP lanes the same ones
  constexpr int NP = GS * T;
  constexpr int NV = NP / (LPR < NP ? LPR : NP);
  constexpr int DUP = LPR > NP ? LPR / NP : 1;
  constexpr int TPL = NV < T ? NV : T, HPL = NV / TPL;
  extern __shared__ uint4 ring[];
  __shared__ float w_m[NW][GS], w_l[NW][GS], c_m[GS], c_l[GS];

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int kvh = blockIdx.y / nslice, slice = blockIdx.y - kvh * nslice;
  const int b = blockIdx.z;
  const int g0 = slice * G / nslice;
  const int gs = (slice + 1) * G / nslice - g0;   // heads of this slice
  const int h0 = kvh * G + g0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane / LPR, li = lane - sub * LPR;
  const int sg = warp * RPW + sub;                 // row group in the CTA
  const bool act = li < NPL;
  const int la = act ? li : 0;                     // a lane's piece
  const int p0 = (li / DUP) * NV;                 // its first pair

  // this CTA's keys: chunks [c0, c1) of CH keys, one chunk an iteration
  const int c0 = (int)((int64_t)split * nchunks / nsplit);
  const int c1 = (int)((int64_t)(split + 1) * nchunks / nsplit);
  const int kbeg = c0 * CH, kend = min(c1 * CH, n_keys);
  const int niter = c1 - c0;

  // slot of (stage, key t, K or V, piece) for this thread
  auto slot = [&](int st, int t, int kv, int p) {
    return ring + (((st * T + t) * 2 + kv) * P + p) * NT + tid;
  };
  const E* kb = k + b * k_sb + kvh * k_sh;
  const E* vb = v + b * v_sb + kvh * v_sh;
  auto issue = [&](int it) {     // iteration it's K/V pieces into the ring
    if (it < niter) {
      const int st = it % STAGES;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int j = kbeg + it * CH + t * NSG + sg;
        const bool ok = j < kend && act;
        const int jj = ok ? j : kbeg;
        const uint4* kr = reinterpret_cast<const uint4*>(
            kb + (int64_t)jj * k_ss) + la;
        const uint4* vr = reinterpret_cast<const uint4*>(
            vb + (int64_t)jj * v_ss) + la;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          cp16(slot(st, t, 0, p), kr + p * NPL, ok);
          cp16(slot(st, t, 1, p), vr + p * NPL, ok);
        }
      }
    }
    cp_commit();                 // an empty group past the end
  };
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) issue(it);

  const float qs = scale * LOG2E;
  float qr[GS][8], m[GS], l[GS], acc[GS][8];
#pragma unroll
  for (int g = 0; g < GS; ++g) {
    Raw<E> r;
    zero_raw(r);
    if (g < gs && act)
      read_raw<E>(reinterpret_cast<const uint4*>(q + b * q_sb +
                                                 (h0 + g) * q_sh) + li,
                  NPL, r);
    unpack(r, qr[g]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qr[g][e] *= qs;
      acc[g][e] = 0.f;
    }
    m[g] = NEG_INF;
    l[g] = 0.f;
  }

  for (int it = 0; it < niter; ++it) {
    issue(it + STAGES - 1);
    cp_wait<STAGES - 1>();       // this thread's pieces of iteration it
    const int st = it % STAGES;
    Raw<E> kr[T], vr[T];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      read_raw<E>(slot(st, t, 0, 0), NT, kr[t]);
      read_raw<E>(slot(st, t, 1, 0), NT, vr[t]);
    }
    // q.k partials of pair g * T + t, then their totals, scattered
    float v[NP];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float kf[8];
      unpack(kr[t], kf);
#pragma unroll
      for (int g = 0; g < GS; ++g) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) a = fmaf(qr[g][e], kf[e], a);
        v[g * T + t] = a;
      }
    }
    reduce_scatter<LPR / 2, NP, NP>(v, lane);
    // each head's max over its T keys: in registers, then over the lanes
    // that hold its other keys
    const int kt = kbeg + it * CH + sg;    // key of t = 0
    float hm[HPL];
#pragma unroll
    for (int h = 0; h < HPL; ++h) {
      hm[h] = NEG_INF;
#pragma unroll
      for (int u = 0; u < TPL; ++u) {
        const int i = h * TPL + u;
        v[i] = kt + ((p0 + i) % T) * NSG < kend ? v[i] : NEG_INF;
        hm[h] = fmaxf(hm[h], v[i]);
      }
    }
#pragma unroll
    for (int off = DUP; off < DUP * (T / TPL); off <<= 1)
      hm[0] = fmaxf(hm[0], __shfl_xor_sync(0xffffffffu, hm[0], off));
    // the new running max of every head, in every lane
    float mn[GS], alpha[GS];
#pragma unroll
    for (int g = 0; g < GS; ++g) {
      mn[g] = fmaxf(m[g], __shfl_sync(0xffffffffu,
                                      hm[((g * T) % NV) / TPL],
                                      ((g * T) / NV) * DUP, LPR));
      alpha[g] = ex2(m[g] - mn[g]);
      m[g] = mn[g];
    }
    // p of the lane's pairs, then of all pairs in every lane
    float pv[NV];
#pragma unroll
    for (int h = 0; h < HPL; ++h) {
      const int g = (p0 + h * TPL) / T;
      float mg = mn[0];
#pragma unroll
      for (int x = 1; x < GS; ++x) mg = g == x ? mn[x] : mg;
#pragma unroll
      for (int u = 0; u < TPL; ++u) {
        const int i = h * TPL + u;
        pv[i] = v[i] > 0.5f * NEG_INF ? ex2(v[i] - mg) : 0.f;
      }
    }
    float vf[T][8];
#pragma unroll
    for (int t = 0; t < T; ++t) unpack(vr[t], vf[t]);
#pragma unroll
    for (int g = 0; g < GS; ++g) {
      float p[T];
#pragma unroll
      for (int t = 0; t < T; ++t)
        p[t] = __shfl_sync(0xffffffffu, pv[(g * T + t) % NV],
                           ((g * T + t) / NV) * DUP, LPR);
      float ps = 0.f;
#pragma unroll
      for (int t = 0; t < T; ++t) ps += p[t];
      l[g] = fmaf(l[g], alpha[g], ps);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float a = acc[g][e] * alpha[g];
#pragma unroll
        for (int t = 0; t < T; ++t) a = fmaf(p[t], vf[t][e], a);
        acc[g][e] = a;
      }
    }
  }

  // the row groups of a warp, by xor shuffles
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GS; ++g) {
      if (g < gs) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
        const float mx = fmaxf(m[g], mo);
        const float a = ex2(m[g] - mx), bo = ex2(mo - mx);
        l[g] = l[g] * a + lo * bo;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float x = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
          acc[g][e] = acc[g][e] * a + x * bo;
        }
        m[g] = mx;
      }
    }
  }
  cp_wait<0>();
  __syncthreads();               // the ring is free: the p.V columns go there
  float (*w_acc)[GS][D] = reinterpret_cast<float (*)[GS][D]>(ring);
  float (*c_acc)[D] = reinterpret_cast<float (*)[D]>(w_acc + NW);
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GS; ++g) {
      if (g < gs) {
        if (act) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            w_acc[warp][g][col<E, NPL>(li, e)] = acc[g][e];
        }
        if (lane == 0) {
          w_m[warp][g] = m[g];
          w_l[warp][g] = l[g];
        }
      }
    }
  }
  __syncthreads();

  // the warps of the CTA; with one CTA, the result
  for (int idx = tid; idx < gs * D; idx += NT) {
    const int g = idx / D, d = idx - g * D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, w_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float x = ex2(w_m[w][g] - M);
      L = fmaf(w_l[w][g], x, L);
      A = fmaf(w_acc[w][g][d], x, A);
    }
    if (nsplit == 1) {
      const float lc = fmaxf(L, 1e-30f);
      o[b * o_sb + (h0 + g) * o_sh + d] = from_f<E>(A / lc);
      if (d == 0 && lse != nullptr)
        lse[(int64_t)b * H + h0 + g] = (M + log2f(lc)) * LN2;
    } else {
      c_acc[g][d] = A;
      if (d == 0) {
        c_m[g] = M;
        c_l[g] = L;
      }
    }
  }
  if (nsplit == 1) return;

  // the CTAs of the cluster: rank 0 reads the others' shared memory
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    for (int idx = tid; idx < gs * D; idx += NT) {
      const int g = idx / D, d = idx - g * D;
      float M = NEG_INF;
      for (int r = 0; r < nsplit; ++r)
        M = fmaxf(M, *cluster.map_shared_rank(&c_m[g], r));
      float L = 0.f, A = 0.f;
      for (int r = 0; r < nsplit; ++r) {
        const float x = ex2(*cluster.map_shared_rank(&c_m[g], r) - M);
        L = fmaf(*cluster.map_shared_rank(&c_l[g], r), x, L);
        A = fmaf(*cluster.map_shared_rank(&c_acc[g][d], r), x, A);
      }
      const float lc = fmaxf(L, 1e-30f);
      o[b * o_sb + (h0 + g) * o_sh + d] = from_f<E>(A / lc);
      if (d == 0 && lse != nullptr)
        lse[(int64_t)b * H + h0 + g] = (M + log2f(lc)) * LN2;
    }
  }
  cluster.sync();   // the others' shared memory lives until rank 0 is done
}

int sm_count() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0 &&
      cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return cached[dev];
}

// CTAs per (batch, kv head, slice): a power of two up to MAX_CLUSTER, no
// more than the key chunks, and enough for 2 CTAs an SM in all
int splits(int ctas, int nchunks) {
  const int want = (2 * sm_count() + ctas - 1) / ctas;
  const int cap = std::min(want, std::min(nchunks, MAX_CLUSTER));
  int n = 1;
  while (2 * n <= cap) n *= 2;
  return n;
}

struct Plan {
  int gs, nslice, nsplit, nchunks;
};

// Slices of GMAX heads, unless each CTA would walk a single chunk and
// still leave SMs idle: then the call is latency-bound, and one head a CTA
// (K/V re-read from L2 for each head) shortens each CTA's work fourfold.
Plan plan(int B, int H, int KV, int n_keys, int ch) {
  const int G = H / KV, nchunks = (n_keys + ch - 1) / ch;
  Plan p{GMAX, (G + GMAX - 1) / GMAX, 1, nchunks};
  p.nsplit = splits(B * KV * p.nslice, nchunks);
  if (G > 1 && p.nsplit >= nchunks &&
      B * KV * p.nslice * p.nsplit < sm_count()) {
    p.gs = 1;
    p.nslice = G;
    p.nsplit = splits(B * KV * G, nchunks);
  }
  return p;
}

template <typename E, int D, int GS>
int run(const void* q, const void* k, const void* v, void* o, float* lse,
        int B, int H, int KV, int n_keys, const Plan& p, const int64_t* st,
        float scale, cudaStream_t stream) {
  // the ring holds the stages a CTA's walk can use
  const int iters = (p.nchunks + p.nsplit - 1) / p.nsplit;
  const int smem = smem_bytes<E, D, GS>(std::min(iters, STAGES));
  static bool ready[64];         // the shared-memory limit, set per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(fd_kernel<E, D, GS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<E, D, GS>(STAGES));
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  const dim3 grid(p.nsplit, KV * p.nslice, B);
  const E* qp = static_cast<const E*>(q);
  const E* kp = static_cast<const E*>(k);
  const E* vp = static_cast<const E*>(v);
  E* op = static_cast<E*>(o);
  const int G = H / KV;
  if (p.nsplit == 1) {
    fd_kernel<E, D, GS><<<grid, NT, smem, stream>>>(
        qp, kp, vp, op, lse, H, G, p.nslice, n_keys, p.nchunks, st[0], st[1],
        st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], scale);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, fd_kernel<E, D, GS>, qp, kp, vp, op, lse, H, G, p.nslice, n_keys,
      p.nchunks, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename E, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KV, int n_keys, const int64_t* st, float scale,
           cudaStream_t stream) {
  const Plan p = plan(B, H, KV, n_keys, Geo<D>::CH);
  if (p.gs == 1)
    return run<E, D, 1>(q, k, v, o, lse, B, H, KV, n_keys, p, st, scale,
                        stream);
  return run<E, D, GMAX>(q, k, v, o, lse, B, H, KV, n_keys, p, st, scale,
                         stream);
}

}  // namespace

extern "C" {

// n_keys = min(pos + 1, Smax): slots [0, n_keys) are attended.
// Element strides, in order: q (b, h), k (b, s, h), v (b, s, h), o (b, h);
// the head_dim axis is contiguous and rows are 16-byte aligned.  lse is
// (B, H) f32 or null.
int repro_flash_decode_fwd(const void* q, const void* k, const void* v,
                           void* o, float* lse, int dtype, int B, int H,
                           int KV, int n_keys, int D, const int64_t* strides,
                           float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV < 1 || H % KV != 0 || n_keys < 1) return (int)cudaErrorInvalidValue;
  if (dtype == repro::BF16) {
    REPRO_DISPATCH_D(D, return launch<__nv_bfloat16, kD>(
        q, k, v, o, lse, B, H, KV, n_keys, strides, scale, s);)
  } else if (dtype == repro::F32) {
    REPRO_DISPATCH_D(D, return launch<float, kD>(
        q, k, v, o, lse, B, H, KV, n_keys, strides, scale, s);)
  }
  return (int)cudaErrorInvalidValue;
}

// What one call launches at these sizes: heads per CTA, head slices per kv
// head, and CTAs per (batch, kv head, slice), into out[0..2].
int repro_flash_decode_plan(int B, int H, int KV, int n_keys, int D,
                            int* out) {
  if (KV < 1 || H % KV != 0 || n_keys < 1) return (int)cudaErrorInvalidValue;
  if (D % 8 != 0 || D < 16 || D > 256) return (int)cudaErrorInvalidValue;
  const int ch = NW * (32 / row_lanes(D)) * T;
  const Plan p = plan(B, H, KV, n_keys, ch);
  out[0] = p.gs;
  out[1] = p.nslice;
  out[2] = p.nsplit;
  return 0;
}

const char* repro_flash_decode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
