// Causal / sliding-window GQA flash-attention forward for Hopper (sm_90a),
// and the backward of its wgmma route.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_fwd / _kernel).  Same function: S = (q * D^-0.5) k^T,
// masked scores are -1e30, p is zeroed by the mask, the online-softmax
// state (m, l, acc) is f32, l is clamped at 1e-30, and the output is
// written in q's dtype.  Query head h reads kv head h / G.  Any Sq and Sk
// are accepted (the ragged tile is masked), and q/k/v/o are read through
// their strides (the model's (B,S,H,D) tensors, transposed).  Given a
// pointer, both routes also write each row's log-sum-exp m + log(l) (f32,
// natural log) for the backward.
//
// The backward (fa_bwd_*, after the forward's wgmma route below) replaces
// no TPU kernel: the reference differentiates its plain attention.  It is
// bound by operations too (five products, 2.5 times the forward's), and is
// laid out for the tensor cores as the forward is.
//
// Bound.  At granite-8b's prefill shape (S=2048, H=32, KV=8, D=128, bf16,
// causal) the work is ~34 GFLOP of products against ~42 MB of q/k/v/o:
// ~35 us of bf16 tensor-core time against ~13 us of memory, so the kernel
// is bound by operations, and only the tensor cores can approach it.
//
// Two routes; kernels/flash_attention.py:route picks one with the same rule.
//
// "wgmma": bf16 with D in {64, 80, 96, 112, 128, 256} (every head_dim of
// the archs the port serves).  One CTA per (head, q tile, batch): one producer
// warpgroup, and consumer warpgroups of 64 query rows each, two (BQ = 128)
// at D <= 128 and one (BQ = 64) at D = 256, where O alone takes 128
// registers a thread: the 384-thread block's launch budget of 168 registers
// spilled it, even with setmaxnreg (producer 24, consumers 240).  One
// producer thread loads Q once and K/V tiles of BK keys (128, or 64 at
// D=256) by TMA (128-byte swizzle, 4-d tensor maps over the strided views;
// rows past Sq/Sk and columns past D arrive as TMA's zero fill) into a
// three-stage ring, with a "full" mbarrier per stage for K and one for V
// and an "empty" mbarrier the consumers release.  A consumer computes
// S = Q K^T with wgmma m64n{BK}k16 (both operands from shared memory),
// multiplies S by D^-0.5 (with log2 e) in f32, runs the online softmax in
// registers (a row lives in the four threads of a quad: two shuffles per
// reduction; exp2 on the special-function unit), rounds p to bf16 in
// registers and issues O += P V as wgmma m64n{D}k16 with P as the register
// A operand and V as the MN-major (transposed) shared-memory B operand.
// O stays in f32 registers and is rescaled by alpha every tile.  The loop
// is software-pipelined: tile i's Q K^T and tile i-1's P V are issued
// together, and tile i's softmax runs while P V is on the tensor cores.
// Shared memory: Q 32 KB + six K/V tiles of 32 KB (D=80, D=96 and D=112
// are held 128 wide, zero-filled; D=64 half of that).  K tiles wholly above the diagonal or
// outside the window are skipped (exact: the reference leaves (m, l, acc)
// unchanged there); only tiles that straddle a boundary evaluate the mask.
// The grid launches the heaviest causal q tiles first, heads fastest, so
// the G query heads of one kv head run together and share K/V in L2.
//   Contract in bf16.  QK^T: bf16 products are exact in f32 and wgmma sums
//   in f32, so S matches the reference's f32 dot up to summation order.
//   PV: p is rounded to bf16 before the product, a relative error of at
//   most 2^-9 per weight, so about 2^-9 max|v| per output element (inside
//   the 2e-2 bf16 tolerance); l is summed from the f32 p.  exp is the
//   special-function unit's 2^x (a few ulp; below 2^-126 it flushes to 0).
//
// "fma": f32 inputs (whose 2e-5 tolerance admits neither TF32 nor bf16 P)
// and bf16 at the other compiled head_dims (16, 32).  One CTA per
// (q tile, head, batch) of 128 threads; K and V tiles of 32 keys are staged
// through shared memory as f32 and both products are f32 FMA on the CUDA
// cores (BQ 64, 32 at D=256), with the same tile skipping.
#include <cuda.h>   // CUtensorMap and its enums only: the encoder is
                    // looked up at run time, so libcuda is not linked
#include <stdio.h>

#include "common.cuh"

namespace {

namespace fma_route {

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
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int G, int Sq, int Sk,
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
      if (lse != nullptr && tx == 0)
        lse[((int64_t)b * gridDim.y + h) * Sq + row] =
            m_i[i] + logf(fmaxf(l_i[i], 1e-30f));
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KV, int Sq, int Sk, const int64_t* st,
           int causal, int window, float scale, cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(o), lse, H / KV, Sq, Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace fma_route

namespace wgmma_route {

using repro::NEG_INF;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// Tile shapes of the wgmma route at head_dim D.
template <int D>
struct Cfg {
  static constexpr int NWG = D > 128 ? 1 : 2;          // consumer warpgroups
  static constexpr int BQ = 64 * NWG;                  // query rows per CTA
  static constexpr int BK = D <= 128 ? 128 : 64;       // keys per tile
  static constexpr int DP = D <= 64 ? 64 : D <= 128 ? 128 : 256;  // smem width
  static constexpr int NA = DP / 64;                   // 128-byte column atoms
  static constexpr int KC = (D + 15) / 16;             // k16 steps of Q K^T
  static constexpr uint32_t Q_BYTES = BQ * DP * 2;
  static constexpr uint32_t KV_BYTES = BK * DP * 2;    // one K or V tile
  static constexpr int STAGES = 3;                     // K/V ring depth
  static constexpr size_t SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + (1 + 3 * STAGES) * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-d tensor map (d, s, head, batch) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major operands
// (Q, K) step 8-row groups by sbo = 1024; the MN-major V steps 8-key groups
// by sbo = 1024 and 64-column atoms by lbo.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from touching registers that an asynchronous wgmma
// still reads or writes: every use is ordered after this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// 2^x on the special-function unit (inputs here are <= 0; results that
// would be subnormal flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&h);
}

#define FA_F8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_F32(i) FA_F8(i), FA_F8(i + 8), FA_F8(i + 16), FA_F8(i + 24)
#define FA_F40(i) FA_F32(i), FA_F8(i + 32)
#define FA_F48(i) FA_F40(i), FA_F8(i + 40)
#define FA_F56(i) FA_F40(i), FA_F8(i + 40), FA_F8(i + 48)
#define FA_F64(i) FA_F32(i), FA_F32(i + 32)
// the same, written only (a product that overwrites its accumulator)
#define FA_W8(i)                                                     \
  "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]),         \
      "=f"(d[i + 4]), "=f"(d[i + 5]), "=f"(d[i + 6]), "=f"(d[i + 7])
#define FA_W32(i) FA_W8(i), FA_W8(i + 8), FA_W8(i + 16), FA_W8(i + 24)
#define FA_F128(i) FA_F64(i), FA_F64(i + 64)

// wgmma m64nNk16, f32 += bf16 x bf16, accumulating into d (N/2 registers a
// thread).  ss: A and B from shared memory, both K-major.  rs: A from
// registers (four bf16x2 a thread), B from shared memory, transposed.
template <int N>
struct Wgmma;
template <> struct Wgmma<64> {
  __device__ static void ss(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : FA_F32(0)
        : "l"(a), "l"(b), "r"(1));
  }
  // the same, d = A B (d is only written)
  __device__ static void ss_init(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : FA_W32(0)
        : "l"(a), "l"(b), "r"(0));
  }
  // both operands MN-major (transposed) in shared memory
  __device__ static void ss_tt(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
        : FA_F32(0)
        : "l"(a), "l"(b), "r"(1));
  }
  __device__ static void ss_tt_init(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
        : FA_W32(0)
        : "l"(a), "l"(b), "r"(0));
  }
  __device__ static void rs(float (&d)[32], const uint32_t (&a)[4],
                          uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : FA_F32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<80> {
  __device__ static void rs(float (&d)[40], const uint32_t (&a)[4],
                          uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : FA_F40(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<96> {
  __device__ static void rs(float (&d)[48], const uint32_t (&a)[4],
                          uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : FA_F48(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<112> {
  __device__ static void rs(float (&d)[56], const uint32_t (&a)[4],
                          uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
        : FA_F56(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<128> {
  __device__ static void ss(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : FA_F64(0)
        : "l"(a), "l"(b), "r"(1));
  }
  __device__ static void rs(float (&d)[64], const uint32_t (&a)[4],
                          uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : FA_F64(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<256> {
  __device__ static void rs(float (&d)[128], const uint32_t (&a)[4],
                          uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : FA_F128(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

#undef FA_F8
#undef FA_F32
#undef FA_F40
#undef FA_F48
#undef FA_F56
#undef FA_F64
#undef FA_F128
#undef FA_W8
#undef FA_W32

template <int D>
__global__ void __launch_bounds__(128 * (Cfg<D>::NWG + 1), 1)
    fa_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ o, int64_t o_sb,
                    int64_t o_sh, int64_t o_ss, float* __restrict__ lse,
                    int G, int Sq, int Sk, int causal, int window,
                    float scale_log2) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, NA = C::NA;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms are 1024-byte aligned
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  constexpr int NS = C::STAGES;
  uint8_t* sk = sq + C::Q_BYTES;                 // [NS] K tiles
  uint8_t* sv = sk + NS * C::KV_BYTES;           // [NS] V tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(sv + NS * C::KV_BYTES);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;                   // [NS]
  uint64_t* v_full = k_full + NS;                // [NS]
  uint64_t* empty = v_full + NS;                 // [NS]

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first
  const int b = blockIdx.z;
  const int kvh = h / G;

  // k tiles that can be unmasked for some row of this q tile
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_stop = causal ? min(Sk, q_last + 1) : Sk;
  const int t_first = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int n_tiles = max(0, (k_stop + BK - 1) / BK - t_first);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, 128 * C::NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warpgroup index, made visibly warp-uniform for the compiler, so that
  // each setmaxnreg below sits in a warp-uniform branch
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == 0) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        PRODUCER_REGS));
    if (tid == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int a = 0; a < NA; ++a)
        tma_load(sq + a * BQ * 128, &tq, q_full, 64 * a, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % NS;
        const int k0 = (t_first + i) * BK;
        mbar_wait(empty + st, ((i / NS) & 1) ^ 1);
        mbar_expect_tx(k_full + st, C::KV_BYTES);
#pragma unroll
        for (int a = 0; a < NA; ++a)
          tma_load(sk + st * C::KV_BYTES + a * BK * 128, &tk, k_full + st,
                   64 * a, k0, kvh, b);
        mbar_expect_tx(v_full + st, C::KV_BYTES);
#pragma unroll
        for (int a = 0; a < NA; ++a)
          tma_load(sv + st * C::KV_BYTES + a * BK * 128, &tv, v_full + st,
                   64 * a, k0, kvh, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        CONSUMER_REGS));
    const int t = tid - 128 * wg;
    const int r_lo = q0 + 64 * (wg - 1);       // this warpgroup's rows
    // accumulator layout of wgmma m64nN: this thread holds rows row0 and
    // row0 + 8, columns 8n + cq and 8n + cq + 1 of every 8-column chunk n
    const int row0 = r_lo + 16 * (t >> 5) + ((t & 31) >> 2);
    const int cq = 2 * (t & 3);
    const uint32_t q_addr = smem_u32(sq) + 64 * (wg - 1) * 128;

    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    float m_i[2] = {NEG_INF, NEG_INF};
    float l_i[2] = {0.f, 0.f};    // this thread's columns; quad-summed last

    auto live = [&](int row, int col) {
      return col < Sk && (!causal || row >= col) &&
             (window <= 0 || row - col < window);
    };

    // S = Q K_i^T, issued and committed, not waited for
    auto issue_qk = [&](int i, float (&s)[BK / 2]) {
      const int st = i % NS;
      const uint32_t k_addr = smem_u32(sk + st * C::KV_BYTES);
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) s[j] = 0.f;
      mbar_wait(k_full + st, (i / NS) & 1);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < C::KC; ++kc) {
        const uint32_t off = (kc & 3) * 32;    // 16 bf16 within an atom
        Wgmma<BK>::ss(s, desc(q_addr + (kc >> 2) * BQ * 128 + off, 16, 1024),
                      desc(k_addr + (kc >> 2) * BK * 128 + off, 16, 1024));
      }
      wgmma_commit();
    };
    // O += P V_i with P in registers, issued and committed
    auto issue_pv = [&](int i, uint32_t (&pa)[BK / 16][4]) {
      const int st = i % NS;
      const uint32_t v_addr = smem_u32(sv + st * C::KV_BYTES);
      mbar_wait(v_full + st, (i / NS) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<D>::rs(acc, pa[kk],
                     desc(v_addr + kk * 16 * 128, BK * 128, 1024));
      wgmma_commit();
    };
    // online softmax of tile i in place: s becomes the f32 p; returns the
    // rescale alpha of each of this thread's two rows
    auto softmax = [&](int i, float (&s)[BK / 2], float (&alpha)[2]) {
      const int k0 = (t_first + i) * BK;
      // does any (row, col) of this warpgroup's rows and this tile fall
      // outside the mask?
      const bool masked = k0 + BK > Sk ||
                          (causal && k0 + BK - 1 > r_lo) ||
                          (window > 0 && r_lo + 63 - k0 >= window);
      float mx[2] = {m_i[0], m_i[1]};
      if (masked) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          const int r = (j >> 1) & 1;
          const int col = k0 + 8 * (j >> 2) + cq + (j & 1);
          s[j] = live(row0 + 8 * r, col) ? s[j] * scale_log2 : NEG_INF;
          mx[r] = fmaxf(mx[r], s[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          s[j] *= scale_log2;
          mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2_approx(m_i[r] - mx[r]);
        m_i[r] = mx[r];
        l_i[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int r = (j >> 1) & 1;
        float p = exp2_approx(s[j] - mx[r]);
        if (masked &&
            !live(row0 + 8 * r, k0 + 8 * (j >> 2) + cq + (j & 1)))
          p = 0.f;
        l_i[r] += p;                 // l from the f32 p
        s[j] = p;
      }
    };
    // P as the A operand of m64nNk16: for keys 16kk..16kk+15 the
    // accumulator chunks 2kk and 2kk+1 are exactly its register fragment
    auto pack = [&](const float (&s)[BK / 2], uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
    };

    // Software pipeline: tile i's softmax runs while tile i-1's P V is on
    // the tensor cores.  Stage i-1 is released once that product is done.
    float s[BK / 2];
    uint32_t pa[BK / 16][4];
    float alpha[2];
    mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      issue_qk(0, s);
      wgmma_wait<0>();
      fence_regs(s);
      softmax(0, s, alpha);
      pack(s, pa);
    }
    for (int i = 1; i < n_tiles; ++i) {
      issue_qk(i, s);
      issue_pv(i - 1, pa);
      wgmma_wait<1>();              // S_i is done; P V_{i-1} may run on
      fence_regs(s);
      softmax(i, s, alpha);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(empty + (i - 1) % NS);
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];
      pack(s, pa);
    }
    if (n_tiles > 0) {
      issue_pv(n_tiles - 1, pa);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(empty + (n_tiles - 1) % NS);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_i[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int row = row0 + 8 * r;
      if (row < Sq) {
        __nv_bfloat16* orow = o + b * o_sb + h * o_sh + row * o_ss;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + cq) =
              __floats2bfloat162_rn(acc[4 * n + 2 * r] * inv,
                                    acc[4 * n + 2 * r + 1] * inv);
        // the row's log-sum-exp in natural-log units, for the backward (a
        // row with every key masked keeps m at the mask value, unscaled)
        if (lse != nullptr && (t & 3) == 0)
          lse[((int64_t)b * gridDim.x + h) * Sq + row] =
              (m_i[r] == NEG_INF ? NEG_INF : m_i[r] * LN2) +
              logf(fmaxf(l, 1e-30f));
      }
    }
  }
}

// Codes past every cudaError_t: cuTensorMapEncodeTiled failed (ERR_TMA +
// its CUresult), or cuTensorMapEncodeTiled was not found.
constexpr int ERR_TMA = 100000;
constexpr int ERR_NO_ENCODE = 200000;

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Tensor map over a bf16 (B, heads, S, D) view with element strides
// st = (b, h, s), boxes of 64 columns x `rows` rows, 128-byte swizzle.
int make_map(CUtensorMap* map, const void* ptr, int B, int heads, int S,
             int D, const int64_t* st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return ERR_NO_ENCODE;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TMA + (int)r;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KV, int Sq, int Sk, const int64_t* st,
           int causal, int window, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fa_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, B, H, Sq, D, st, C::BQ);
  if (!err) err = make_map(&tk, k, B, KV, Sk, D, st + 3, C::BK);
  if (!err) err = make_map(&tv, v, B, KV, Sk, D, st + 6, C::BK);
  if (err) return err;
  dim3 grid(H, (Sq + C::BQ - 1) / C::BQ, B);
  fa_wgmma_kernel<D><<<grid, 128 * (C::NWG + 1), C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), st[9], st[10], st[11],
      lse, H / KV, Sq, Sk, causal, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

// ---- backward ----------------------------------------------------------------
//
// dQ, dK, dV of the function above from its output O and its log-sum-exp
// (FA2 / FA3's backward, laid out for this card).  Three launches:
//   fa_bwd_prep_kernel: Delta = rowsum(dO * O) in f32, the LSE times log2 e
//     (+inf on the rows past Sq, so their P is 0), both padded to whole q
//     tiles, and the f32 dQ accumulator zeroed;
//   fa_bwd_kernel: one CTA per (k tile of BK = 128 keys, kv head, batch).  K
//     and V stay in shared memory; one producer thread streams Q, dO and
//     their LSE / Delta rows by TMA through a two-stage ring, for each of
//     the G query heads of the kv head and each q tile that the causal /
//     window mask leaves (whole masked tiles are skipped; only tiles that
//     straddle a boundary evaluate the mask).  Two consumer warpgroups own
//     64 keys each, so every product has the keys as its 64 rows:
//       S^T = K Q^T, dP^T = V dO^T       (wgmma m64n64k16, ss)
//       P^T = 2^(S^T scale log2 e - LSE log2 e), dS^T = P^T (dP^T - Delta)
//       dV += P^T dO, dK += dS^T Q       (wgmma m64n{D}k16, P^T / dS^T as
//                                         the register A operand)
//       dQ[:, atom w] = dS K[:, atom w]  (m64n64k16, dS^T from shared
//                                         memory, both operands MN-major)
//     dK and dV stay in f32 registers across all G heads (no atomics); each
//     warpgroup's 64-column slice of dQ goes through shared memory into the
//     f32 accumulator by one bulk reduce-add (cp.reduce.async.bulk);
//   fa_bwd_dq_kernel: dQ = scale * accumulator, in q's dtype.
//   Contract in bf16: every product's operands are bf16 (P and dS rounded
//   from f32, as the forward rounds p); accumulation, the LSE, Delta and the
//   dQ accumulator are f32.

template <int D>
struct BwdCfg {
  static constexpr int BK = 128;                       // keys per CTA
  static constexpr int BQ = 64;                        // query rows a tile
  static constexpr int DP = D <= 64 ? 64 : 128;        // smem width
  static constexpr int NA = DP / 64;                   // 128-byte atoms
  static constexpr int KC = (D + 15) / 16;             // k16 steps over D
  static constexpr int STAGES = 2;                     // Q/dO ring depth
  static constexpr uint32_t KV_BYTES = BK * DP * 2;    // K or V
  static constexpr uint32_t Q_BYTES = BQ * DP * 2;     // one Q or dO tile
  static constexpr uint32_t ROW_BYTES = BQ * 4;        // LSE or Delta rows
  static constexpr uint32_t DS_BYTES = BK * BQ * 2;    // dS^T, bf16
  static constexpr uint32_t DQ_BYTES = BQ * 64 * 4;    // one atom of dQ, f32
  static constexpr size_t SMEM = 1024 + 2 * KV_BYTES +
                                 STAGES * (2 * Q_BYTES + 2 * ROW_BYTES) +
                                 2 * DS_BYTES + NA * DQ_BYTES +
                                 (1 + 2 * STAGES) * 8;
};

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// generic-proxy writes to shared memory, made visible to wgmma and bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// contiguous bytes from global into shared memory, completing on an mbarrier
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// global[i] += shared[i] for `bytes` of f32, as one bulk operation
__device__ __forceinline__ void bulk_reduce_add(float* dst, const float* src,
                                                uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
      "[%0], [%1], %2;\n" ::"l"(reinterpret_cast<uint64_t>(dst)),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until this thread's bulk operations have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int D>
__global__ void __launch_bounds__(256) fa_bwd_prep_kernel(
    const __nv_bfloat16* __restrict__ o, int64_t o_sb, int64_t o_sh,
    int64_t o_ss, const __nv_bfloat16* __restrict__ dout, int64_t d_sb,
    int64_t d_sh, int64_t d_ss, const float* __restrict__ lse,
    float* __restrict__ lse2, float* __restrict__ delta,
    float* __restrict__ dq_acc, int Sq, int n_qt) {
  using C = BwdCfg<D>;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y;
  const int part = threadIdx.x & 3;       // four threads a row
  const int row = qt * C::BQ + (threadIdx.x >> 2);
  float acc = 0.f;
  if (row < Sq) {
    const __nv_bfloat16* orow = o + b * o_sb + h * o_sh + row * o_ss;
    const __nv_bfloat16* drow = dout + b * d_sb + h * d_sh + row * d_ss;
    for (int c = part; c < D / 8; c += 4) {
      float x[8], y[8];
      repro::load8(orow + 8 * c, x);
      repro::load8(drow + 8 * c, y);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(x[e], y[e], acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  const int64_t bh = (int64_t)b * H + h;
  if (part == 0) {
    delta[bh * n_qt * C::BQ + row] = acc;
    lse2[bh * n_qt * C::BQ + row] =
        row < Sq ? lse[bh * Sq + row] * LOG2E : __int_as_float(0x7f800000);
  }
  float4* z = reinterpret_cast<float4*>(dq_acc + (bh * n_qt + qt) * C::NA *
                                                     C::BQ * 64);
  for (int i = threadIdx.x; i < C::NA * C::BQ * 16; i += 256)
    z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int D>
__global__ void __launch_bounds__(384, 1)
    fa_bwd_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse2,
                  const float* __restrict__ delta, float* __restrict__ dq_acc,
                  __nv_bfloat16* __restrict__ dk, int64_t dk_sb,
                  int64_t dk_sh, int64_t dk_ss,
                  __nv_bfloat16* __restrict__ dv, int64_t dv_sb,
                  int64_t dv_sh, int64_t dv_ss, int G, int Sq, int Sk,
                  int n_qt, int causal, int window, float scale,
                  float scale_log2) {
  using C = BwdCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, NA = C::NA, NS = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sv = sk + C::KV_BYTES;
  uint8_t* sq = sv + C::KV_BYTES;                      // [NS]
  uint8_t* sdo = sq + NS * C::Q_BYTES;                 // [NS]
  uint8_t* sds = sdo + NS * C::Q_BYTES;                // [2] dS^T
  float* sdq = reinterpret_cast<float*>(sds + 2 * C::DS_BYTES);   // [NA]
  float* slse = sdq + NA * BQ * 64;                    // [NS][BQ]
  float* sdel = slse + NS * BQ;                        // [NS][BQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sdel + NS * BQ);
  uint64_t* full = kv_full + 1;                        // [NS]
  uint64_t* empty = full + NS;                         // [NS]

  const int kb0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y * G;
  // q tiles holding a row that sees a key of this tile
  const int q_lo = causal ? kb0 : 0;
  const int q_hi = window > 0 ? min(Sq, kb0 + BK - 1 + window) : Sq;
  const int t_first = q_lo / BQ;
  const int n_q = max(0, (q_hi + BQ - 1) / BQ - t_first);
  const int n_it = G * n_q;                            // (head, q tile)s

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        PRODUCER_REGS));
    if (tid == 0) {
      mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        tma_load(sk + a * BK * 128, &tk, kv_full, 64 * a, kb0, kvh, b);
        tma_load(sv + a * BK * 128, &tv, kv_full, 64 * a, kb0, kvh, b);
      }
      for (int i = 0; i < n_it; ++i) {
        const int st = i % NS;
        const int h = kvh * G + i / n_q;
        const int qt = t_first + i % n_q;
        mbar_wait(empty + st, ((i / NS) & 1) ^ 1);
        mbar_expect_tx(full + st, 2 * C::Q_BYTES + 2 * C::ROW_BYTES);
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          tma_load(sq + st * C::Q_BYTES + a * BQ * 128, &tq, full + st,
                   64 * a, qt * BQ, h, b);
          tma_load(sdo + st * C::Q_BYTES + a * BQ * 128, &tdo, full + st,
                   64 * a, qt * BQ, h, b);
        }
        const int64_t row = ((int64_t)b * H + h) * n_qt * BQ + qt * BQ;
        bulk_load(slse + st * BQ, lse2 + row, C::ROW_BYTES, full + st);
        bulk_load(sdel + st * BQ, delta + row, C::ROW_BYTES, full + st);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        CONSUMER_REGS));
    const int w = wg - 1;                  // keys kw0 .. kw0 + 63
    const int t = tid - 128 * wg;
    const int kw0 = kb0 + 64 * w;
    // accumulator layout of wgmma m64nN: rows rk0 and rk0 + 8, columns
    // 8n + cq and 8n + cq + 1 of every 8-column chunk n
    const int rk0 = 16 * (t >> 5) + ((t & 31) >> 2);
    const int cq = 2 * (t & 3);
    const uint32_t k_addr = smem_u32(sk), v_addr = smem_u32(sv);

    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dka[j] = dva[j] = 0.f;
    // descriptors of K and V: this warpgroup's rows K-major (S^T, dP^T),
    // K's column atom w MN-major (dQ).  A k-step adds a constant to the
    // address field (16-byte units).  The bases are made opaque in every
    // iteration, so that the compiler recomputes each step's descriptor
    // beside its wgmma instead of keeping all of them live in registers.
    const uint64_t k_rows0 = desc(k_addr + 64 * w * 128, 16, 1024);
    const uint64_t v_rows0 = desc(v_addr + 64 * w * 128, 16, 1024);
    const uint64_t k_cols0 = desc(k_addr + w * BK * 128, BK * 128, 1024);

    mbar_wait(kv_full, 0);
    for (int i = 0; i < n_it; ++i) {
      const int st = i % NS;
      const int h = kvh * G + i / n_q;
      const int qt = t_first + i % n_q;
      const int q0 = qt * BQ;
      const uint32_t q_addr = smem_u32(sq + st * C::Q_BYTES);
      const uint32_t do_addr = smem_u32(sdo + st * C::Q_BYTES);
      uint64_t k_rows = k_rows0, v_rows = v_rows0, k_cols = k_cols0;
      asm volatile("" : "+l"(k_rows), "+l"(v_rows), "+l"(k_cols));
      const uint64_t q_k = desc(q_addr, 16, 1024);     // Q, dO K-major
      const uint64_t do_k = desc(do_addr, 16, 1024);
      const uint64_t q_mn = desc(q_addr, BQ * 128, 1024);   // MN-major
      const uint64_t do_mn = desc(do_addr, BQ * 128, 1024);

      // the previous q tile's dQ reduce has read this warpgroup's buffer
      // before anyone passes the barrier below and writes it again
      if (t == 0) bulk_wait_read();

      // S^T = K Q^T and dP^T = V dO^T, this warpgroup's 64 keys as rows
      float s[32], dp[32];
      mbar_wait(full + st, (i / NS) & 1);
      wgmma_fence();
      Wgmma<64>::ss_init(s, k_rows, q_k);
#pragma unroll
      for (int kc = 1; kc < C::KC; ++kc)
        Wgmma<64>::ss(s, k_rows + ((kc >> 2) * BK * 8 + (kc & 3) * 2),
                      q_k + ((kc >> 2) * BQ * 8 + (kc & 3) * 2));
      wgmma_commit();
      Wgmma<64>::ss_init(dp, v_rows, do_k);
#pragma unroll
      for (int kc = 1; kc < C::KC; ++kc)
        Wgmma<64>::ss(dp, v_rows + ((kc >> 2) * BK * 8 + (kc & 3) * 2),
                      do_k + ((kc >> 2) * BQ * 8 + (kc & 3) * 2));
      wgmma_commit();

      // does any (key, row) of this warpgroup's keys and this tile fall
      // outside the mask?
      const bool masked = kw0 + 64 > Sk || (causal && kw0 + 63 > q0) ||
                          (window > 0 && q0 + BQ - 1 - kw0 >= window);
      const float* lse_t = slse + st * BQ;
      const float* del_t = sdel + st * BQ;
      wgmma_wait<1>();
      fence_regs(s);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * n + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * n + e;
          float p = exp2_approx(s[j] * scale_log2 - ((e & 1) ? l2.y : l2.x));
          if (masked) {
            const int key = kw0 + rk0 + 8 * (e >> 1);
            const int row = q0 + 8 * n + cq + (e & 1);
            if (!(key < Sk && (!causal || row >= key) &&
                  (window <= 0 || row - key < window)))
              p = 0.f;
          }
          s[j] = p;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const float2 d2 = *reinterpret_cast<const float2*>(del_t + 8 * n + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * n + e;
          dp[j] = s[j] * (dp[j] - ((e & 1) ? d2.y : d2.x));
        }
      }
      // P^T and dS^T as the A operand of m64nNk16 (as the forward packs p)
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
          da[kk][e] = pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
        }
      // dS^T into shared memory, rows = keys, 128-byte swizzled: the A
      // operand of dS K.  Register da[kk][e] holds row rk0 + 8 (e & 1),
      // columns 8 (2 kk + (e >> 1)) + cq and the next.
      uint8_t* ds_t = sds + (i & 1) * C::DS_BYTES;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int R = 64 * w + rk0 + 8 * (e & 1);
          const int chunk = (2 * kk + (e >> 1)) ^ (R & 7);
          *reinterpret_cast<uint32_t*>(ds_t + R * 128 + chunk * 16 + cq * 2) =
              da[kk][e];
        }
      fence_proxy_async();
      bar_sync(1, 256);                    // both halves of dS^T written

      // dV += P^T dO and dK += dS^T Q, then dQ[:, atom w] = dS K, each
      // waited for before the next (the dQ slice takes the registers that
      // P^T and dS^T leave)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        Wgmma<D>::rs(dva, pa[kk], do_mn + kk * 128);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        Wgmma<D>::rs(dka, da[kk], q_mn + kk * 128);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pa);
      fence_regs(da);
      mbar_arrive(empty + st);
      // at D = 64 one warpgroup computes dQ: its one column atom
      if (NA == 2 || w == 0) {
        const uint64_t ds_mn = desc(smem_u32(ds_t), BK * 128, 1024);
        float dq[32];
        wgmma_fence();
        Wgmma<64>::ss_tt_init(dq, ds_mn, k_cols);
#pragma unroll
        for (int kk = 1; kk < BK / 16; ++kk)
          Wgmma<64>::ss_tt(dq, ds_mn + kk * 128, k_cols + kk * 128);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        // dQ's slice into shared memory in the accumulator's own order
        // (register 4 i + e of thread t at float4 i * 128 + t), then one
        // bulk reduce-add into the f32 accumulator
        float4* dst = reinterpret_cast<float4*>(sdq + w * BQ * 64);
#pragma unroll
        for (int i4 = 0; i4 < 8; ++i4)
          dst[i4 * 128 + t] = make_float4(dq[4 * i4], dq[4 * i4 + 1],
                                          dq[4 * i4 + 2], dq[4 * i4 + 3]);
        fence_proxy_async();
        bar_sync(2 + w, 128);
        if (t == 0)
          bulk_reduce_add(
              dq_acc + ((((int64_t)b * H + h) * n_qt + qt) * NA + w) * BQ * 64,
              sdq + w * BQ * 64, C::DQ_BYTES);
      }
    }
    if (t == 0) bulk_wait();

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kw0 + rk0 + 8 * r;
      if (key < Sk) {
        __nv_bfloat16* krow = dk + b * dk_sb + kvh * dk_sh + key * dk_ss;
        __nv_bfloat16* vrow = dv + b * dv_sb + kvh * dv_sh + key * dv_ss;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          *reinterpret_cast<__nv_bfloat162*>(krow + 8 * n + cq) =
              __floats2bfloat162_rn(dka[4 * n + 2 * r] * scale,
                                    dka[4 * n + 2 * r + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * n + cq) =
              __floats2bfloat162_rn(dva[4 * n + 2 * r],
                                    dva[4 * n + 2 * r + 1]);
        }
      }
    }
  }
}

// dq = scale * the accumulator of one q tile of one head: read in its
// register order (see above), transposed through shared memory, written as
// 16-byte row chunks
template <int D>
__global__ void __launch_bounds__(256) fa_bwd_dq_kernel(
    const float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dq,
    int64_t sb, int64_t sh, int64_t ss, int Sq, int n_qt, float scale) {
  using C = BwdCfg<D>;
  constexpr int BQ = C::BQ, W = C::DP + 4;   // padded rows
  __shared__ float tile[BQ * W];
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const float4* src = reinterpret_cast<const float4*>(
      dq_acc + (((int64_t)b * gridDim.y + h) * n_qt + qt) * C::NA * BQ * 64);
  for (int f = threadIdx.x; f < C::NA * 8 * 128; f += 256) {
    const int t = f & 127, i = (f >> 7) & 7, a = f >> 10;
    const int r = 16 * (t >> 5) + ((t & 31) >> 2);
    const int col = 64 * a + 8 * i + 2 * (t & 3);
    const float4 x = src[f];
    *reinterpret_cast<float2*>(tile + r * W + col) = make_float2(x.x, x.y);
    *reinterpret_cast<float2*>(tile + (r + 8) * W + col) =
        make_float2(x.z, x.w);
  }
  __syncthreads();
  __nv_bfloat16* base = dq + b * sb + h * sh;
  for (int c = threadIdx.x; c < BQ * (D / 8); c += 256) {
    const int r = c / (D / 8), col = 8 * (c % (D / 8));
    const int row = qt * BQ + r;
    if (row >= Sq) continue;
    const float* x = tile + r * W + col;
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = pack_bf16(x[2 * e] * scale, x[2 * e + 1] * scale);
    *reinterpret_cast<uint4*>(base + row * ss + col) = out;
  }
}

template <int D>
int launch_bwd(const void* const* p, int B, int H, int KV, int Sq, int Sk,
               const int64_t* st, int causal, int window, float scale,
               cudaStream_t stream) {
  using C = BwdCfg<D>;
  // p: q, k, v, o, dout, lse, dq, dk, dv, dq_acc, lse2, delta
  static const cudaError_t attr = cudaFuncSetAttribute(
      fa_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map(&tq, p[0], B, H, Sq, D, st, C::BQ);
  if (!err) err = make_map(&tk, p[1], B, KV, Sk, D, st + 3, C::BK);
  if (!err) err = make_map(&tv, p[2], B, KV, Sk, D, st + 6, C::BK);
  if (!err) err = make_map(&tdo, p[4], B, H, Sq, D, st + 12, C::BQ);
  if (err) return err;
  using bf = __nv_bfloat16;
  const int n_qt = (Sq + C::BQ - 1) / C::BQ;
  float* lse2 = static_cast<float*>(const_cast<void*>(p[10]));
  float* delta = static_cast<float*>(const_cast<void*>(p[11]));
  float* acc = static_cast<float*>(const_cast<void*>(p[9]));
  fa_bwd_prep_kernel<D><<<dim3(n_qt, H, B), 256, 0, stream>>>(
      static_cast<const bf*>(p[3]), st[9], st[10], st[11],
      static_cast<const bf*>(p[4]), st[12], st[13], st[14],
      static_cast<const float*>(p[5]), lse2, delta, acc, Sq, n_qt);
  fa_bwd_kernel<D><<<dim3((Sk + C::BK - 1) / C::BK, KV, B), 384, C::SMEM,
                     stream>>>(
      tq, tk, tv, tdo, lse2, delta, acc,
      static_cast<bf*>(const_cast<void*>(p[7])), st[18], st[19], st[20],
      static_cast<bf*>(const_cast<void*>(p[8])), st[21], st[22], st[23],
      H / KV, Sq, Sk, n_qt, causal, window, scale, scale * LOG2E);
  fa_bwd_dq_kernel<D><<<dim3(n_qt, H, B), 256, 0, stream>>>(
      acc, static_cast<bf*>(const_cast<void*>(p[6])), st[15], st[16], st[17],
      Sq, n_qt, scale);
  return (int)cudaGetLastError();
}


}  // namespace wgmma_route

}  // namespace

extern "C" {

// Element strides, in order: q (b, h, s), k (b, h, s), v (b, h, s),
// o (b, h, s); the head_dim axis is contiguous in every tensor.
// The "fma" route: f32 at any compiled head_dim; bf16 at the head dims the
// wgmma route does not take (16, 32).
int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int dtype, int B, int H,
                              int KV, int Sq, int Sk, int D,
                              const int64_t* strides, int causal, int window,
                              float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == repro::BF16) {
#define FA_FMA_BF16_CASE(DV)                                             \
  case DV:                                                               \
    return fma_route::launch<__nv_bfloat16, DV>(                         \
        q, k, v, o, l, B, H, KV, Sq, Sk, strides, causal, window, scale, s);
    switch (D) {
      FA_FMA_BF16_CASE(16)
      FA_FMA_BF16_CASE(32)
    }
#undef FA_FMA_BF16_CASE
  } else if (dtype == repro::F32) {
    REPRO_DISPATCH_D(D, return fma_route::launch<float, kD>(
        q, k, v, o, l, B, H, KV, Sq, Sk, strides, causal, window, scale, s);)
  }
  return (int)cudaErrorInvalidValue;
}

// The "wgmma" route: bf16, D in {64, 80, 96, 112, 128, 256}.  Strides as
// above; the b/h/s strides of q, k and v are multiples of 8 elements and
// the bases 16-byte aligned (TMA's rule; the Python wrapper checks).
int repro_flash_attention_wgmma_fwd(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int B,
                                    int H, int KV, int Sq, int Sk, int D,
                                    const int64_t* strides, int causal,
                                    int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define FA_WGMMA_CASE(DV)                                                 \
  case DV:                                                                \
    return wgmma_route::launch<DV>(q, k, v, o, l, B, H, KV, Sq, Sk,       \
                                   strides, causal, window, scale, s);
  switch (D) {
    FA_WGMMA_CASE(64)
    FA_WGMMA_CASE(80)
    FA_WGMMA_CASE(96)
    FA_WGMMA_CASE(112)
    FA_WGMMA_CASE(128)
    FA_WGMMA_CASE(256)
  }
#undef FA_WGMMA_CASE
  return (int)cudaErrorInvalidValue;
}

// The backward of the "wgmma" route: bf16, D in {64, 80, 96, 112, 128}.
// Pointers: q, k, v, o, dout, lse (f32 (B, H, Sq)), dq, dk, dv, then the
// f32 scratch the wrapper allocates: the dQ accumulator (B*H*n_qt*NA*4096),
// the scaled LSE and Delta (B*H*n_qt*64 each), n_qt = ceil(Sq / 64), NA = 1
// at D = 64 and 2 above.  Element strides (b, h, s) of q, k, v, o, dout,
// dq, dk, dv; q, k, v and dout as TMA takes them (see the forward).
int repro_flash_attention_wgmma_bwd(const void* const* ptrs, int B, int H,
                                    int KV, int Sq, int Sk, int D,
                                    const int64_t* strides, int causal,
                                    int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_BWD_CASE(DV)                                                  \
  case DV:                                                               \
    return wgmma_route::launch_bwd<DV>(ptrs, B, H, KV, Sq, Sk, strides,  \
                                       causal, window, scale, s);
  switch (D) {
    FA_BWD_CASE(64)
    FA_BWD_CASE(80)
    FA_BWD_CASE(96)
    FA_BWD_CASE(112)
    FA_BWD_CASE(128)
  }
#undef FA_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

const char* repro_flash_attention_error(int code) {
  static char buf[96];
  if (code >= wgmma_route::ERR_NO_ENCODE)
    return "cuTensorMapEncodeTiled not found";
  if (code >= wgmma_route::ERR_TMA) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             code - wgmma_route::ERR_TMA);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
