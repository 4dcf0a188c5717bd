// Causal / sliding-window GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_fwd / _kernel).  Same function: S = (q * D^-0.5) k^T,
// masked scores are -1e30, p is zeroed by the mask, the online-softmax
// state (m, l, acc) is f32, l is clamped at 1e-30, and the output is
// written in q's dtype.  Query head h reads kv head h / G.  Any Sq and Sk
// are accepted (the ragged tile is masked), and q/k/v/o are read through
// their strides (the model's (B,S,H,D) tensors, transposed).
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

}  // namespace fma_route

namespace wgmma_route {

using repro::NEG_INF;

constexpr float LOG2E = 1.4426950408889634f;
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

template <int D>
__global__ void __launch_bounds__(128 * (Cfg<D>::NWG + 1), 1)
    fa_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ o, int64_t o_sb,
                    int64_t o_sh, int64_t o_ss, int G, int Sq, int Sk,
                    int causal, int window, float scale_log2) {
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
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int Sq, int Sk, const int64_t* st, int causal,
           int window, float scale, cudaStream_t stream) {
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
      H / KV, Sq, Sk, causal, window, scale * LOG2E);
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
                              void* o, int dtype, int B, int H, int KV,
                              int Sq, int Sk, int D, const int64_t* strides,
                              int causal, int window, float scale,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::BF16) {
#define FA_FMA_BF16_CASE(DV)                                             \
  case DV:                                                               \
    return fma_route::launch<__nv_bfloat16, DV>(                         \
        q, k, v, o, B, H, KV, Sq, Sk, strides, causal, window, scale, s);
    switch (D) {
      FA_FMA_BF16_CASE(16)
      FA_FMA_BF16_CASE(32)
    }
#undef FA_FMA_BF16_CASE
  } else if (dtype == repro::F32) {
    REPRO_DISPATCH_D(D, return fma_route::launch<float, kD>(
        q, k, v, o, B, H, KV, Sq, Sk, strides, causal, window, scale, s);)
  }
  return (int)cudaErrorInvalidValue;
}

// The "wgmma" route: bf16, D in {64, 80, 96, 112, 128, 256}.  Strides as
// above; the b/h/s strides of q, k and v are multiples of 8 elements and
// the bases 16-byte aligned (TMA's rule; the Python wrapper checks).
int repro_flash_attention_wgmma_fwd(const void* q, const void* k,
                                    const void* v, void* o, int B, int H,
                                    int KV, int Sq, int Sk, int D,
                                    const int64_t* strides, int causal,
                                    int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_WGMMA_CASE(DV)                                                 \
  case DV:                                                                \
    return wgmma_route::launch<DV>(q, k, v, o, B, H, KV, Sq, Sk, strides, \
                                   causal, window, scale, s);
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
