// RG-LRU linear recurrence h_t = exp(log_a_t) * h_{t-1} + b_t for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru.py (rglru_fwd /
// _kernel).  Same function: f32 inputs (B, S, dr), h_0 = 0, f32 output.
// Any S is accepted (odd S included).
//
// Bound.  Two f32 arrays are read and one is written once: at
// recurrentgemma's prefill (1, 2048, 2560) that is 63 MB, ~0.019 ms at
// 3.35 TB/s.  The arithmetic (an exp and an FMA per element) is far below
// the card's rate, so the kernel is bound by bytes, if enough loads are in
// flight to cover the memory latency that the serial dependence on h would
// otherwise expose.
//
// Design: the sequence is split across CTAs.
// - A tile is 32 channels (a warp's loads of one time step are 128
//   contiguous bytes) by TILE = 16 * 16 steps: warp w of the CTA scans
//   steps [16w, 16w + 16) of the tile from h = 0, all 32 of its loads
//   issued first, and keeps the local h and the running sum of log_a of
//   each step in registers.  At (1, 2048, 2560) that is 80 * 8 = 640
//   tiles of 512 threads, on 132 SMs.  Per-thread chains of 16 steps
//   stream faster than chains of 32 (8 warps), and 256-step tiles keep
//   the look-back short.
// - The carry: the closed form of the reference, h_t = h_local_t +
//   exp(cum_t) * h_in with cum_t a partial sum of log_a <= 0, so every
//   exponent is <= 0 and no rescaling is needed (slow decay, log_a ~
//   -1e-4, carries h_in almost undamped over many tiles; that is exact
//   math, not an approximation).  The warps' aggregates (sum of log_a,
//   local h at the end) are composed in shared memory.
// - Across tiles, a single pass with decoupled look-back: each CTA takes
//   its tile by an atomic ticket in step-major order (so every tile it
//   waits on has already started: forward progress), publishes its
//   aggregate (sum of log_a, h at its end from 0) behind a flag, walks
//   back over its predecessors' flags (composing aggregates until it meets
//   an inclusive prefix), publishes its own inclusive prefix, and writes h
//   from registers.  The inputs are read once.  A memset zeroes the flags
//   and the ticket before the kernel.  The other design, a first kernel
//   writing the aggregates and a second composing them and rescanning,
//   reads the inputs twice, and ran slower on the H100.
#include "common.cuh"

namespace {

constexpr int NW = 16;           // warps per CTA: consecutive step ranges
constexpr int NT = NW * 32;      // threads per CTA
constexpr int L = 16;            // steps per warp
constexpr int TILE = NW * L;     // steps per tile

struct Tile {
  int b, ti, cb;                 // batch, tile along S, 32-channel block
};

// One warp's steps [t0, t0 + L) of channel c from h = 0: cum[i] becomes
// the sum of log_a over steps t0..t0+i, hl[i] the local h at t0+i.
// Steps past S (and channels past dr) read as log_a = b = 0.
__device__ __forceinline__ void warp_scan(const float* __restrict__ la,
                                          const float* __restrict__ bb,
                                          int dr, int t0, int S, bool valid,
                                          float (&cum)[L], float (&hl)[L]) {
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const bool in = valid && t0 + i < S;
    cum[i] = in ? __ldg(la + (int64_t)i * dr) : 0.f;
    hl[i] = in ? __ldg(bb + (int64_t)i * dr) : 0.f;
  }
  float c = 0.f, h = 0.f;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    h = fmaf(expf(cum[i]), h, hl[i]);
    c += cum[i];
    cum[i] = c;
    hl[i] = h;
  }
}

// Scan the tile's warps and leave their aggregates in sA/sH[warp][lane].
__device__ __forceinline__ void tile_scan(
    const float* __restrict__ log_a, const float* __restrict__ b, int S,
    int dr, const Tile& t, float (&cum)[L], float (&hl)[L],
    float (*sA)[32], float (*sH)[32]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = t.cb * 32 + lane;
  const int t0 = t.ti * TILE + warp * L;
  const int64_t off = ((int64_t)t.b * S + t0) * dr + c;
  warp_scan(log_a + off, b + off, dr, t0, S, c < dr, cum, hl);
  sA[warp][lane] = cum[L - 1];
  sH[warp][lane] = hl[L - 1];
}

// Compose the warps' aggregates into the tile's (A, H): h_end = H +
// exp(A) * h_in.  Lane = channel, called by one warp.
__device__ __forceinline__ void tile_aggregate(float (*sA)[32],
                                               float (*sH)[32],
                                               int lane, float& A, float& H) {
  A = 0.f;
  H = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    H = fmaf(expf(sA[w][lane]), H, sH[w][lane]);
    A += sA[w][lane];
  }
}

// Given the tile's carry-in h_in (warp 0), hand each warp its own carry
// and write h = h_local + exp(cum) * carry.
__device__ __forceinline__ void tile_write(
    float* __restrict__ h, int S, int dr, const Tile& t, float h_in,
    const float (&cum)[L], const float (&hl)[L], float (*sA)[32],
    float (*sH)[32], float (*sC)[32]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    float carry = h_in;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      sC[w][lane] = carry;
      carry = fmaf(expf(sA[w][lane]), carry, sH[w][lane]);
    }
  }
  __syncthreads();
  const float carry = sC[warp][lane];
  const int c = t.cb * 32 + lane;
  const int t0 = t.ti * TILE + warp * L;
  if (c >= dr) return;
  float* hh = h + ((int64_t)t.b * S + t0) * dr + c;
#pragma unroll
  for (int i = 0; i < L; ++i)
    if (t0 + i < S) hh[(int64_t)i * dr] = fmaf(expf(cum[i]), carry, hl[i]);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}

// Scratch: the tiles' aggregates A and H and inclusive prefixes, each
// (B, nT, nCB * 32) f32; flags (B, nT, nCB) int (1: aggregate published,
// 2: inclusive prefix published); the ticket.  Flags and ticket are zero
// on entry.
__global__ void __launch_bounds__(NT) rglru_kernel(
    const float* __restrict__ log_a, const float* __restrict__ b,
    float* __restrict__ h, float* __restrict__ aggA,
    float* __restrict__ aggH, float* __restrict__ incl,
    int* __restrict__ flags, int* __restrict__ ticket, int B, int S, int dr,
    int nT, int nCB) {
  __shared__ float sA[NW][32], sH[NW][32], sC[NW][32];
  __shared__ int s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  const int k = s_ticket, per = B * nCB;
  Tile t;
  t.ti = k / per;
  t.b = (k - t.ti * per) / nCB;
  t.cb = k - t.ti * per - t.b * nCB;
  float cum[L], hl[L];
  tile_scan(log_a, b, S, dr, t, cum, hl, sA, sH);
  __syncthreads();
  float h_in = 0.f;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int64_t row = (int64_t)t.b * nT;      // tile index base
    const int64_t cidx = (int64_t)t.cb * 32 + lane;
    const int64_t width = (int64_t)nCB * 32;
    float A, H;
    tile_aggregate(sA, sH, lane, A, H);
    int* my_flag = flags + (row + t.ti) * nCB + t.cb;
    if (t.ti > 0) {
      aggA[(row + t.ti) * width + cidx] = A;
      aggH[(row + t.ti) * width + cidx] = H;
      __threadfence();
      __syncwarp();
      if (lane == 0) st_release(my_flag, 1);
      // look back: carry = Hacc + exp(Aacc) * h_end(j)
      float Aacc = 0.f, Hacc = 0.f;
      int j = t.ti - 1;
      for (; j >= 0; --j) {
        const int* f = flags + (row + j) * nCB + t.cb;
        int st;
        while ((st = ld_acquire(f)) == 0) {
        }
        const int64_t at = (row + j) * width + cidx;
        if (st == 2) {
          h_in = fmaf(expf(Aacc), __ldcg(incl + at), Hacc);
          break;
        }
        Hacc = fmaf(expf(Aacc), __ldcg(aggH + at), Hacc);
        Aacc += __ldcg(aggA + at);
      }
      if (j < 0) h_in = Hacc;
    }
    incl[(row + t.ti) * width + cidx] = fmaf(expf(A), h_in, H);
    __threadfence();
    __syncwarp();
    if (lane == 0) st_release(my_flag, 2);
  }
  tile_write(h, S, dr, t, h_in, cum, hl, sA, sH, sC);
}

int64_t scratch_bytes(int B, int S, int dr) {
  const int64_t nT = (S + TILE - 1) / TILE, nCB = (dr + 31) / 32;
  return 3 * B * nT * nCB * 32 * 4 + (B * nT * nCB + 1) * 4;
}

}  // namespace

extern "C" {

// Bytes of device scratch one call needs (16-byte aligned by the caller).
int64_t repro_rglru_scratch_bytes(int B, int S, int dr) {
  return scratch_bytes(B, S, dr);
}

// log_a, b, h: contiguous (B, S, dr) f32; scratch of
// repro_rglru_scratch_bytes bytes.
int repro_rglru_fwd(const float* log_a, const float* b, float* h,
                    void* scratch, int B, int S, int dr, void* stream) {
  if (B < 1 || S < 1 || dr < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nT = (S + TILE - 1) / TILE, nCB = (dr + 31) / 32;
  const int64_t vals = (int64_t)B * nT * nCB * 32;
  float* aggA = static_cast<float*>(scratch);
  float* aggH = aggA + vals;
  float* incl = aggH + vals;
  int* flags = reinterpret_cast<int*>(incl + vals);
  const int64_t nflags = (int64_t)B * nT * nCB;
  cudaError_t err = cudaMemsetAsync(flags, 0, (nflags + 1) * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  rglru_kernel<<<(unsigned)nflags, NT, 0, st>>>(
      log_a, b, h, aggA, aggH, incl, flags, flags + nflags, B, S, dr, nT,
      nCB);
  return (int)cudaGetLastError();
}

const char* repro_rglru_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
