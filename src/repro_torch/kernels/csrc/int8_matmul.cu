// Blockwise-int8 weight x fp32 activation matmul for the quantized serving
// head, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/int8_matmul.py: int8_matmul
// (def :50, pl.pallas_call :64)
//     out[m, n] = sum_k x[m, k] * q[k, n] * scale[k, n / 128]
// q is int8 (K, N); scale is fp32 (K, ceil(N / 128)), one absmax scale per
// 128-wide block of each weight row (the form of src/repro/optim/quant.py).
//
// What bounds it, at the serving shapes (M = 128 rows per adapt chunk or
// 32 per query dispatch, K = N = 256): 2*M*K*N = 16.8 MFLOP at M = 128
// over 0.32 MB, 0.25 us at the card's fp32 rate and 0.10 us at its memory
// rate.  Neither is near: the kernel is bound by latency, the launch and
// the round trips from device memory to shared memory, and then by the
// length of each thread's chain of dependent FMAs.  The first design (32
// blocks of 32 x 32 on 132 SMs, K walked in eight 32-deep slabs, each a
// full load round trip behind two barriers, q read one byte a thread) took
// 15 us.
//
// Design.
// * The scale is folded into x, not into q.  An output tile lies inside one
//   128-column quantisation block (its width, 32, divides 128), so it needs
//   one scale per k: x'[m, k] = x[m, k] * scale[k, n0 / 128] (fp32), formed
//   once a block, in the registers of the one warp that uses it, where
//   scaling the weight would take K x 32 multiplies; q enters the FMAs
//   through an exact int8 -> fp32 conversion (|q| <= 127).  The rounding
//   becomes (x * s) * q instead of x * (q * s): at most one ulp a product.
// * Enough blocks, and short chains: output tiles of TM x 32 (TM 8, or 4
//   where 8 would leave fewer than 128 blocks: 128 blocks at M = 128, 64 at
//   M = 32), and K split over 8 groups of 2 warps inside the block, so a
//   thread's chain is K / 8 FMAs for each of its TM / 2 rows.  The groups'
//   partial tiles meet in shared memory and group 0 adds them in group
//   order: the same bits on every run.  (Splitting K over a thread-block
//   cluster instead, the partials meeting in rank 0's distributed shared
//   memory, cost a cluster barrier and was slower on an H100.)
// * One load round trip a block: each block stages the x rows, q columns
//   and scale column of its whole K (up to 256 rows at once; a longer K
//   streams through two stages of 256) by cp.async, 16 bytes a copy for x
//   and q where K % 4 == 0, N % 16 == 0 and both bases are 16-byte aligned
//   ("cp16"); otherwise x by 4-byte cp.async and q by byte loads ("cp4"), a
//   branch of the same kernel.  The scale column, strided by ceil(N / 128),
//   goes by 4-byte cp.async on both.
// * Ragged M, K and N are zero filled on load and masked on store, so no
//   padded copy of any operand is made.
// The planner (int8_matmul.py::int8_matmul_plan) picks the tile, the
// stages and the copy path before the launch.
//
// No tensor-core (wgmma) route at these shapes: 16.8 MFLOP would take about
// 17 ns at the bf16 tensor-core rate, so the tensor cores have nothing to
// win against the microseconds of latency above; fp32 x would have to be
// split three ways into bf16 (as ssd_scan.cu does), whose route reads
// 8.65e-5 per row, above this kernel's 1e-5; and no path of the repo calls
// the kernel with M > 128.  The int8 x int8 tensor-core path does not
// apply: x is float.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTileN = 32;  // output columns a block; divides 128
constexpr int kGroups = 8;  // K groups a block, 2 warps each
constexpr int kThreads = kGroups * 2 * 32;
constexpr int kQuantBlock = 128;
constexpr int kMaxStages = 2;

// Shared memory of one stage of `kc` K rows: x [tm][kc] fp32, the scale
// column [kc] fp32, q [kc][kTileN] int8.
__host__ __device__ constexpr size_t stage_bytes(int tm, int kc) {
  return (size_t)kc * (4 * tm + 4 + kTileN);
}

// Stage K rows [k0, k0 + kc) of x, q and the scale column of the block's
// output tile (m0, n0) into shared memory, rows at or past K as zeros, and
// commit the copies as one group.  Every thread calls it.
template <int TM>
__device__ __forceinline__ void stage(uint8_t* buf, const float* __restrict__ x,
                                      const int8_t* __restrict__ q,
                                      const float* __restrict__ scale, int M, int K, int N,
                                      int NB, int m0, int n0, int k0, int kc, bool vec) {
  float* xs = (float*)buf;
  float* ss = xs + TM * kc;
  int8_t* qs = (int8_t*)(ss + kc);
  const int nb = n0 / kQuantBlock;
  for (int e = threadIdx.x; e < kc; e += kThreads) {
    const int k = k0 + e;
    hopper::cp_async4(ss + e, k < K ? scale + (size_t)k * NB + nb : scale, k < K);
  }
  if (vec) {
    // K % 4 == 0: a 16-byte piece of a row of x lies wholly inside or
    // outside K; N % 16 == 0 does the same for a piece of a row of q
    const int pieces = kc / 4;
    for (int e = threadIdx.x; e < TM * pieces; e += kThreads) {
      const int r = e / pieces, kk = (e - r * pieces) * 4;
      const int m = m0 + r, k = k0 + kk;
      const bool ok = m < M && k < K;
      hopper::cp_async16(xs + r * kc + kk, ok ? x + (size_t)m * K + k : x, ok);
    }
    for (int e = threadIdx.x; e < kc * (kTileN / 16); e += kThreads) {
      const int r = e / (kTileN / 16), nn = (e % (kTileN / 16)) * 16;
      const int k = k0 + r, n = n0 + nn;
      const bool ok = k < K && n < N;
      hopper::cp_async16(qs + r * kTileN + nn, ok ? q + (size_t)k * N + n : q, ok);
    }
  } else {
    for (int e = threadIdx.x; e < TM * kc; e += kThreads) {
      const int r = e / kc, kk = e - r * kc;
      const int m = m0 + r, k = k0 + kk;
      const bool ok = m < M && k < K;
      hopper::cp_async4(xs + e, ok ? x + (size_t)m * K + k : x, ok);
    }
    for (int e = threadIdx.x; e < kc * kTileN; e += kThreads) {
      const int r = e / kTileN, nn = e % kTileN;
      const int k = k0 + r, n = n0 + nn;
      qs[e] = (k < K && n < N) ? q[(size_t)k * N + n] : (int8_t)0;
    }
  }
  hopper::cp_async_commit();
}

// Grid (ceil(N / 32), ceil(M / TM)), kThreads threads: warp w is half h =
// w % 2 of K group g = w / 2; its lanes are the tile's columns, and each
// thread sums rows h * TM / 2 .. + TM / 2 - 1 over K rows [g * kc / 8, (g + 1)
// * kc / 8) of every chunk of kc, chunks in order.  Dynamic shared memory:
// `stages` stages of `kc` K rows (stage_bytes).
template <int TM>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                       const float* __restrict__ scale, float* __restrict__ out, int M, int K,
                       int N, int NB, int kc, int stages, int vec) {
  constexpr int R = TM / 2;  // rows a thread
  const int n0 = blockIdx.x * kTileN, m0 = blockIdx.y * TM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = warp >> 1, h = warp & 1;
  const int nchunks = max(1, (K + kc - 1) / kc);
  const int kg = kc / kGroups;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float part[kGroups - 1][TM * kTileN];  // groups 1.. for group 0
  const size_t sb = stage_bytes(TM, kc);

  for (int s = 0; s < stages && s < nchunks; ++s)
    stage<TM>(smem + s * sb, x, q, scale, M, K, N, NB, m0, n0, s * kc, kc, vec);

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int ch = 0; ch < nchunks; ++ch) {
    uint8_t* buf = smem + (ch % stages) * sb;
    if (ch + 1 < nchunks && stages > 1)  // the next stage's copies may stay in flight
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    const float* xs = (const float*)buf + h * R * kc;
    const float* ss = (const float*)buf + TM * kc;
    const int8_t* qs = (const int8_t*)(ss + kc);
    // k in order, four at a time: x' = x * s (the scale folded into x),
    // then acc += x' * q; loads of x and s are broadcasts
    for (int kk = g * kg; kk < (g + 1) * kg; kk += 4) {
      const float4 sv = *(const float4*)(ss + kk);
      float w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = (float)qs[(kk + j) * kTileN + lane];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 xv = *(const float4*)(xs + r * kc + kk);
        acc[r] = fmaf(xv.x * sv.x, w[0], acc[r]);
        acc[r] = fmaf(xv.y * sv.y, w[1], acc[r]);
        acc[r] = fmaf(xv.z * sv.z, w[2], acc[r]);
        acc[r] = fmaf(xv.w * sv.w, w[3], acc[r]);
      }
    }
    if (ch + stages < nchunks) {
      __syncthreads();  // every thread is done with this stage
      stage<TM>(buf, x, q, scale, M, K, N, NB, m0, n0, (ch + stages) * kc, kc, vec);
    }
  }
  // the groups' partial tiles, added by group 0 in group order
  if (g > 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) part[g - 1][(h * R + r) * kTileN + lane] = acc[r];
  }
  __syncthreads();
  if (g > 0) return;
  const int n = n0 + lane;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int m = m0 + h * R + r;
    float v = acc[r];
#pragma unroll
    for (int p = 0; p < kGroups - 1; ++p) v += part[p][(h * R + r) * kTileN + lane];
    if (m < M && n < N) out[(size_t)m * N + n] = v;
  }
}

template <int TM>
cudaError_t launch(const void* x, const void* q, const void* scale, void* out, int M, int K,
                   int N, int NB, int kc, int stages, int vec, cudaStream_t stream) {
  const size_t smem = stages * stage_bytes(TM, kc);
  if (smem > 48 * 1024) {
    const cudaError_t e = hopper::allow_smem(int8_matmul_kernel<TM>, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)((N + kTileN - 1) / kTileN), (unsigned)((M + TM - 1) / TM));
  int8_matmul_kernel<TM><<<grid, kThreads, smem, stream>>>(
      (const float*)x, (const int8_t*)q, (const float*)scale, (float*)out, M, K, N, NB, kc,
      stages, vec);
  return cudaGetLastError();
}

}  // namespace

// x: (M, K) fp32; q: (K, N) int8; scale: (K, NB) fp32 with NB = ceil(N / 128);
// out: (M, N) fp32.  All contiguous.  The plan (int8_matmul.py::
// int8_matmul_plan): output tiles of `tm` (4 or 8) x 32 rows, K in chunks
// of `kc` rows (a multiple of 32) through `stages` stages, `vec` the copy
// path.  Returns the cudaError_t of the launch.
extern "C" int rt_int8_matmul(const void* x, const void* q, const void* scale, void* out, int M,
                              int K, int N, int NB, int tm, int kc, int stages, int vec,
                              void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K < 1 || kc < 32 || kc % 32 != 0 || stages < 1 || stages > kMaxStages ||
      (stages == 1 && kc < K))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (tm == 8) return (int)launch<8>(x, q, scale, out, M, K, N, NB, kc, stages, vec, s);
  if (tm == 4) return (int)launch<4>(x, q, scale, out, M, K, N, NB, kc, stages, vec, s);
  return (int)cudaErrorInvalidValue;
}
