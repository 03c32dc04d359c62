// Blockwise-int8 weight x fp32 activation matmul for the quantized serving
// head, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/int8_matmul.py: int8_matmul
// (def :50, pl.pallas_call :64)
//     out[m, n] = sum_k x[m, k] * q[k, n] * scale[k, n / 128]
// q is int8 (K, N); scale is fp32 (K, ceil(N / 128)), one absmax scale per
// 128-wide block of each weight row (the form of src/repro/optim/quant.py).
//
// The scale varies along K, so it cannot be applied after the dot: each
// (32 x 32) int8 weight tile is dequantized with its scales as it is loaded
// into shared memory, and the products accumulate in fp32.  The int8 x int8
// tensor-core path does not apply, because the activations are float.
//
// What bounds it, at the serving shapes (M = 128 rows per adapt chunk or
// 32 per query dispatch, K = N = 256): 2*M*K*N = 17 MFLOP at M = 128 over
// 0.26 MB, so neither bound is near; the launch dominates.  The kernel is a
// plain shared-memory tiled SGEMM: one block per 32 x 32 output tile, 256
// threads, 4 outputs per thread, K walked in 32-deep slabs.  Ragged M, K
// and N are zero filled on load and masked on store, so no padded copy of
// any operand is made.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 32, kBN = 32, kBK = 32, kTy = 8;
constexpr int kQuantBlock = 128;

__global__ void int8_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                                   const float* __restrict__ scale, float* __restrict__ out,
                                   int M, int K, int N, int NB) {
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tx = threadIdx.x, ty = threadIdx.y;
  __shared__ float xs[kBM][kBK + 1];
  __shared__ float ws[kBK][kBN];
  float acc[kBM / kTy];
#pragma unroll
  for (int r = 0; r < kBM / kTy; ++r) acc[r] = 0.f;
  const int n = n0 + tx;
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int s = 0; s < kBM / kTy; ++s) {
      const int r = ty + kTy * s;
      const int m = m0 + r, kx = k0 + tx;
      xs[r][tx] = (m < M && kx < K) ? x[(size_t)m * K + kx] : 0.f;
      const int kw = k0 + r;
      ws[r][tx] = (kw < K && n < N)
                      ? (float)q[(size_t)kw * N + n] * scale[(size_t)kw * NB + n / kQuantBlock]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      const float wv = ws[k][tx];
#pragma unroll
      for (int r = 0; r < kBM / kTy; ++r) acc[r] = fmaf(xs[ty + kTy * r][k], wv, acc[r]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kBM / kTy; ++r) {
    const int m = m0 + ty + kTy * r;
    if (m < M && n < N) out[(size_t)m * N + n] = acc[r];
  }
}

}  // namespace

// x: (M, K) fp32; q: (K, N) int8; scale: (K, NB) fp32 with NB = ceil(N / 128);
// out: (M, N) fp32.  All contiguous.  Returns the cudaError_t of the launch.
extern "C" int rt_int8_matmul(const void* x, const void* q, const void* scale, void* out, int M,
                              int K, int N, int NB, void* stream) {
  if (M == 0 || N == 0) return 0;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  dim3 block(kBN, kTy);
  int8_matmul_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int8_t*)q, (const float*)scale, (float*)out, M, K, N, NB);
  return (int)cudaGetLastError();
}
