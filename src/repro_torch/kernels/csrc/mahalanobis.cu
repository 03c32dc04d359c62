// Simple CNAPs Mahalanobis head, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/mahalanobis.py: mahalanobis
// (def :29, pl.pallas_call :37)
//     d2[t, m, c] = (q[t, m] - mu[t, c])^T Sinv[t, c] (q[t, m] - mu[t, c])
// with a leading task-lane axis t.
//
// The TPU kernel keeps the whole (F, F) Sinv tile in VMEM.  At F = 256 in
// fp32 that is 256 KiB, more than the 227 KB of shared memory a block may
// use on the H100, so the kernel streams Sinv instead.
//
// What bounds it, at the serving shape (T=4 lanes, M=8 queries per lane,
// C=5 ways, F=256): reading Sinv, T*C*F^2*4 = 5.2 MB, against
// 2*T*C*M*F^2 = 21 MFLOP.  So it is bound by bytes, and every Sinv element
// must be read once only.  One block per (t, c, tile of 8 queries) keeps the
// 8 difference rows (8 x F fp32) in shared memory.  Thread j owns column j
// of Sinv: it walks the rows i in order, each load coalesced across the
// warp, and forms t[m, j] = sum_i diff[m, i] * Sinv[i, j] for the 8 rows in
// registers.  Each Sinv element is used by one thread only, so staging it in
// shared memory would add a copy without reuse.  The final sum over j of
// t[m, j] * diff[m, j] is a warp-shuffle and shared-memory reduction.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 8;  // queries per block
constexpr int kWarps = kThreads / 32;

__global__ void mahalanobis_kernel(const float* __restrict__ q, const float* __restrict__ mu,
                                   const float* __restrict__ sinv, float* __restrict__ out,
                                   int M, int C, int F) {
  const int t = blockIdx.z, c = blockIdx.y, m0 = blockIdx.x * kRowsPerBlock;
  extern __shared__ float diff_s[];  // [kRowsPerBlock][F]
  __shared__ float red[kRowsPerBlock][kWarps];
  const float* qt = q + (size_t)t * M * F;
  const float* mut = mu + ((size_t)t * C + c) * F;
  const float* S = sinv + ((size_t)t * C + c) * F * F;
  for (int idx = threadIdx.x; idx < kRowsPerBlock * F; idx += kThreads) {
    const int r = idx / F, i = idx % F, m = m0 + r;
    diff_s[idx] = (m < M) ? qt[(size_t)m * F + i] - mut[i] : 0.f;
  }
  __syncthreads();
  float part[kRowsPerBlock];
#pragma unroll
  for (int r = 0; r < kRowsPerBlock; ++r) part[r] = 0.f;
  for (int j = threadIdx.x; j < F; j += kThreads) {
    float tj[kRowsPerBlock];
#pragma unroll
    for (int r = 0; r < kRowsPerBlock; ++r) tj[r] = 0.f;
#pragma unroll 4
    for (int i = 0; i < F; ++i) {
      const float s = S[(size_t)i * F + j];
#pragma unroll
      for (int r = 0; r < kRowsPerBlock; ++r) tj[r] = fmaf(diff_s[r * F + i], s, tj[r]);
    }
#pragma unroll
    for (int r = 0; r < kRowsPerBlock; ++r) part[r] = fmaf(tj[r], diff_s[r * F + j], part[r]);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRowsPerBlock; ++r) {
    float v = part[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[r][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < kRowsPerBlock) {
    const int r = threadIdx.x, m = m0 + r;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) v += red[r][k];
    if (m < M) out[((size_t)t * M + m) * C + c] = v;
  }
}

}  // namespace

// q: (T, M, F); mu: (T, C, F); sinv: (T, C, F, F); out: (T, M, C).  All fp32,
// contiguous.  Returns the cudaError_t of the launch.
extern "C" int rt_mahalanobis(const void* q, const void* mu, const void* sinv, void* out, int T,
                              int M, int C, int F, void* stream) {
  if (T == 0 || M == 0 || C == 0) return 0;
  const size_t smem = sizeof(float) * kRowsPerBlock * (size_t)F;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(mahalanobis_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock, C, T);
  mahalanobis_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)mu, (const float*)sinv, (float*)out, M, C, F);
  return (int)cudaGetLastError();
}
