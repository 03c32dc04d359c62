// Grouped (per-expert) matmul for the MoE layer, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/gmm.py: gmm (def :37,
// pl.pallas_call :47)
//     out[e] = x[e] @ w[e]      x (E, C, D), w (E, D, F) -> (E, C, F)
// with fp32 accumulation over D and the output in x's dtype (fp32, bf16 or
// fp16; x and w share it).
//
// What bounds it, at the kimi-k2 expert shape (E = 8, C = 512 tokens an
// expert, D = 7168, F = 2048, bf16): 2*E*C*D*F = 120 GFLOP over 0.31 GB
// (the weights are 235 MB of it), so about 390 FLOPs a byte: bound by
// operations at the bf16 tensor-core rate.  This first kernel computes in
// fp32 on the CUDA cores, so it is far from that bound.
//
// Design.  The TPU kernel carries the D-axis sum in VMEM scratch across its
// last (sequential) grid axis; here one block owns a 128 x 128 output tile
// of one expert and walks all of D itself, so no sum crosses blocks and no
// atomics are needed.  256 threads, each 8 x 8 outputs in registers (rows
// ty + 16*i, columns tx + 16*j, so the shared-memory reads are broadcast or
// consecutive).  16-deep slabs of x (stored transposed) and w are converted
// to fp32 as they are staged in shared memory.  Ragged C, D and F are zero
// filled on load and masked on store, so no padded copy is made.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half(v); }

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128, kBK = 16;  // output tile and D slab
constexpr int kGroups = 16;                    // 16 x 16 threads
constexpr int kTM = kBM / kGroups, kTN = kBN / kGroups;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gmm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int C,
               int D, int F) {
  __shared__ float xs[kBK][kBM + 1];  // x slab, transposed: xs[k][m]
  __shared__ float ws[kBK][kBN];
  const int e = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const T* xe = x + (size_t)e * C * D;
  const T* we = w + (size_t)e * D * F;
  T* oe = out + (size_t)e * C * F;
  const int tid = threadIdx.x, tx = tid % kGroups, ty = tid / kGroups;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kBK) {
#pragma unroll
    for (int it = 0; it < kBM * kBK / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int m = idx / kBK, kk = idx % kBK;
      const int gm = m0 + m, gk = k0 + kk;
      xs[kk][m] = (gm < C && gk < D) ? to_f32(xe[(size_t)gm * D + gk]) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < kBK * kBN / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int kk = idx / kBN, n = idx % kBN;
      const int gk = k0 + kk, gn = n0 + n;
      ws[kk][n] = (gk < D && gn < F) ? to_f32(we[(size_t)gk * F + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[kk][ty + kGroups * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ws[kk][tx + kGroups * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty + kGroups * i;
    if (gm >= C) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx + kGroups * j;
      if (gn < F) store(oe + (size_t)gm * F + gn, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int E, int C, int D, int F,
           cudaStream_t stream) {
  dim3 grid((F + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  gmm_kernel<T><<<grid, kThreads, 0, stream>>>((const T*)x, (const T*)w, (T*)out, C, D, F);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (E, C, D); w: (E, D, F); out: (E, C, F); one dtype (0 fp32, 1 bf16,
// 2 fp16), contiguous.  Returns the cudaError_t of the launch.
extern "C" int rt_gmm(const void* x, const void* w, void* out, int dtype, int E, int C, int D,
                      int F, void* stream) {
  if (E == 0 || C == 0 || F == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(x, w, out, E, C, D, F, st);
    case 1:
      return launch<__nv_bfloat16>(x, w, out, E, C, D, F, st);
    case 2:
      return launch<__half>(x, w, out, E, C, D, F, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
