// Per-class aggregation kernels of the episodic adaptation path, for sm_90a.
//
// Replaces the TPU kernels in src/repro/kernels/segment_pool.py:
//   segment_pool_weighted (def :55, pl.pallas_call :64)
//       out[t, c, f] = sum_b w[t, b, c] * x[t, b, f]
//   class_second_moment   (def :112, pl.pallas_call :121)
//       out[t, c, i, j] = sum_b w[t, b, c] * x[t, b, i] * x[t, b, j]
// with a leading task-lane axis t (the JAX engine vmaps the Pallas kernels
// over it; here it is a grid axis).  w is a mask-folded one-hot: padded rows
// carry zero weight.  x is fp32, bf16 or fp16 (the LITE compute_dtype path);
// all accumulate in fp32.
//
// What bounds them on the H100, at the serving shapes (T=4 lanes, B=32 rows
// per chunk, C=5 ways, F=256 features):
//   segment sum: 2*T*B*C*F = 0.33 MFLOP over ~0.16 MB.  Neither resource
//     matters; the launch does.  C is far below any MMA tile, so the kernel
//     is a plain fp32 reduction: one thread per (t, f) column holds the C
//     accumulators of its column in registers and walks the B rows in
//     order.  Loads of x are coalesced along f; the w row is a broadcast.
//     Rows past B are never read, so a ragged B adds nothing, not 0 * junk.
//   second moment: 2*T*C*B*F^2 = 84 MFLOP and a 5.2 MB fp32 output, so
//     the write of the (T, C, F, F) output and the fp32 FMAs bound it about
//     equally.  One block per (t*c, 32x32 output tile) stages 32-row slabs
//     of the weighted left operand w[b,c]*x[b,i] and of x[b,j] in shared
//     memory (as segment_pool.py:105-109 folds the class weight into the
//     left operand) and accumulates 4 outputs per thread.  The per-example
//     (B, F, F) outer product is never formed.  Ragged B and F are zero
//     filled in shared memory and masked on the store.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

constexpr int kSegThreads = 128;  // columns f per block
constexpr int kSegClasses = 8;    // class accumulators held per pass

template <typename T>
__global__ void segment_sum_kernel(const T* __restrict__ x, const float* __restrict__ w,
                                   float* __restrict__ out, int B, int F, int C) {
  const int t = blockIdx.y;
  const int f = blockIdx.x * kSegThreads + threadIdx.x;
  if (f >= F) return;
  const T* xt = x + (size_t)t * B * F;
  const float* wt = w + (size_t)t * B * C;
  float* ot = out + (size_t)t * C * F;
  for (int c0 = 0; c0 < C; c0 += kSegClasses) {
    float acc[kSegClasses];
#pragma unroll
    for (int k = 0; k < kSegClasses; ++k) acc[k] = 0.f;
    for (int b = 0; b < B; ++b) {
      const float xv = to_f32(xt[(size_t)b * F + f]);
      const float* wb = wt + (size_t)b * C + c0;
#pragma unroll
      for (int k = 0; k < kSegClasses; ++k)
        if (c0 + k < C) acc[k] = fmaf(wb[k], xv, acc[k]);
    }
#pragma unroll
    for (int k = 0; k < kSegClasses; ++k)
      if (c0 + k < C) ot[(size_t)(c0 + k) * F + f] = acc[k];
  }
}

constexpr int kTile = 32;  // output tile edge (i and j)
constexpr int kRows = 32;  // rows of B staged per step
constexpr int kTy = 8;     // threads along i; each owns kTile / kTy rows

template <typename T>
__global__ void second_moment_kernel(const T* __restrict__ x, const float* __restrict__ w,
                                     float* __restrict__ out, int B, int F, int C) {
  const int tc = blockIdx.z;
  const int t = tc / C, c = tc % C;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const T* xt = x + (size_t)t * B * F;
  const float* wt = w + (size_t)t * B * C;
  __shared__ float xi_s[kRows][kTile];  // w[b, c] * x[b, i0 + .]
  __shared__ float xj_s[kRows][kTile];  // x[b, j0 + .]
  float acc[kTile / kTy];
#pragma unroll
  for (int r = 0; r < kTile / kTy; ++r) acc[r] = 0.f;
  for (int b0 = 0; b0 < B; b0 += kRows) {
#pragma unroll
    for (int k = 0; k < kRows / kTy; ++k) {
      const int bl = ty + kTy * k, b = b0 + bl;
      float vi = 0.f, vj = 0.f;
      if (b < B) {
        const float wv = wt[(size_t)b * C + c];
        if (i0 + tx < F) vi = wv * to_f32(xt[(size_t)b * F + i0 + tx]);
        if (j0 + tx < F) vj = to_f32(xt[(size_t)b * F + j0 + tx]);
      }
      xi_s[bl][tx] = vi;
      xj_s[bl][tx] = vj;
    }
    __syncthreads();
#pragma unroll 8
    for (int bl = 0; bl < kRows; ++bl) {
      const float vj = xj_s[bl][tx];
#pragma unroll
      for (int r = 0; r < kTile / kTy; ++r) acc[r] = fmaf(xi_s[bl][ty + kTy * r], vj, acc[r]);
    }
    __syncthreads();
  }
  const int j = j0 + tx;
#pragma unroll
  for (int r = 0; r < kTile / kTy; ++r) {
    const int i = i0 + ty + kTy * r;
    if (i < F && j < F) out[((size_t)tc * F + i) * F + j] = acc[r];
  }
}

template <typename T>
int launch_segment_sum(const void* x, const void* w, void* out, int T_, int B, int F, int C,
                       void* stream) {
  if (T_ == 0 || F == 0 || C == 0) return 0;
  dim3 grid((F + kSegThreads - 1) / kSegThreads, T_);
  segment_sum_kernel<T><<<grid, kSegThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)w, (float*)out, B, F, C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_second_moment(const void* x, const void* w, void* out, int T_, int B, int F, int C,
                         void* stream) {
  if (T_ == 0 || F == 0 || C == 0) return 0;
  const int tiles = (F + kTile - 1) / kTile;
  dim3 grid(tiles, tiles, T_ * C);
  dim3 block(kTile, kTy);
  second_moment_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)w, (float*)out, B, F, C);
  return (int)cudaGetLastError();
}

}  // namespace

// x_dtype: 0 = fp32, 1 = bf16, 2 = fp16.
// x: (T, B, F); w: (T, B, C) fp32; out: (T, C, F) fp32.  All contiguous.
// Returns the cudaError_t of the launch.
extern "C" int rt_segment_sum(const void* x, int x_dtype, const void* w, void* out, int T, int B,
                              int F, int C, void* stream) {
  if (x_dtype == 1) return launch_segment_sum<__nv_bfloat16>(x, w, out, T, B, F, C, stream);
  if (x_dtype == 2) return launch_segment_sum<__half>(x, w, out, T, B, F, C, stream);
  return launch_segment_sum<float>(x, w, out, T, B, F, C, stream);
}

// x: (T, B, F) of x_dtype; w: (T, B, C) fp32; out: (T, C, F, F) fp32.
extern "C" int rt_class_second_moment(const void* x, int x_dtype, const void* w, void* out, int T,
                                      int B, int F, int C, void* stream) {
  if (x_dtype == 1) return launch_second_moment<__nv_bfloat16>(x, w, out, T, B, F, C, stream);
  if (x_dtype == 2) return launch_second_moment<__half>(x, w, out, T, B, F, C, stream);
  return launch_second_moment<float>(x, w, out, T, B, F, C, stream);
}
