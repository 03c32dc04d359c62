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
//   segment sum: 2*T*B*C*F = 0.33 MFLOP over ~0.16 MB (bound 0.05 us by
//     bytes).  Neither resource matters: latency and the launch do.  C is
//     far below any MMA tile and w holds LITE-scaled weights, not only 0/1,
//     so the kernel is an exact fp32 reduction on the CUDA cores, laid out
//     so that no thread waits on a chain of loads: one block of 256 threads
//     per (t, 64 fp32 or 128 16-bit columns of f), 16 row groups of a
//     half-warp each; every thread issues all its x loads of a step at once
//     (16 bytes each, coalesced along f), while the block stages the step's
//     w rows (B x C fp32) in shared memory once.  The row groups' partial
//     sums meet by a shuffle and then in shared memory in a fixed order (no
//     atomics: the same bits every run).  Rows past B are never read, so a
//     ragged B adds nothing, not 0 * junk.
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

// segment sum: one block of 256 threads per (t, column tile of f).  A
// half-warp spans kSegLanes x 16 bytes of a row (64 fp32 or 128 bf16/fp16
// columns); the block's 16 half-warps are row groups, and row group r
// takes rows r, r + 16, ... of B.
constexpr int kSegThreads = 256;
constexpr int kSegLanes = 16;                         // 16-byte vectors a row
constexpr int kSegGroups = kSegThreads / kSegLanes;   // row groups
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kSegClasses = 8;                        // class accumulators a pass
constexpr int kSegRowsPer = 8;                        // rows a thread loads at once
constexpr int kSegChunk = kSegGroups * kSegRowsPer;   // rows staged per step (128)

template <typename T>
struct SegVec {  // 16 bytes of x: kN values
  static constexpr int kN = 16 / sizeof(T);
};

// Load the kN values of x at column f0 of row `row` (f0 < F); `vec` says
// whether a 16-byte load is aligned and stays inside the row.
template <typename T>
__device__ __forceinline__ void seg_load(const T* __restrict__ xr, int f0, int F, bool vec,
                                         float (&v)[SegVec<T>::kN]) {
  constexpr int kN = SegVec<T>::kN;
  if (vec) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(xr + f0));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < kN; ++k) v[k] = to_f32(e[k]);
  } else {
#pragma unroll
    for (int k = 0; k < kN; ++k) v[k] = f0 + k < F ? to_f32(xr[f0 + k]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kSegThreads)
    segment_sum_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       float* __restrict__ out, int B, int F, int C, int vec) {
  constexpr int kN = SegVec<T>::kN;
  constexpr int kCols = kSegLanes * kN;               // columns of the tile
  __shared__ float wsm[kSegChunk][kSegClasses];       // w rows of this step
  __shared__ float part[kSegWarps][kSegClasses][kCols];  // per-warp sums
  const int t = blockIdx.y;
  const int lane = threadIdx.x % kSegLanes, grp = threadIdx.x / kSegLanes;
  const int warp = threadIdx.x / 32;
  const int f0 = blockIdx.x * kCols + lane * kN;
  const T* xt = x + (size_t)t * B * F;
  const float* wt = w + (size_t)t * B * C;
  float* ot = out + (size_t)t * C * F;

  for (int c0 = 0; c0 < C; c0 += kSegClasses) {
    float acc[kSegClasses][kN];
#pragma unroll
    for (int c = 0; c < kSegClasses; ++c)
#pragma unroll
      for (int k = 0; k < kN; ++k) acc[c][k] = 0.f;
    for (int b0 = 0; b0 < B; b0 += kSegChunk) {
      // every load of the step is issued before the first use: x rows into
      // registers, w rows into shared memory; rows past B are not read
      float xv[kSegRowsPer][kN];
#pragma unroll
      for (int r = 0; r < kSegRowsPer; ++r) {
        const int b = b0 + grp + kSegGroups * r;
        if (b < B && f0 < F) {
          seg_load<T>(xt + (size_t)b * F, f0, F, vec != 0, xv[r]);
        } else {
#pragma unroll
          for (int k = 0; k < kN; ++k) xv[r][k] = 0.f;
        }
      }
      __syncthreads();  // the last step is done with wsm
      for (int i = threadIdx.x; i < kSegChunk * kSegClasses; i += kSegThreads) {
        const int r = i / kSegClasses, c = i % kSegClasses;
        const int b = b0 + r;
        wsm[r][c] = (b < B && c0 + c < C) ? wt[(size_t)b * C + c0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kSegRowsPer; ++r) {
        const int rl = grp + kSegGroups * r;
        if (b0 + rl < B) {  // a row past B adds nothing
#pragma unroll
          for (int c = 0; c < kSegClasses; ++c) {
            const float wv = wsm[rl][c];
#pragma unroll
            for (int k = 0; k < kN; ++k) acc[c][k] = fmaf(wv, xv[r][k], acc[c][k]);
          }
        }
      }
    }
    // the two row groups of a warp, then the warps in order: a fixed order
    // of additions, no atomics, so every run gives the same bits
#pragma unroll
    for (int c = 0; c < kSegClasses; ++c)
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        const float v = acc[c][k] + __shfl_xor_sync(0xffffffffu, acc[c][k], 16);
        if ((threadIdx.x & 31) < kSegLanes) part[warp][c][lane * kN + k] = v;
      }
    __syncthreads();
    for (int i = threadIdx.x; i < kSegClasses * kCols; i += kSegThreads) {
      const int c = i / kCols, col = i % kCols;
      const int f = blockIdx.x * kCols + col;
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < kSegWarps; ++wi) s += part[wi][c][col];
      if (c0 + c < C && f < F) ot[(size_t)(c0 + c) * F + f] = s;
    }
    __syncthreads();  // part is reused by the next class pass
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
  constexpr int kN = SegVec<T>::kN, kCols = kSegLanes * kN;
  const int vec = ((uintptr_t)x % 16 == 0) && (F % kN == 0);
  dim3 grid((F + kCols - 1) / kCols, T_);
  segment_sum_kernel<T><<<grid, kSegThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)w, (float*)out, B, F, C, vec);
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
