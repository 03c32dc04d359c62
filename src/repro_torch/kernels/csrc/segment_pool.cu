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
//   second moment: 2*T*C*B*F^2 = 84 MFLOP and a 5.2 MB fp32 output
//     (1.25 us at 67 TFLOP/s, 1.57 us at 3.35 TB/s), so the kernel has to
//     be good at both.  The output is symmetric: one block per (t, c,
//     output tile on or above the diagonal); an off-diagonal tile is
//     written twice, as itself and mirrored, which saves nearly half the
//     FLOPs and none of the bytes.  The tile is 32 x 32 and each of a
//     block's 64 threads holds a 4 x 4 register tile read as float4 from
//     shared memory: 4 * 5 * 36 = 720 blocks at F = 256, about 3 warps to
//     a scheduler to hide each other's waits.  (Measured against 64 x 64
//     tiles of 8 x 8 a thread, 200 blocks with one warp to a scheduler,
//     which left 2048 FMAs a warp with nothing to hide its stalls: 7.9 us
//     against 5.2 us on an H100.)  Steps of 16 rows of B are staged in shared memory,
//     the weighted left operand w[b,c]*x[b,i] (the class weight folded in
//     as segment_pool.py:105-109 does) and x[b,j], converted to fp32; two
//     stages, the next step's global loads issued into registers before
//     the current step's math and stored after it (cp.async cannot convert
//     bf16 or scale by w on the way).  Rows past B are zeros in shared
//     memory, never read from x; stores are float4, coalesced along j (the
//     mirror along i), masked at a ragged F.  The per-example (B, F, F)
//     outer product is never formed.
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

// Columns [col, col + 4) of `row` as fp32, zero past F; `vec`: one load
// (F % 4 == 0 and a base aligned to 4 elements, so col % 4 == 0 suffices).
template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ row, int col, int F, bool vec,
                                      float (&v)[4]) {
  if (vec && col < F) {
    if constexpr (sizeof(T) == 4) {
      const float4 r = __ldg(reinterpret_cast<const float4*>(row + col));
      v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
    } else {
      const uint2 r = __ldg(reinterpret_cast<const uint2*>(row + col));
      const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = to_f32(e[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = col + k < F ? to_f32(row[col + k]) : 0.f;
  }
}

// Store v[0..3] at columns [col, col + 4) of `row`, masked past F.
__device__ __forceinline__ void store4(float* __restrict__ row, int col, int F,
                                       float v0, float v1, float v2, float v3) {
  if ((F & 3) == 0 && col + 4 <= F) {
    *reinterpret_cast<float4*>(row + col) = make_float4(v0, v1, v2, v3);
  } else {
    const float v[4] = {v0, v1, v2, v3};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (col + k < F) row[col + k] = v[k];
  }
}

// The second moment: 32 x 32 output tiles, each of a block's 64 threads a
// 4 x 4 register tile (rows ty*4 + 0..3, columns tx*4 + 0..3), 16 rows of
// B a stage.
constexpr int kSmEdge = 32;
constexpr int kSmStep = 16;
constexpr int kSmSide = kSmEdge / 4;                       // threads along i and along j
constexpr int kSmThreads = kSmSide * kSmSide;
constexpr int kSmGroups = kSmEdge / 4;                     // 4-column groups a staged row
constexpr int kSmLoads = kSmStep * kSmGroups / kSmThreads;  // groups a thread stages
static_assert(kSmLoads * kSmThreads == kSmStep * kSmGroups, "second-moment staging");

// Grid (nt * (nt + 1) / 2 tile pairs, C, T), nt = ceil(F / 32).
template <typename T>
__global__ void __launch_bounds__(kSmThreads)
    second_moment_kernel(const T* __restrict__ x, const float* __restrict__ w,
                         float* __restrict__ out, int B, int F, int C, int vec) {
  const int t = blockIdx.z, c = blockIdx.y;
  const int nt = (F + kSmEdge - 1) / kSmEdge;
  int p = blockIdx.x, ti = 0;  // the pair's place in the upper triangle, row by row
  while (p >= nt - ti) {
    p -= nt - ti;
    ++ti;
  }
  const int tj = ti + p;
  const int i0 = ti * kSmEdge, j0 = tj * kSmEdge;
  const int tx = threadIdx.x % kSmSide, ty = threadIdx.x / kSmSide;
  __shared__ __align__(16) float As[2][kSmStep][kSmEdge];  // w[b, c] * x[b, i0 + .]
  __shared__ __align__(16) float Bs[2][kSmStep][kSmEdge];  // x[b, j0 + .]
  const T* xt = x + (size_t)t * B * F;
  const float* wt = w + (size_t)t * B * C + c;

  float lv[kSmLoads][4], rv[kSmLoads][4];
  auto fetch = [&](int b0) {  // the step's loads into registers, zero past B
#pragma unroll
    for (int n = 0; n < kSmLoads; ++n) {
      const int g = threadIdx.x + kSmThreads * n;
      const int b = b0 + g / kSmGroups, col = (g % kSmGroups) * 4;
      if (b < B) {
        const T* row = xt + (size_t)b * F;
        const float wv = wt[(size_t)b * C];
        load4<T>(row, i0 + col, F, vec != 0, lv[n]);
        load4<T>(row, j0 + col, F, vec != 0, rv[n]);
#pragma unroll
        for (int k = 0; k < 4; ++k) lv[n][k] *= wv;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) lv[n][k] = rv[n][k] = 0.f;
      }
    }
  };
  auto stash = [&](int s) {
#pragma unroll
    for (int n = 0; n < kSmLoads; ++n) {
      const int g = threadIdx.x + kSmThreads * n;
      const int r = g / kSmGroups, col = (g % kSmGroups) * 4;
      *reinterpret_cast<float4*>(&As[s][r][col]) =
          make_float4(lv[n][0], lv[n][1], lv[n][2], lv[n][3]);
      *reinterpret_cast<float4*>(&Bs[s][r][col]) =
          make_float4(rv[n][0], rv[n][1], rv[n][2], rv[n][3]);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  const int nsteps = (B + kSmStep - 1) / kSmStep;
  if (nsteps > 0) {
    fetch(0);
    stash(0);
  }
  __syncthreads();
  for (int st = 0; st < nsteps; ++st) {
    const int s = st & 1;
    if (st + 1 < nsteps) fetch((st + 1) * kSmStep);  // in flight under the math
#pragma unroll
    for (int kk = 0; kk < kSmStep; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[s][kk][ty * 4]);
      const float4 bq = *reinterpret_cast<const float4*>(&Bs[s][kk][tx * 4]);
      const float a[4] = {av.x, av.y, av.z, av.w}, bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(a[r], bv[q], acc[r][q]);
    }
    if (st + 1 < nsteps) stash(s ^ 1);  // that stage was last read a step ago
    __syncthreads();
  }

  float* ot = out + ((size_t)t * C + c) * F * F;
  // the tile itself: rows i0 + ty*4 + r, a float4 along j each
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i < F)
      store4(ot + (size_t)i * F, j0 + tx * 4, F, acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  if (ti == tj) return;
  // its mirror below the diagonal: rows j0 + tx*4 + q, a float4 along i each
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = j0 + tx * 4 + q;
    if (j < F)
      store4(ot + (size_t)j * F, i0 + ty * 4, F, acc[0][q], acc[1][q], acc[2][q], acc[3][q]);
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
  const int nt = (F + kSmEdge - 1) / kSmEdge;
  const int vec = ((uintptr_t)x % (4 * sizeof(T)) == 0) && (F % 4 == 0);
  dim3 grid(nt * (nt + 1) / 2, C, T_);
  second_moment_kernel<T><<<grid, kSmThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)w, (float*)out, B, F, C, vec);
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
