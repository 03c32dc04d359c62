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
// operations at the bf16 tensor-core rate (0.122 ms at 989 TFLOP/s).
//
// Two routes, chosen by the caller (kernels/gmm.py: gmm_route) from dtype
// and layout before the launch, never after a failure:
//
// "wgmma" (bf16 / fp16, 16-byte-aligned base and rows): a batched GEMM on
// the tensor cores, M = C, N = F, K = D.  One block per 128 x 256 output
// tile of one expert (grid F/256 x C/128 x E).  One producer warp issues TMA
// loads of 64-deep K slabs, x's 128 x 64 tile and w's 64 x 256 tile (48 KB a
// stage), into a ring of 4 stages with a "full" and an "empty" mbarrier
// each, so the loads of later slabs run under the math of this one.  Both
// tensor maps are 3-D, (D, C, E) and (F, D, E), so the ragged edges of C, D
// and F are zero filled by the TMA box and never read from the next expert.
// Two consumer warpgroups, 64 rows each, issue wgmma m64n256k16: A = the x
// tile (K-major), B = the w tile read N-major through the transposed-B
// descriptor (w is (D, F) with F contiguous, so no copy transposes it); the
// 64 x 256 fp32 accumulator (128 registers a thread) stays in registers,
// one wgmma group in flight while the next slab is awaited.  The epilogue
// rounds to x's dtype and stores with the C and F edges masked.  The bf16
// products are exact in fp32, so only the order of the fp32 sum differs
// from the plain version's.
//
// "simt" (fp32, or a layout TMA cannot take): the first kernel, unchanged.
// One block owns a 128 x 128 output tile of one expert and walks all of D
// itself, so no sum crosses blocks and no atomics are needed.  256 threads,
// each 8 x 8 outputs in registers (rows ty + 16*i, columns tx + 16*j, so
// the shared-memory reads are broadcast or consecutive).  16-deep slabs of x
// (stored transposed) and w are converted to fp32 as they are staged in
// shared memory.  Ragged C, D and F are zero filled on load and masked on
// store, so no padded copy is made.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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


// ---- the "wgmma" route --------------------------------------------------

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

namespace tc {
constexpr int kBM = 128, kBN = 256, kBK = 64;  // output tile, K slab
constexpr int kStages = 4;
constexpr int kConsumers = 256;                // two warpgroups
constexpr int kThreads = kConsumers + 32;      // and one producer warp
constexpr int kTileA = kBM * kBK * 2;          // 16 KB: one 128-row atom
constexpr int kAtomB = kBK * 128;              // 8 KB: 64 rows of 128 bytes
constexpr int kTileB = (kBN / 64) * kAtomB;    // 32 KB: four atoms along F
constexpr int kStage = kTileA + kTileB;
constexpr size_t kSmem = (size_t)kStages * kStage + 2 * kStages * sizeof(uint64_t) + 1024;
}  // namespace tc

template <typename T, bool F16>
__global__ void __launch_bounds__(tc::kThreads, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, T* __restrict__ out, int C, int D,
                     int F) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + tc::kStages * tc::kStage);
  uint64_t* empty = full + tc::kStages;
  const int e = blockIdx.z, m0 = blockIdx.y * tc::kBM, n0 = blockIdx.x * tc::kBN;
  const int nk = (D + tc::kBK - 1) / tc::kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < tc::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], tc::kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == tc::kConsumers / 32) {  // producer: one thread issues every load
    if (lane == 0) {
      for (int k = 0; k < nk; ++k) {
        const int s = k % tc::kStages;
        hopper::mbar_wait(&empty[s], ((k / tc::kStages) & 1) ^ 1);
        uint8_t* a = smem + s * tc::kStage;
        hopper::mbar_expect_tx(&full[s], tc::kStage);
        hopper::tma_load_3d(a, &xmap, &full[s], k * tc::kBK, m0, e);
#pragma unroll
        for (int j = 0; j < tc::kBN / 64; ++j)
          hopper::tma_load_3d(a + tc::kTileA + j * tc::kAtomB, &wmap, &full[s], n0 + 64 * j,
                              k * tc::kBK, e);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 of the tile
  const int wg = warp / 4;
  float acc[tc::kBN / 2];
#pragma unroll
  for (int i = 0; i < tc::kBN / 2; ++i) acc[i] = 0.f;
  const uint32_t base = hopper::smem_u32(smem);
  for (int k = 0; k < nk; ++k) {
    const int s = k % tc::kStages;
    hopper::mbar_wait(&full[s], (k / tc::kStages) & 1);
    const uint32_t a = base + s * tc::kStage + wg * (64 * 128);
    const uint32_t b = base + s * tc::kStage + tc::kTileA;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < tc::kBK / 16; ++kk)
      hopper::wgmma_ss<tc::kBN, F16, 1>(acc, hopper::smem_desc(a + kk * 32, 16, 1024),
                                        hopper::smem_desc(b + kk * 2048, tc::kAtomB, 1024), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // the previous slab's group is done with its stage
    hopper::fence_regs(acc);
    if (k > 0) hopper::mbar_arrive(&empty[(k - 1) % tc::kStages]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  const int row0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  T* oe = out + (size_t)e * C * F;
#pragma unroll
  for (int j = 0; j < tc::kBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);  // F is a multiple of 8
    if (col >= F) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row < C) store2(oe + (size_t)row * F + col, acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

template <typename T, bool F16>
int launch_wgmma(const void* x, const void* w, void* out, int E, int C, int D, int F,
                 cudaStream_t stream) {
  if (D % 8 != 0 || F % 8 != 0) return (int)cudaErrorInvalidValue;  // TMA: 16-byte rows
  CUtensorMap xmap, wmap;
  const uint64_t xdims[3] = {(uint64_t)D, (uint64_t)C, (uint64_t)E};
  const uint64_t xstrides[2] = {(uint64_t)D * 2, (uint64_t)C * D * 2};
  const uint32_t xbox[3] = {64, tc::kBM, 1};
  const uint64_t wdims[3] = {(uint64_t)F, (uint64_t)D, (uint64_t)E};
  const uint64_t wstrides[2] = {(uint64_t)F * 2, (uint64_t)D * F * 2};
  const uint32_t wbox[3] = {64, tc::kBK, 1};
  cudaError_t err = hopper::make_tensor_map(&xmap, F16, 3, x, xdims, xstrides, xbox);
  if (err == cudaSuccess) err = hopper::make_tensor_map(&wmap, F16, 3, w, wdims, wstrides, wbox);
  auto kern = gmm_wgmma_kernel<T, F16>;
  if (err == cudaSuccess) err = hopper::allow_smem(kern, tc::kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((F + tc::kBN - 1) / tc::kBN, (C + tc::kBM - 1) / tc::kBM, E);
  kern<<<grid, tc::kThreads, tc::kSmem, stream>>>(xmap, wmap, (T*)out, C, D, F);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (E, C, D); w: (E, D, F); out: (E, C, F); one dtype (0 fp32, 1 bf16,
// 2 fp16), contiguous.  route 0 = "simt", 1 = "wgmma" (bf16 / fp16, D and
// F multiples of 8, 16-byte-aligned bases).  Returns the cudaError_t of the
// launch.
extern "C" int rt_gmm(const void* x, const void* w, void* out, int dtype, int E, int C, int D,
                      int F, int route, void* stream) {
  if (E == 0 || C == 0 || F == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 1) {
    if (D == 0) return (int)cudaErrorInvalidValue;
    switch (dtype) {
      case 1:
        return launch_wgmma<__nv_bfloat16, false>(x, w, out, E, C, D, F, st);
      case 2:
        return launch_wgmma<__half, true>(x, w, out, E, C, D, F, st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
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
