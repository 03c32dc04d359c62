// Grouped (per-expert) matmul for the MoE layer, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/gmm.py: gmm (def :37,
// pl.pallas_call :47)
//     out[e] = x[e] @ w[e]      x (E, C, D), w (E, D, F) -> (E, C, F)
// with fp32 accumulation over D and the output in x's dtype (fp32, bf16 or
// fp16; x and w share it).  x and w each come stored as given or as the
// transpose of their last two axes, so the backward's dx = g w^T and dw =
// x^T g read the stored w and x in place (kernels/dispatch.py: _GMM).
//
// What bounds it, at the kimi-k2 expert shape (E = 8, C = 512 tokens an
// expert, D = 7168, F = 2048, bf16): 2*E*C*D*F = 120 GFLOP over 0.31 GB
// (the weights are 235 MB of it), so about 390 FLOPs a byte: bound by
// operations at the bf16 tensor-core rate (0.122 ms at 989 TFLOP/s).  At
// deepseek-v2's training shapes (E 160, C 200, D 5120, F 1536) each of the
// forward, dx and dw moves 2.94 GB (0.88 ms at 3.35 TB/s) for 0.50 TFLOP
// (0.51 ms): bound by bytes, and dw's by its 2.52 GB output alone.
//
// Two routes, chosen by the caller (kernels/gmm.py: gmm_route) from dtype
// and layout before the launch, never after a failure:
//
// "wgmma" (bf16 / fp16, 16-byte-aligned bases and stored rows): a batched
// GEMM on the tensor cores, M = C, N = F, K = D.  Where C spans more than
// one 128-row tile, it is persistent: one block per SM walks the 128 x 256
// output tiles of each expert in turn, along the shorter of C and F first,
// so that the blocks reading one tile of the larger operand run side by side
// and its second read comes from L2 (dx = g w^T at deepseek-v2, C 200 and F
// 5120, reads each w tile twice, once a 128-row tile of C; dw, C 5120 > F
// 1536, walks F first).  With C <= 128 (serving's expert projections) each
// w tile streams once and a block takes one tile (launch_wgmma).
// One producer warp issues TMA loads of 64-deep K slabs, 16 KB of x and
// 32 KB of w a stage, into a ring of 4 stages with a "full" and an "empty"
// mbarrier each; its slab count runs on across tiles, so the next tile's
// loads run under this tile's math and stores.  The tensor maps are 3-D over
// the stored layout, so the ragged edges of C, D and F are zero filled by
// the TMA box and never read from the next expert.  x stored (E, C, D) is
// K-major: one 128-row box; stored (E, D, C) (x^T) it is M-major: two 64 x
// 64 atoms read through the transposed-A descriptor.  w stored (E, D, F) is
// N-major: four 64 x 64 atoms read through the transposed-B descriptor;
// stored (E, F, D) (w^T) it is K-major: one 256-row box.  No operand is ever
// copied to change its layout.  Two consumer warpgroups, 64 rows each,
// issue wgmma m64n256k16; the 64 x 256 fp32 accumulator (128 registers a
// thread) stays in registers, one wgmma group in flight while the next slab
// is awaited.  The epilogue rounds to x's dtype and writes each
// warpgroup's rows in two 64 x 128 halves into 128-byte-swizzled shared
// memory (the layout of a TMA load, so the writes are free of bank
// conflicts), from which TMA stores whole lines; the store drops what lies
// past C or F.  The bf16 products are exact in fp32, so only the order of
// the fp32 sum (64-deep slabs, as before) differs from the plain version's.
//
// "simt" (fp32, or a layout TMA cannot take): the first kernel, reading
// either stored layout by its strides.  One block owns a 128 x 128 output
// tile of one expert and walks all of D itself, so no sum crosses blocks and
// no atomics are needed.  256 threads, each 8 x 8 outputs in registers (rows
// ty + 16*i, columns tx + 16*j, so the shared-memory reads are broadcast or
// consecutive).  16-deep slabs of x (stored transposed) and w are converted
// to fp32 as they are staged in shared memory.  Ragged C, D and F are zero
// filled on load and masked on store, so no padded copy is made.
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
               int D, int F, int x_t, int w_t) {
  __shared__ float xs[kBK][kBM + 1];  // x slab, transposed: xs[k][m]
  __shared__ float ws[kBK][kBN];
  const int e = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const T* xe = x + (size_t)e * C * D;
  const T* we = w + (size_t)e * D * F;
  T* oe = out + (size_t)e * C * F;
  const int tid = threadIdx.x, tx = tid % kGroups, ty = tid / kGroups;
  // element strides of x (c, d) and w (d, f): stored as given, or transposed
  const size_t x_sc = x_t ? 1 : D, x_sd = x_t ? C : 1;
  const size_t w_sd = w_t ? 1 : F, w_sf = w_t ? D : 1;

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
      xs[kk][m] = (gm < C && gk < D) ? to_f32(xe[gm * x_sc + gk * x_sd]) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < kBK * kBN / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int kk = idx / kBN, n = idx % kBN;
      const int gk = k0 + kk, gn = n0 + n;
      ws[kk][n] = (gk < D && gn < F) ? to_f32(we[gk * w_sd + gn * w_sf]) : 0.f;
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
int launch(const void* x, const void* w, void* out, int E, int C, int D, int F, int x_t,
           int w_t, cudaStream_t stream) {
  dim3 grid((F + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  gmm_kernel<T><<<grid, kThreads, 0, stream>>>((const T*)x, (const T*)w, (T*)out, C, D, F, x_t,
                                               w_t);
  return (int)cudaGetLastError();
}


// ---- the "wgmma" route --------------------------------------------------

__device__ __forceinline__ uint32_t pack2(float a, float b, __nv_bfloat16*) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(float a, float b, __half*) {
  __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

namespace tc {
constexpr int kBM = 128, kBN = 256, kBK = 64;  // output tile, K slab
constexpr int kStages = 4;
constexpr int kConsumers = 256;                // two warpgroups
constexpr int kThreads = kConsumers + 32;      // and one producer warp
constexpr int kAtom = 64 * 128;                // 8 KB: 64 rows of 128 bytes
constexpr int kTileA = kBM * kBK * 2;          // 16 KB: two atoms (64 rows each)
constexpr int kTileB = kBN * kBK * 2;          // 32 KB
constexpr int kStage = kTileA + kTileB;
constexpr int kOutHalf = 2 * kAtom;            // a warpgroup's 64 x 128 half of its rows
constexpr size_t kSmem =
    (size_t)kStages * kStage + 2 * kOutHalf + 2 * kStages * sizeof(uint64_t) + 1024;
}  // namespace tc

// AM: x is stored (E, D, C), M-major (the x^T of dw = x^T g); else (E, C, D).
// BK: w is stored (E, F, D), K-major (the w^T of dx = g w^T); else (E, D, F).
template <typename T, bool F16, bool AM, bool BK>
__global__ void __launch_bounds__(tc::kThreads, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap omap, int E, int C, int D, int F,
                     int m_fast) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* sout = smem + tc::kStages * tc::kStage;  // warpgroup wg's half at wg * kOutHalf
  uint64_t* full = reinterpret_cast<uint64_t*>(sout + 2 * tc::kOutHalf);
  uint64_t* empty = full + tc::kStages;
  const int tiles_n = (F + tc::kBN - 1) / tc::kBN, tiles_m = (C + tc::kBM - 1) / tc::kBM;
  const int tiles = E * tiles_m * tiles_n;
  // tile t of an expert: C fastest (m_fast), so that the tiles reading one
  // w tile run side by side, or F fastest, the tiles reading one x tile
  auto tile_m = [&](int t) { return m_fast ? t % tiles_m : t / tiles_n % tiles_m; };
  auto tile_n = [&](int t) { return m_fast ? t / tiles_m % tiles_n : t % tiles_n; };
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

  // Block b walks tiles b, b + grid, ... (one tile where grid = tiles); the
  // slab counter `it` runs on across tiles, so the producer loads the next
  // tile's slabs while the consumers store this one.
  if (warp == tc::kConsumers / 32) {  // producer: one thread issues every load
    if (lane == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = tile_m(t) * tc::kBM, n0 = tile_n(t) * tc::kBN;
        const int e = t / (tiles_n * tiles_m);
        for (int k = 0; k < nk; ++k, ++it) {
          const int s = it % tc::kStages;
          hopper::mbar_wait(&empty[s], ((it / tc::kStages) & 1) ^ 1);
          uint8_t* a = smem + s * tc::kStage;
          uint8_t* b = a + tc::kTileA;
          hopper::mbar_expect_tx(&full[s], tc::kStage);
          if constexpr (AM) {  // two (64 K rows) x (64 M) atoms
            hopper::tma_load_3d(a, &xmap, &full[s], m0, k * tc::kBK, e);
            hopper::tma_load_3d(a + tc::kAtom, &xmap, &full[s], m0 + 64, k * tc::kBK, e);
          } else {  // one (128 M rows) x (64 K) box
            hopper::tma_load_3d(a, &xmap, &full[s], k * tc::kBK, m0, e);
          }
          if constexpr (BK) {  // one (256 N rows) x (64 K) box
            hopper::tma_load_3d(b, &wmap, &full[s], k * tc::kBK, n0, e);
          } else {  // four (64 K rows) x (64 N) atoms
#pragma unroll
            for (int j = 0; j < tc::kBN / 64; ++j)
              hopper::tma_load_3d(b + j * tc::kAtom, &wmap, &full[s], n0 + 64 * j,
                                  k * tc::kBK, e);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 of each tile
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);  // uniform, as the compiler sees it
  const bool leader = threadIdx.x % 128 == 0;
  const int rl0 = (warp % 4) * 16 + lane / 4;  // this thread's rows rl0, rl0 + 8 of the 64
  const uint32_t base = hopper::smem_u32(smem);
  uint8_t* half_out = sout + wg * tc::kOutHalf;
  float acc[tc::kBN / 2];
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = tile_m(t) * tc::kBM, n0 = tile_n(t) * tc::kBN;
    const int e = t / (tiles_n * tiles_m);
    for (int k = 0; k < nk; ++k, ++it) {
      const int s = it % tc::kStages;
      hopper::mbar_wait(&full[s], (it / tc::kStages) & 1);
      const uint32_t a = base + s * tc::kStage + wg * tc::kAtom;
      const uint32_t b = base + s * tc::kStage + tc::kTileA;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < tc::kBK / 16; ++kk) {
        // A: K-major rows of 128 bytes (slice kk 32 bytes in), or an M-major
        // atom (slice kk 16 rows down); B likewise, K-major or N-major
        const uint64_t da = AM ? hopper::smem_desc(a + kk * 2048, tc::kAtom, 1024)
                               : hopper::smem_desc(a + kk * 32, 16, 1024);
        const uint64_t db = BK ? hopper::smem_desc(b + kk * 32, 16, 1024)
                               : hopper::smem_desc(b + kk * 2048, tc::kAtom, 1024);
        hopper::wgmma_ss<tc::kBN, F16, BK ? 0 : 1, AM ? 1 : 0>(acc, da, db, k > 0 || kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the previous slab's group is done with its stage
      hopper::fence_regs(acc);
      if (k > 0) hopper::mbar_arrive(&empty[(it - 1) % tc::kStages]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&empty[(it - 1) % tc::kStages]);

    // Epilogue: the warpgroup's 64 x 256 rows, rounded to T, go through
    // shared memory in two 64 x 128 halves (two 128-byte-swizzled atoms
    // each, the layout a TMA load gives), each stored by TMA, which drops
    // what lies past C or F.  A half waits until the previous store has
    // read its buffer; the next tile's loads run meanwhile.
    const int row = m0 + wg * 64;
    if (row >= C) continue;  // uniform over the warpgroup
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 128 * h;
      if (col >= F) break;
      if (leader) hopper::bulk_wait_read<0>();
      hopper::named_sync(1 + wg, 128);
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int j = 16 * h + jj;  // columns 8 j .. 8 j + 7 of the tile
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = rl0 + 8 * i;
          uint8_t* p = half_out + (jj / 8) * tc::kAtom + r * 128 + (((jj % 8) ^ (r % 8)) << 4) +
                       4 * (lane % 4);
          *reinterpret_cast<uint32_t*>(p) =
              pack2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1], (T*)nullptr);
        }
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1 + wg, 128);
      if (leader) {
        hopper::tma_store_3d(&omap, half_out, col, row, e);
        if (col + 64 < F) hopper::tma_store_3d(&omap, half_out + tc::kAtom, col + 64, row, e);
        hopper::bulk_commit();
      }
    }
  }
  if (leader) hopper::bulk_wait<0>();
}

inline int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (count[dev] == 0) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

template <typename T, bool F16, bool AM, bool BK>
int launch_wgmma(const void* x, const void* w, void* out, int E, int C, int D, int F,
                 cudaStream_t stream) {
  // TMA: every stored row a multiple of 16 bytes
  if ((AM ? C : D) % 8 != 0 || (BK ? D : F) % 8 != 0 || F % 8 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wmap, omap;
  const uint64_t xdims[3] = {(uint64_t)(AM ? C : D), (uint64_t)(AM ? D : C), (uint64_t)E};
  const uint64_t xstrides[2] = {xdims[0] * 2, (uint64_t)C * D * 2};
  const uint32_t xbox[3] = {64, AM ? (uint32_t)tc::kBK : (uint32_t)tc::kBM, 1};
  const uint64_t wdims[3] = {(uint64_t)(BK ? D : F), (uint64_t)(BK ? F : D), (uint64_t)E};
  const uint64_t wstrides[2] = {wdims[0] * 2, (uint64_t)D * F * 2};
  const uint32_t wbox[3] = {64, BK ? (uint32_t)tc::kBN : (uint32_t)tc::kBK, 1};
  const uint64_t odims[3] = {(uint64_t)F, (uint64_t)C, (uint64_t)E};
  const uint64_t ostrides[2] = {(uint64_t)F * 2, (uint64_t)C * F * 2};
  const uint32_t obox[3] = {64, 64, 1};
  cudaError_t err = hopper::make_tensor_map(&xmap, F16, 3, x, xdims, xstrides, xbox);
  if (err == cudaSuccess) err = hopper::make_tensor_map(&wmap, F16, 3, w, wdims, wstrides, wbox);
  if (err == cudaSuccess) err = hopper::make_tensor_map(&omap, F16, 3, out, odims, ostrides, obox);
  auto kern = gmm_wgmma_kernel<T, F16, AM, BK>;
  if (err == cudaSuccess) err = hopper::allow_smem(kern, tc::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_m = (C + tc::kBM - 1) / tc::kBM;
  const long long tiles = (long long)E * tiles_m * ((F + tc::kBN - 1) / tc::kBN);
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  // Persistent, one block an SM, where C spans more than one tile, so that
  // tiles share w (or x) and the walk order keeps a shared tile's readers
  // side by side; with one row of tiles (C <= 128: serving's expert
  // projections) nothing is shared, every w tile streams once, and a block
  // a tile lets the hardware's scheduler even out the SMs' unequal shares
  // of device-memory bandwidth, which a fixed walk cannot
  const int grid = (int)(tiles_m > 1 && tiles > sms ? sms : tiles);
  // the larger operand's tiles are read by neighbouring blocks at about
  // the same time, so L2 serves its second reader: w's (D x F an expert)
  // when C < F, x's (C x D) otherwise
  kern<<<grid, tc::kThreads, tc::kSmem, stream>>>(xmap, wmap, omap, E, C, D, F, C < F);
  return (int)cudaGetLastError();
}

template <typename T, bool F16>
int launch_wgmma_layout(const void* x, const void* w, void* out, int E, int C, int D, int F,
                        int x_t, int w_t, cudaStream_t stream) {
  if (x_t && w_t) return launch_wgmma<T, F16, true, true>(x, w, out, E, C, D, F, stream);
  if (x_t) return launch_wgmma<T, F16, true, false>(x, w, out, E, C, D, F, stream);
  if (w_t) return launch_wgmma<T, F16, false, true>(x, w, out, E, C, D, F, stream);
  return launch_wgmma<T, F16, false, false>(x, w, out, E, C, D, F, stream);
}

}  // namespace

// x: (E, C, D), stored as such (x_t = 0) or as its transpose (E, D, C)
// (x_t = 1); w: (E, D, F), stored as such (w_t = 0) or as (E, F, D) (w_t =
// 1); out: (E, C, F), contiguous; one dtype (0 fp32, 1 bf16, 2 fp16).
// route 0 = "simt", 1 = "wgmma" (bf16 / fp16; the stored rows of x, w and
// out multiples of 16 bytes; 16-byte-aligned bases).  Returns the
// cudaError_t of the launch.
extern "C" int rt_gmm(const void* x, const void* w, void* out, int dtype, int E, int C, int D,
                      int F, int x_t, int w_t, int route, void* stream) {
  if (E == 0 || C == 0 || F == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 1) {
    if (D == 0) return (int)cudaErrorInvalidValue;
    switch (dtype) {
      case 1:
        return launch_wgmma_layout<__nv_bfloat16, false>(x, w, out, E, C, D, F, x_t, w_t, st);
      case 2:
        return launch_wgmma_layout<__half, true>(x, w, out, E, C, D, F, x_t, w_t, st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<float>(x, w, out, E, C, D, F, x_t, w_t, st);
    case 1:
      return launch<__nv_bfloat16>(x, w, out, E, C, D, F, x_t, w_t, st);
    case 2:
      return launch<__half>(x, w, out, E, C, D, F, x_t, w_t, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
