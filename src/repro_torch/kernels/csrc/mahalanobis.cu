// Simple CNAPs Mahalanobis head, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/mahalanobis.py: mahalanobis
// (def :29, pl.pallas_call :37)
//     d2[t, m, c] = (q[t, m] - mu[t, c])^T Sinv[t, c] (q[t, m] - mu[t, c])
// with a leading task-lane axis t.
//
// What bounds it, at the serving shape (T=4 lanes, M=8 queries per lane,
// C=5 ways, F=256): reading Sinv, T*C*F^2*4 = 5.2 MB, against
// 2*T*C*M*F^2 = 21 MFLOP.  So it is bound by bytes, every Sinv element is
// read once per query tile, and the whole card has to read: HBM streams at
// its rate only with about 2 MB in flight, and one block per (t, c) cannot
// pull 1 MB fast enough (the TPU kernel's whole (F, F) tile in VMEM does
// not fit in a block's shared memory either: 256 KiB at F = 256).
//
// Design.  The quadratic form is split by rows of Sinv,
//     d2[m] = sum_i diff[m, i] * (sum_j Sinv[i, j] * diff[m, j]),
// and one thread-block cluster of k blocks (k <= 8) serves one (t, c,
// tile of up to 32 queries).  Block `rank` owns rows [rank * rows,
// (rank + 1) * rows) of Sinv[t, c]: a contiguous slice, pulled into shared
// memory by one bulk asynchronous copy (cp.async.bulk, completion on an
// mbarrier) while the block's threads form the tile's diff rows.  At F =
// 256 that is 4 * 5 * 8 = 160 blocks with 32 KB each in flight at once.
// Where the slice is not 16-byte aligned or its size not a multiple of 16
// bytes (F % 4 != 0, or a misaligned Sinv), every thread issues 4-byte
// cp.async copies of its share instead, and they arrive on the same
// mbarrier (cp.async.mbarrier.arrive.noinc).  A slice too large for
// shared memory streams through two stages of `stage_rows` rows.  The
// planner (mahalanobis.py::mahalanobis_plan) picks k, rows, the stages,
// the query tile and the copy path.
//
// The math: a lane holds its columns j = lane + 32 jj of a pass of 256
// columns of the tile's diff rows in registers (8 queries x 8 columns), so
// each Sinv row costs one shared-memory load a column.  (Re-reading the
// diff rows for every Sinv row, 9 loads a column for 8 FMAs, made the math
// 2.6 us of a 9 us kernel at the serving shape on an H100.)
//
// Sum order, deterministic: in a block, lane l of warp w sums its columns
// of a pass for each of its rows i = w, w + 8, ... (rows in order, passes
// in order), times diff[m, i]; the lanes meet by an xor butterfly, the
// warps in order in shared memory.  Each block writes its partials into
// rank 0's shared memory (distributed shared memory) and arrives on the
// cluster barrier; only rank 0 waits, and adds the k partials in rank
// order.  No atomics: the same bits on every run.  A cluster barrier
// arrived at on entry and waited on before those writes makes sure every
// block has started.  (Two full cluster barriers, every block waiting on
// both, took 1.6 us on an H100.)
//
// Wide F, the "stream" route (F > 2048).  The design above keeps the diff
// rows of a tile (8 queries x F) in shared memory whole, which at F 8192
// takes 256 KB, more than a block's 227 KB; and it gives a (t, c, tile) at
// most 8 blocks, so at F 8192 a few classes would pull 256 MB each through
// a few SMs.  The stream route splits Sinv[t, c] into bands of 32 rows,
// one block a band (F / 32 blocks a (t, c, tile): 512 at F 8192 for two
// classes), with no cluster.  A block walks its band's columns in slices
// of 256: each stage holds Sinv[band, slice] (32 KB, rows of 1 KB read
// whole), q[tile, slice] and mu[slice], copied together by cp.async (16
// bytes a copy where F % 4 == 0 and Sinv is 16-byte aligned, else 4
// bytes), two stages in flight.  Warp w owns rows 4w .. 4w + 3 of the
// band; a lane forms the diff of its 8 columns of the slice (j = lane +
// 32 jj) in registers and keeps, across the slices, its partial of u[m, i]
// = sum_j Sinv[i, j] diff[m, j] for its 4 rows and 8 queries.  At the end
// the lanes meet by the butterfly, each row adds diff[m, i] * u[m, i] (rows
// in order, warps in order) and the block writes its band's partial sums;
// a second kernel adds the bands in band order.  No atomics: the same
// bits on every run.  Every Sinv element is read once per tile of up to 8
// queries.  F up to 65536.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;       // queries a pass keeps in registers
constexpr int kMaxTile = 32;    // queries a cluster serves
constexpr int kMaxStages = 2;
constexpr int kMaxCluster = 8;  // blocks a cluster (the portable limit)
constexpr int kCols = 8;        // columns of a pass a lane holds in registers
constexpr int kBandRows = 32;     // stream route: Sinv rows a block
constexpr int kSliceCols = 256;   // stream route: columns a stage

// mbarrier wait bounded in time: a copy that never lands (a fault in the
// copy path) traps, which fails the launch, instead of hanging the card.
__device__ __forceinline__ void wait_or_trap(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = hopper::smem_u32(bar);
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();  // ~10 s
  } while (!done);
}

// Copy `nr` rows of Sinv from `src` into `dst`, completing on `bar`.  The
// bulk path: one cp.async.bulk, issued by the one thread that calls it.
__device__ __forceinline__ void bulk_rows(float* dst, const float* src, int nr, int F,
                                          uint64_t* bar) {
  const uint32_t bytes = (uint32_t)nr * (uint32_t)F * 4u;
  hopper::mbar_expect_tx(bar, bytes);
  if (bytes > 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];" ::"r"(hopper::smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(hopper::smem_u32(bar))
        : "memory");
}

// The per-thread path: every thread copies its share by 4-byte cp.async
// and arrives on `bar` when its copies land (all threads call it).
__device__ __forceinline__ void thread_rows(float* dst, const float* src, int nr, int F,
                                            uint64_t* bar) {
  const int n = nr * F;
  for (int e = threadIdx.x; e < n; e += kThreads)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(hopper::smem_u32(dst + e)),
                 "l"(src + e)
                 : "memory");
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];" ::"r"(hopper::smem_u32(bar))
               : "memory");
}


// Grid (k * tiles, C, T), clusters of (k, 1, 1).  Dynamic shared memory:
// `stages` buffers of stage_rows x F floats (Sinv rows), then the diff
// tile of ceil(tile / 8) * 8 rows x F.
__global__ void __launch_bounds__(kThreads)
    mahalanobis_kernel(const float* __restrict__ q, const float* __restrict__ mu,
                       const float* __restrict__ sinv, float* __restrict__ out, int M, int C,
                       int F, int rows, int stage_rows, int stages, int tile, int bulk) {
  // every block of the cluster has started before any writes to rank 0
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int t = blockIdx.z, c = blockIdx.y, m0 = (blockIdx.x / k) * tile;
  const int tile8 = (tile + kGroup - 1) / kGroup * kGroup;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  extern __shared__ __align__(16) float smem[];
  float* sbuf = smem;                                       // [stages][stage_rows][F]
  float* diff = smem + (size_t)stages * stage_rows * F;     // [tile8][F]
  __shared__ uint64_t bars[kMaxStages];
  __shared__ float red[kWarps][kMaxTile];                   // per-warp sums
  __shared__ float part[kMaxCluster][kMaxTile];             // rank 0: every block's sums

  const int i0 = rank * rows;
  const int nrows = max(0, min(rows, F - i0));
  const int nchunks = max(1, (nrows + stage_rows - 1) / stage_rows);
  const float* S = sinv + (((size_t)t * C + c) * F + i0) * F;
  const auto chunk_rows = [&](int ch) { return max(0, min(stage_rows, nrows - ch * stage_rows)); };

  // every stage's copy in flight first: the bulk copies from thread 0 at
  // once, the per-thread copies once the barriers' init is visible
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) hopper::mbar_init(&bars[s], bulk ? 1 : kThreads);
    hopper::mbar_fence_init();
    if (bulk)
      for (int s = 0; s < stages && s < nchunks; ++s)
        bulk_rows(sbuf + (size_t)s * stage_rows * F, S + (size_t)s * stage_rows * F,
                  chunk_rows(s), F, &bars[s]);
  }
  if (!bulk) {
    __syncthreads();
    for (int s = 0; s < stages && s < nchunks; ++s)
      thread_rows(sbuf + (size_t)s * stage_rows * F, S + (size_t)s * stage_rows * F,
                  chunk_rows(s), F, &bars[s]);
  }
  for (int e = threadIdx.x; e < kWarps * kMaxTile; e += kThreads) (&red[0][0])[e] = 0.f;
  // the diff rows of the tile, zero past M, formed under the copies
  const float* qt = q + (size_t)t * M * F;
  const float* mut = mu + ((size_t)t * C + c) * F;
  for (int j = threadIdx.x; j < F; j += kThreads) {
    const float mv = mut[j];
    for (int g0 = 0; g0 < tile8; g0 += kGroup) {
      float v[kGroup];  // a group's loads all issued before the first use
#pragma unroll
      for (int mm = 0; mm < kGroup; ++mm) {
        const int r = g0 + mm;
        v[mm] = (r < tile && m0 + r < M) ? qt[(size_t)(m0 + r) * F + j] - mv : 0.f;
      }
#pragma unroll
      for (int mm = 0; mm < kGroup; ++mm) diff[(size_t)(g0 + mm) * F + j] = v[mm];
    }
  }
  __syncthreads();

  for (int ch = 0; ch < nchunks; ++ch) {
    const int s = ch % stages;
    wait_or_trap(&bars[s], (uint32_t)((ch / stages) & 1));
    const float* Ss = sbuf + (size_t)s * stage_rows * F;
    const int r0 = ch * stage_rows, nr = chunk_rows(ch);
    for (int g0 = 0; g0 < tile8; g0 += kGroup) {
      const float* D = diff + (size_t)g0 * F;
      float pacc[kGroup];
#pragma unroll
      for (int mm = 0; mm < kGroup; ++mm) pacc[mm] = 0.f;
      // columns in passes of 32 * kCols: a lane keeps its columns of the
      // group's diff rows in registers, so each Sinv row costs one shared
      // load a column (and 8 broadcast loads of diff[., i])
      for (int c0 = 0; c0 < F; c0 += 32 * kCols) {
        float dj[kGroup][kCols];
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) {
          const int j = c0 + lane + 32 * jj;
#pragma unroll
          for (int mm = 0; mm < kGroup; ++mm) dj[mm][jj] = j < F ? D[mm * F + j] : 0.f;
        }
        for (int r = warp; r < nr; r += kWarps) {
          const float* Srow = Ss + (size_t)r * F;
          float acc[kGroup];
#pragma unroll
          for (int mm = 0; mm < kGroup; ++mm) acc[mm] = 0.f;
#pragma unroll
          for (int jj = 0; jj < kCols; ++jj) {
            const int j = c0 + lane + 32 * jj;
            const float sv = j < F ? Srow[j] : 0.f;
#pragma unroll
            for (int mm = 0; mm < kGroup; ++mm) acc[mm] = fmaf(sv, dj[mm][jj], acc[mm]);
          }
          const int i = i0 + r0 + r;
#pragma unroll
          for (int mm = 0; mm < kGroup; ++mm) pacc[mm] = fmaf(D[mm * F + i], acc[mm], pacc[mm]);
        }
      }
#pragma unroll
      for (int mm = 0; mm < kGroup; ++mm) {
        float v = pacc[mm];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) red[warp][g0 + mm] += v;
      }
    }
    __syncthreads();  // every thread is done with stage s (and red is current)
    if (ch + stages < nchunks) {
      float* dst = sbuf + (size_t)s * stage_rows * F;
      const float* src = S + (size_t)(ch + stages) * stage_rows * F;
      if (!bulk)
        thread_rows(dst, src, chunk_rows(ch + stages), F, &bars[s]);
      else if (threadIdx.x == 0)
        bulk_rows(dst, src, chunk_rows(ch + stages), F, &bars[s]);
    }
  }
  // this block's sums into rank 0's shared memory; then only rank 0 waits
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (threadIdx.x < tile8) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][threadIdx.x];
    cluster.map_shared_rank(&part[rank][0], 0)[threadIdx.x] = v;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  if (rank != 0) return;  // rank 0 reads nothing of this block's shared memory
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (threadIdx.x < tile && m0 + threadIdx.x < M) {
    float v = 0.f;
    for (int r = 0; r < k; ++r) v += part[r][threadIdx.x];
    out[((size_t)t * M + m0 + threadIdx.x) * C + c] = v;
  }
}

// The stream route.  Grid (bands * tiles, C, T), bands = ceil(F / 32).
// Dynamic shared memory: two stages of [32][256] Sinv, [8][256] q and
// [256] mu.  Writes each band's partial sums to part[t, c, tile, band, 8].
__global__ void __launch_bounds__(kThreads)
    mahalanobis_stream_kernel(const float* __restrict__ q, const float* __restrict__ mu,
                              const float* __restrict__ sinv, float* __restrict__ part, int M,
                              int C, int F, int tile, int vec) {
  constexpr int kRowsW = kBandRows / kWarps;   // rows a warp
  constexpr int kColsL = kSliceCols / 32;      // columns of a slice a lane
  constexpr int kStage = (kBandRows + kGroup + 1) * kSliceCols;  // floats a stage
  const int bands = (F + kBandRows - 1) / kBandRows;
  const int band = blockIdx.x % bands, ti = blockIdx.x / bands;
  const int t = blockIdx.z, c = blockIdx.y, m0 = ti * tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ __align__(16) float smem[];
  float* const sm = smem;
  __shared__ float red[kWarps][kGroup];

  const int i0 = band * kBandRows;
  const int nrows = min(kBandRows, F - i0);
  const int nslices = (F + kSliceCols - 1) / kSliceCols;
  const float* S = sinv + (((size_t)t * C + c) * F + i0) * F;
  const float* qt = q + ((size_t)t * M + m0) * F;
  const float* mut = mu + ((size_t)t * C + c) * F;
  const auto live = [&](int mm) { return mm < tile && m0 + mm < M; };

  // stage column slice `sl`: the band's Sinv rows, q rows and mu, zeros
  // past F, past the band and past the tile
  const auto load_slice = [&](int sl) {
    float* Sb = sm + (sl & 1) * kStage;
    float* Qb = Sb + kBandRows * kSliceCols;
    float* Mb = Qb + kGroup * kSliceCols;
    const int j0 = sl * kSliceCols;
    if (vec) {
      for (int e = tid; e < kBandRows * kSliceCols / 4; e += kThreads) {
        const int r = e / (kSliceCols / 4), jj = (e % (kSliceCols / 4)) * 4, j = j0 + jj;
        const bool ok = r < nrows && j < F;
        hopper::cp_async16(Sb + r * kSliceCols + jj, ok ? S + (size_t)r * F + j : S, ok);
      }
    } else {
      for (int e = tid; e < kBandRows * kSliceCols; e += kThreads) {
        const int r = e / kSliceCols, j = j0 + e % kSliceCols;
        const bool ok = r < nrows && j < F;
        hopper::cp_async4(Sb + e, ok ? S + (size_t)r * F + j : S, ok);
      }
    }
    for (int e = tid; e < kGroup * kSliceCols; e += kThreads) {
      const int mm = e / kSliceCols, j = j0 + e % kSliceCols;
      const bool ok = live(mm) && j < F;
      hopper::cp_async4(Qb + e, ok ? qt + (size_t)mm * F + j : q, ok);
    }
    for (int e = tid; e < kSliceCols; e += kThreads)
      hopper::cp_async4(Mb + e, j0 + e < F ? mut + j0 + e : mu, j0 + e < F);
    hopper::cp_async_commit();
  };

  load_slice(0);
  if (nslices > 1) load_slice(1);
  float acc[kRowsW][kGroup];
#pragma unroll
  for (int rr = 0; rr < kRowsW; ++rr)
#pragma unroll
    for (int mm = 0; mm < kGroup; ++mm) acc[rr][mm] = 0.f;
  for (int sl = 0; sl < nslices; ++sl) {
    if (sl + 1 < nslices)
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    const float* Sb = sm + (sl & 1) * kStage;
    const float* Qb = Sb + kBandRows * kSliceCols;
    const float* Mb = Qb + kGroup * kSliceCols;
    // the diff of this lane's columns of the slice, in registers
    float dj[kGroup][kColsL];
#pragma unroll
    for (int jj = 0; jj < kColsL; ++jj) {
      const float mv = Mb[lane + 32 * jj];
#pragma unroll
      for (int mm = 0; mm < kGroup; ++mm) dj[mm][jj] = Qb[mm * kSliceCols + lane + 32 * jj] - mv;
    }
#pragma unroll
    for (int rr = 0; rr < kRowsW; ++rr) {
      const float* Srow = Sb + (warp * kRowsW + rr) * kSliceCols + lane;
#pragma unroll
      for (int jj = 0; jj < kColsL; ++jj) {
        const float sv = Srow[32 * jj];
#pragma unroll
        for (int mm = 0; mm < kGroup; ++mm) acc[rr][mm] = fmaf(sv, dj[mm][jj], acc[rr][mm]);
      }
    }
    __syncthreads();  // every thread is done with this stage
    if (sl + 2 < nslices) load_slice(sl + 2);
  }
  // u[m, i] of each row by the butterfly; then sum_i diff[m, i] u[m, i],
  // rows in order
  float p[kGroup];
#pragma unroll
  for (int mm = 0; mm < kGroup; ++mm) p[mm] = 0.f;
#pragma unroll
  for (int rr = 0; rr < kRowsW; ++rr) {
    const int r = warp * kRowsW + rr;
    const float mv = r < nrows ? mut[i0 + r] : 0.f;
#pragma unroll
    for (int mm = 0; mm < kGroup; ++mm) {
      float u = acc[rr][mm];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) u += __shfl_xor_sync(0xffffffffu, u, off);
      if (r < nrows && live(mm)) p[mm] = fmaf(qt[(size_t)mm * F + i0 + r] - mv, u, p[mm]);
    }
  }
  if (lane == 0)
#pragma unroll
    for (int mm = 0; mm < kGroup; ++mm) red[warp][mm] = p[mm];
  __syncthreads();
  if (tid < kGroup) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][tid];
    const int tiles = gridDim.x / bands;
    part[((((size_t)t * C + c) * tiles + ti) * bands + band) * kGroup + tid] = v;
  }
}

// The stream route's second kernel: out[t, m, c] = the bands' partial sums
// of (t, c, m's tile), added in band order.
__global__ void mahalanobis_stream_sum_kernel(const float* __restrict__ part,
                                              float* __restrict__ out, int T, int M, int C,
                                              int bands, int tile) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= T * M * C) return;
  const int c = idx % C, m = (idx / C) % M, t = idx / (C * M);
  const int tiles = (M + tile - 1) / tile;
  const float* pp =
      part + ((((size_t)t * C + c) * tiles + m / tile) * bands) * kGroup + m % tile;
  float v = 0.f;
  for (int b = 0; b < bands; ++b) v += pp[(size_t)b * kGroup];
  out[idx] = v;
}

}  // namespace

// q: (T, M, F); mu: (T, C, F); sinv: (T, C, F, F); out: (T, M, C).  All fp32,
// contiguous.  The plan (mahalanobis.py::mahalanobis_plan): `tile` queries a
// cluster or block, `bulk` the copy path; `cols` 0: clusters of k blocks,
// `rows` Sinv rows a block, streamed in `stages` buffers of `stage_rows`
// rows; `cols` 256: the stream route, k bands of 32 rows, partial sums in
// `part` (T * C * ceil(M / tile) * k * 8 floats).  Returns the cudaError_t
// of the launch.
extern "C" int rt_mahalanobis(const void* q, const void* mu, const void* sinv, void* out, int T,
                              int M, int C, int F, int k, int rows, int stage_rows, int stages,
                              int tile, int bulk, int cols, void* part, void* stream) {
  if (T == 0 || M == 0 || C == 0) return 0;
  if (F < 1 || tile < 1 || tile > kMaxTile) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (M + tile - 1) / tile;
  if (cols != 0) {
    if (cols != kSliceCols || tile > kGroup || rows != kBandRows ||
        k != (F + kBandRows - 1) / kBandRows || part == nullptr)
      return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * 2 * (kBandRows + kGroup + 1) * kSliceCols;
    cudaError_t e = hopper::allow_smem(mahalanobis_stream_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    mahalanobis_stream_kernel<<<dim3((unsigned)(k * tiles), (unsigned)C, (unsigned)T), kThreads,
                                smem, st>>>((const float*)q, (const float*)mu,
                                            (const float*)sinv, (float*)part, M, C, F, tile,
                                            bulk);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int n = T * M * C;
    mahalanobis_stream_sum_kernel<<<(n + 255) / 256, 256, 0, st>>>((const float*)part,
                                                                   (float*)out, T, M, C, k, tile);
    return (int)cudaGetLastError();
  }
  if (k < 1 || k > kMaxCluster || rows < 1 || stage_rows < 1 || stages < 1 || stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  const int tile8 = (tile + kGroup - 1) / kGroup * kGroup;
  const size_t smem = sizeof(float) * ((size_t)stages * stage_rows + tile8) * (size_t)F;
  if (smem > 48 * 1024) {
    const cudaError_t e = hopper::allow_smem(mahalanobis_kernel, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(k * tiles), (unsigned)C, (unsigned)T);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, mahalanobis_kernel, (const float*)q,
                                           (const float*)mu, (const float*)sinv, (float*)out, M,
                                           C, F, rows, stage_rows, stages, tile, bulk);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
