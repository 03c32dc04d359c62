// Mamba-2 SSD intra-chunk computation, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py: ssd_chunk (def :56,
// pl.pallas_call :70).  Per chunk g (batch * heads * chunks flattened), with
// x (Q, P), dt (Q,), scalar A, B and C (Q, N), all in fp32 math:
//     dA_cum = cumsum(dt * A)
//     L[l, s] = exp(dA_cum[l] - dA_cum[s]) where l >= s, else 0
//     y_diag = ((C B^T) o L) diag(dt) x                    (Q, P)
//     states = (B^T diag(exp(dA_cum[-1] - dA_cum) * dt) x)^T (P, N)
//     chunk_decay = exp(dA_cum[-1]);  state_decay = exp(dA_cum)
// Inputs are fp32, bf16 or fp16 (one dtype); the outputs are fp32.
//
// What bounds it, at the mamba2-780m shape (G = 48 heads x 32 chunks = 1536,
// Q = 256, P = 64, N = 128): about 2*Q^2/2*(N + P) + 2*Q*P*N FLOPs a
// chunk, 0.04 TFLOP in all, over 0.66 GB of fp32 inputs and outputs (0.41
// GB with bf16 inputs).  On the CUDA cores in fp32 (route "simt") that is
// bound by operations, 0.39 ms at 67 TFLOP/s; on the tensor cores (route
// "wgmma"), with the work counted once, by bytes: 0.196 ms (fp32 inputs),
// 0.121 ms (bf16) at 3.35 TB/s.
//
// Two routes, chosen by the caller (kernels/ssd_scan.py: ssd_route) from
// dtype, widths and alignment before the launch, never after a failure:
//
// "wgmma" (fp32, bf16 or fp16; P and N multiples of 16, P <= 64, N <= 128,
// Q <= 512; 16-byte-aligned bases).  The chunk is causal attention with a
// decay mask in place of a softmax, so it is tiled as flash attention is:
// 64-row strips of l against 64-row blocks of s at or below the diagonal.
// Two kernels, both one warpgroup per 64-row strip and wgmma on bf16
// tiles in 128-byte-swizzled shared memory (csrc/hopper.cuh):
//   * the y kernel, one block of two warpgroups per two strips of a chunk
//     (the longest strips first).  Both strips share each block j of B and
//     x, copied by cp.async under the previous block's products.  Per
//     block: S = C B_j^T (K = N), then S' = S * exp(dA[l] - dA[s]) * dt[s]
//     on the accumulator fragments in registers (exp only where l >= s:
//     above the diagonal it overflows), then Y += S' x_j with S' as the
//     register A operand (as flash takes P) and x_j read N-major;
//   * the states kernel, one warpgroup per chunk: states = (decay * dt o
//     x)^T B as one wgmma product over K = Q, the A operand built in
//     registers from the staged x block, written once (no read-modify-write
//     in global memory); it also writes chunk_decay and state_decay.
// The cumsum of dt * A is a block scan by warp shuffles (its order of
// additions, below, differs from torch.cumsum's within the tolerance).
// fp32 accuracy: bf16 tensor cores with fp32 inputs split three ways and
// every product summed from its six leading part products; each 16-deep K
// slice summed alone by the tensor cores and the slices added in fp32 on
// the CUDA cores, because the tensor cores' own fp32 sum truncates (see
// the "wgmma" route below).  Against a float64 reference the route reads
// half the per-row error of the fp32 plain version at the mamba2-780m
// shape (PERF.md).
//
// "simt" (other widths, Q past 512, layouts 16-byte loads cannot read),
// fp32 on the CUDA cores.  One block of 256 threads per chunk g.  The
// (Q, Q) matrix C B^T o L is 256 KiB in fp32 at Q = 256, more than a
// block's 227 KB of shared memory, so the kernel tiles it: for each 32-row
// tile of l, it streams the 32-column tiles of s with s <= l (tiles above
// the diagonal are wholly masked and skipped), forms the 32 x 32 tile of
// (C B^T) * exp(dA_cum[l] - dA_cum[s]) * dt[s] in shared memory, and adds
// its product with the x tile to the y rows it accumulates in shared
// memory.  exp is evaluated only where l >= s: above the diagonal dA_cum[l]
// - dA_cum[s] > 0 may overflow, and inf * 0 would give NaN.  The cumsum is
// one thread's sequential loop over the chunk, in the order jnp.cumsum
// adds, with the multiply and add kept apart (no fused multiply-add),
// because exp amplifies any reordering.  The last l tile visits every s
// tile, and on that pass the block also adds each s tile's share of the
// chunk state into the fp32 output, which only this block writes.  Ragged
// Q, P and N are zero filled on load and masked on store.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "ssd_wgmma.cuh"

namespace {

using namespace ssd_wgmma;


constexpr int kThreads = 256;
constexpr int kT = 32;         // rows l and columns s per tile
constexpr int kMS = kT + 1;    // padded row stride of the (l, s) tile

__host__ __device__ inline size_t smem_floats(int Q, int P, int N) {
  return 2 * (size_t)Q + 2 * (size_t)kT * (N + 1) + 2 * (size_t)kT * P + (size_t)kT * kMS + kT;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ A,
                     const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ y,
                     float* __restrict__ st, float* __restrict__ cd, float* __restrict__ sd,
                     int Q, int P, int N) {
  const int NS = N + 1;  // padded row stride of the B and C tiles
  extern __shared__ float sm[];
  float* dA = sm;               // [Q] cumsum of dt * A
  float* dts = dA + Q;          // [Q]
  float* cs = dts + Q;          // [kT][NS] C rows of the l tile
  float* bs = cs + kT * NS;     // [kT][NS] B rows of the s tile
  float* xs = bs + kT * NS;     // [kT][P]  x rows of the s tile
  float* ya = xs + kT * P;      // [kT][P]  y rows of the l tile
  float* ms = ya + kT * P;      // [kT][kMS] (C B^T o L) diag(dt) tile
  float* wq = ms + kT * kMS;    // [kT] exp(dA_cum[-1] - dA_cum[s]) * dt[s]

  const int g = blockIdx.x, tid = threadIdx.x;
  const T* xg = x + (size_t)g * Q * P;
  const T* bg = Bm + (size_t)g * Q * N;
  const T* cg = Cm + (size_t)g * Q * N;
  float* yg = y + (size_t)g * Q * P;
  float* stg = st + (size_t)g * P * N;

  for (int i = tid; i < Q; i += kThreads) dts[i] = to_f32(dt[(size_t)g * Q + i]);
  __syncthreads();
  if (tid == 0) {
    const float a = to_f32(A[g]);
    float c = 0.f;
    for (int i = 0; i < Q; ++i) {
      c = __fadd_rn(c, __fmul_rn(dts[i], a));
      dA[i] = c;
    }
    cd[g] = expf(c);
  }
  __syncthreads();
  for (int i = tid; i < Q; i += kThreads) sd[(size_t)g * Q + i] = expf(dA[i]);
  const float last = dA[Q - 1];

  const int nt = (Q + kT - 1) / kT;
  for (int lt = 0; lt < nt; ++lt) {
    const int l0 = lt * kT;
    const bool last_tile = lt == nt - 1;
    __syncthreads();  // the last tile is done with cs and ya
    for (int idx = tid; idx < kT * N; idx += kThreads) {
      const int r = idx / N, n = idx % N;
      cs[r * NS + n] = l0 + r < Q ? to_f32(cg[(size_t)(l0 + r) * N + n]) : 0.f;
    }
    for (int idx = tid; idx < kT * P; idx += kThreads) ya[idx] = 0.f;

    for (int stile = 0; stile <= lt; ++stile) {
      const int s0 = stile * kT;
      __syncthreads();  // the last step is done with bs, xs, ms and wq
      for (int idx = tid; idx < kT * N; idx += kThreads) {
        const int r = idx / N, n = idx % N;
        bs[r * NS + n] = s0 + r < Q ? to_f32(bg[(size_t)(s0 + r) * N + n]) : 0.f;
      }
      for (int idx = tid; idx < kT * P; idx += kThreads) {
        const int r = idx / P, p = idx % P;
        xs[idx] = s0 + r < Q ? to_f32(xg[(size_t)(s0 + r) * P + p]) : 0.f;
      }
      if (last_tile && tid < kT) {
        const int s = s0 + tid;
        wq[tid] = s < Q ? expf(last - dA[s]) * dts[s] : 0.f;
      }
      __syncthreads();

      // (C B^T o L) diag(dt) on this (l, s) tile; exp only where l >= s
      for (int idx = tid; idx < kT * kT; idx += kThreads) {
        const int l = idx / kT, s = idx % kT, gl = l0 + l, gs = s0 + s;
        float v = 0.f;
        if (gl < Q && gl >= gs) {
          float cb = 0.f;
          for (int n = 0; n < N; ++n) cb = fmaf(cs[l * NS + n], bs[s * NS + n], cb);
          v = cb * expf(dA[gl] - dA[gs]) * dts[gs];
        }
        ms[l * kMS + s] = v;
      }
      __syncthreads();

      for (int idx = tid; idx < kT * P; idx += kThreads) {
        const int l = idx / P, p = idx % P;
        float acc = ya[idx];
#pragma unroll 8
        for (int s = 0; s < kT; ++s) acc = fmaf(ms[l * kMS + s], xs[s * P + p], acc);
        ya[idx] = acc;
      }
      if (last_tile) {
        // states[p, n] += sum_s B[s, n] * (x[s, p] * wq[s])
        for (int idx = tid; idx < P * N; idx += kThreads) {
          const int p = idx / N, n = idx % N;
          float acc = 0.f;
#pragma unroll 8
          for (int s = 0; s < kT; ++s) acc = fmaf(bs[s * NS + n], xs[s * P + p] * wq[s], acc);
          stg[idx] = stile == 0 ? acc : stg[idx] + acc;
        }
      }
    }
    for (int idx = tid; idx < kT * P; idx += kThreads) {
      const int l = idx / P;
      if (l0 + l < Q) yg[(size_t)l0 * P + idx] = ya[idx];
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y,
           void* st, void* cd, void* sd, int G, int Q, int P, int N, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(Q, P, N);
  auto kern = ssd_chunk_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<G, kThreads, smem, stream>>>((const T*)x, (const T*)dt, (const T*)A, (const T*)B,
                                      (const T*)C, (float*)y, (float*)st, (float*)cd, (float*)sd,
                                      Q, P, N);
  return (int)cudaGetLastError();
}


// ---- the "wgmma" route ---------------------------------------------------
//
// Every tile the tensor cores read is bf16 in the 128-byte-swizzled layout
// of hopper.cuh, 64 rows by WT columns (atoms of 64 columns).  bf16 holds a
// bf16 input exactly; fp32 and fp16 inputs enter as three tiles, hi =
// bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid), and the fp32
// intermediates (S' and decay * dt * x) are split the same way in
// registers.  A product of two split operands is the fp32 sum of the six
// part products down to 2^-16 of hi * hi (pair_a, pair_b); a product with
// one split operand sums its three parts.  Two parts were not enough: a dot
// product of C and B that cancels loses the 2^-17 of each term that a
// two-way split keeps (a CPU model of this arithmetic,
// tests/test_torch_hopper_routes.py, read 9e-5 per row against the 1e-4
// budget; three parts read at most 1.5e-5).
//
// Loads.  The B and x blocks of step j + 1 are copied by cp.async while
// step j computes: straight into the swizzled tiles for bf16 (two buffers),
// into a row-major staging area for fp32 and fp16, which the next step
// splits into the tiles.  The C strip is loaded once, directly.  These tile
// helpers and the slice-by-slice accumulation are in ssd_wgmma.cuh, which
// the backward (ssd_scan_bwd.cu) shares.

// dt of the chunk into dts[0, Q) and its cumsum of dt * A into dA[0, Q),
// by a block scan: thread t adds its K = ceil(Q / 128) consecutive values
// in order, the 32 lanes of a warp scan their totals by shuffles
// (Hillis-Steele, offsets 1 .. 16), and each thread adds the totals of the
// warps before it in order, then its lane's exclusive prefix, then its own
// running sum.  The multiplies and adds are kept apart (no fused
// multiply-add).  tests/test_torch_hopper_routes.py models this order.
// The first 128 threads of the block compute it (so both kernels add in
// the same order); every thread of the block reaches its barriers.
template <typename T>
__device__ __forceinline__ void chunk_cumsum(const T* __restrict__ dt, float a, float* dts,
                                             float* dA, float* wsum, int Q) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool on = tid < kTcThreads;  // whole warps
  if (on)
    for (int i = tid; i < Q; i += kTcThreads) dts[i] = to_f32(dt[i]);
  __syncthreads();
  if (!on) {
    __syncthreads();
    __syncthreads();
    return;
  }
  const int K = (Q + kTcThreads - 1) / kTcThreads;
  float run = 0.f;
  for (int k = 0; k < K; ++k) {
    const int i = tid * K + k;
    if (i < Q) {
      run = __fadd_rn(run, __fmul_rn(dts[i], a));
      dA[i] = run;
    }
  }
  float inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc = __fadd_rn(inc, up);
  }
  float excl = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) excl = 0.f;
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  float base = 0.f;
  for (int w = 0; w < warp; ++w) base = __fadd_rn(base, wsum[w]);
  const float off = __fadd_rn(base, excl);
  for (int k = 0; k < K; ++k) {
    const int i = tid * K + k;
    if (i < Q) dA[i] = __fadd_rn(off, dA[i]);
  }
  __syncthreads();
}

// Shared memory of the y kernel: the two C strips' tiles, the B and x block
// tiles (kBufs buffers), their staging areas, then dt and dA (Qp = nL * 64
// floats each), 64 column factors, 2 nL block ranges and 4 warp totals;
// 1024 bytes more for the alignment.
template <typename T, int NT>
constexpr size_t y_smem(int Qp) {
  using In = TcIn<T>;
  return (size_t)2 * In::kParts * tile_bytes<NT>() +
         (size_t)In::kBufs * In::kParts * (tile_bytes<NT>() + tile_bytes<64>()) +
         stage_bytes<T, NT>() + stage_bytes<T, 64>() +
         (2 * (size_t)Qp + kTcRows + 2 * (size_t)Qp / kTcRows + 4) * sizeof(float) + 1024;
}

constexpr int kYThreads = 2 * kTcThreads;  // two warpgroups, two strips

// y_diag of two 64-row strips of chunk g, one a warpgroup (grid: ceil(nL /
// 2) * G blocks; block pi of a chunk takes strips la = nL - 1 - 2 pi and la
// - 1, the longest first; for odd nL the last block's second warpgroup
// repeats strip 0 and stores nothing).  The two strips share each block j
// <= la of B and x, loaded once by all 256 threads.  Per warpgroup and
// block: S = C_li B_j^T (wgmma, K = N, both K-major), S' = S * exp(dA[l] -
// dA[s]) * dt[s] where l >= s (else 0: exp is evaluated only there, as
// above the diagonal it overflows) in the accumulator registers, split
// into three bf16 A fragments, and Y += S' x_j (wgmma with A from
// registers, x_j N-major).  A block past a warpgroup's strip (j > li) is
// wholly masked (S' = 0), so that both warpgroups issue the same wgmma
// whatever their strip.
template <typename T, int NT>
__global__ void __launch_bounds__(kYThreads, 1)
    ssd_wgmma_y_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                       const T* __restrict__ A, const T* __restrict__ Bm,
                       const T* __restrict__ Cm, float* __restrict__ y, int Q, int P, int N,
                       int nL) {
  using In = TcIn<T>;
  constexpr int kParts = In::kParts;
  constexpr int kNT = tile_bytes<NT>(), kXT = tile_bytes<64>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align_1024(smem_raw);
  uint8_t* cs = sm;                        // 2 x kParts tiles
  uint8_t* bs = cs + 2 * kParts * kNT;     // kBufs x kParts tiles
  uint8_t* xs = bs + In::kBufs * kParts * kNT;
  uint8_t* bst = xs + In::kBufs * kParts * kXT;  // staging (fp32 / fp16)
  uint8_t* xst = bst + stage_bytes<T, NT>();
  float* dts = reinterpret_cast<float*>(xst + stage_bytes<T, 64>());
  float* dA = dts + nL * kTcRows;
  float* es = dA + nL * kTcRows;  // [64] exp(m - dA[s]) * dt[s] of this block
  float* bmin = es + kTcRows;     // [nL] least dA of each 64-row block
  float* bmax = bmin + nL;        // [nL] largest
  float* wsum = bmax + nL;

  const int npair = (nL + 1) / 2;
  const int g = blockIdx.x / npair;
  const int la = nL - 1 - 2 * (int)(blockIdx.x % npair);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);  // uniform, as the compiler sees it
  const int tid = threadIdx.x % kTcThreads;              // in the warpgroup
  const int li = wg == 0 ? la : max(la - 1, 0);          // this warpgroup's strip
  const bool store = wg == 0 || la >= 1;
  const int l0 = li * kTcRows;
  const size_t gq = (size_t)g * Q;
  const T* bg = Bm + gq * N;
  const T* xg = x + gq * P;
  uint8_t* cw = cs + wg * kParts * kNT;  // this warpgroup's C strip
  // block 0's copies run under the cumsum and the C strips' loads
  stage_tile<T, NT, kYThreads>(bg, 0, Q, N, kParts == 1 ? bs : bst);
  stage_tile<T, 64, kYThreads>(xg, 0, Q, P, kParts == 1 ? xs : xst);
  hopper::cp_async_commit();
  chunk_cumsum(dt + gq, to_f32(A[g]), dts, dA, wsum, Q);
  for (int b = warp; b < nL; b += kYThreads / 32) {  // block ranges of dA
    float lo = INFINITY, hi = -INFINITY;
    for (int i = 64 * b + lane; i < min(64 * b + 64, Q); i += 32) {
      lo = fminf(lo, dA[i]);
      hi = fmaxf(hi, dA[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      bmin[b] = lo;
      bmax[b] = hi;
    }
  }
  load_tile<T, NT, kTcThreads>(Cm + gq * N, l0, Q, N, cw, tid);

  // this thread's rows of the strip (l0 + row0, + 8) and column pair base
  const int row0 = 16 * (warp % 4) + lane / 4, col0 = 2 * (lane % 4);
  float yacc[32], sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) yacc[i] = 0.f;
  const uint32_t ca = hopper::smem_u32(cw);

  for (int j = 0; j <= la; ++j) {
    const int s0 = j * kTcRows;
    const int buf = In::kBufs == 2 ? j % 2 : 0;
    uint8_t* bt = bs + buf * kParts * kNT;
    uint8_t* xt = xs + buf * kParts * kXT;
    hopper::cp_async_wait_all();
    __syncthreads();  // block j is in; the last block's products are done
    if constexpr (kParts == 3) {
      convert_tile<T, NT, kYThreads>(bst, bt);
      convert_tile<T, 64, kYThreads>(xst, xt);
    }
    // exp(dA[l] - dA[s]) = exp(dA[l] - m) exp(m - dA[s]) with m the block's
    // least dA: 64 + 2 exps a thread instead of 32, where no factor can
    // overflow (exp(m - dA[s]) <= 1; dA[l] - m <= 60), which holds on every
    // block below the diagonal when dt * A <= 0 and on the diagonal unless
    // dA falls by more than 60 within 64 steps.  Else exp per element.
    const float m = bmin[j];
    const bool factor = bmax[li] - m <= 60.f;
    if (threadIdx.x < kTcRows) {
      const int s = s0 + threadIdx.x;
      es[threadIdx.x] = s < Q ? expf(m - dA[s]) * dts[s] : 0.f;
    }
    hopper::fence_proxy_async();
    __syncthreads();
    if (j < la) {  // block j + 1's copies run under this block's products
      const int nb = In::kBufs == 2 ? (j + 1) % 2 : 0;
      stage_tile<T, NT, kYThreads>(bg, s0 + kTcRows, Q, N, kParts == 1 ? bs + nb * kNT : bst);
      stage_tile<T, 64, kYThreads>(xg, s0 + kTcRows, Q, P, kParts == 1 ? xs + nb * kXT : xst);
      hopper::cp_async_commit();
    }
    const uint32_t ba = hopper::smem_u32(bt), xa = hopper::smem_u32(xt);

    // S = C_li B_j^T over K = N: each 16-deep slice's part products summed
    // by the tensor cores (smallest first), the slices in fp32 here
    auto s_slice = [&](float(&d)[32], int kk, bool add) {
      const uint32_t off = (kk / 4) * kTcAtom + (kk % 4) * 32;
      if constexpr (kParts == 1) {
        hopper::wgmma_ss<64, false, 0>(d, hopper::smem_desc(ca + off, 16, 1024),
                                       hopper::smem_desc(ba + off, 16, 1024), add);
      } else {
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const int q = pair_order(i);
          hopper::wgmma_ss<64, false, 0>(d, hopper::smem_desc(ca + pair_a(q) * kNT + off, 16, 1024),
                                         hopper::smem_desc(ba + pair_b(q) * kNT + off, 16, 1024),
                                         add || i > 0);
        }
      }
    };
    slices<NT / 16>(sc, s_slice, true);

    // S' in registers, split into three A fragments of 16 columns each
    float el[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int l = l0 + row0 + 8 * r;
      el[r] = factor && l < Q ? expf(dA[l] - m) : 0.f;
    }
    // the choices (factored exp or not; a block that needs the mask, on
    // the diagonal or past Q, or not) are made outside the element loops,
    // so that no path pays for the other (a per-element choice cost a
    // fifth of the kernel's time)
    uint32_t pf[3][4][4];
    auto build = [&](auto factor_c, auto mask_c) {
      constexpr bool kFactor = decltype(factor_c)::value, kMask = decltype(mask_c)::value;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int l = l0 + row0 + 8 * r;
          float v[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int sl = 8 * jj + col0 + c, s = s0 + sl;
            const float cb = sc[4 * jj + 2 * r + c];
            if (!kMask || (l >= s && l < Q)) {
              v[c] = kFactor ? (cb * el[r]) * es[sl] : (cb * expf(dA[l] - dA[s])) * dts[s];
            } else {
              v[c] = 0.f;
            }
          }
          const int k = jj / 2, i = 2 * (jj % 2) + r;
          split3(v[0], v[1], pf[0][k][i], pf[1][k][i], pf[2][k][i]);
        }
    };
    using Yes = std::true_type;
    using No = std::false_type;
    const bool mask = j >= li || l0 + kTcRows > Q;
    if (factor) {
      if (mask) build(Yes(), Yes()); else build(Yes(), No());
    } else {
      if (mask) build(No(), Yes()); else build(No(), No());
    }

    // Y += S' x_j (x_j is (s, p): N-major), promoted per 16 rows of s
    auto y_slice = [&](float(&d)[32], int kk, bool add) {
      if constexpr (kParts == 1) {
#pragma unroll
        for (int q = 0; q < 3; ++q)
          hopper::wgmma_rs<64, false, 1>(d, pf[2 - q][kk],
                                         hopper::smem_desc(xa + kk * 2048, kTcAtom, 1024),
                                         add || q > 0);
      } else {
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const int q = pair_order(i);
          hopper::wgmma_rs<64, false, 1>(
              d, pf[pair_a(q)][kk],
              hopper::smem_desc(xa + pair_b(q) * kXT + kk * 2048, kTcAtom, 1024), add || i > 0);
        }
      }
    };
    slices<4>(yacc, y_slice, false);
  }

  if (!store) return;
  float* yg = y + gq * P;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int l = l0 + row0 + 8 * r;
    if (l >= Q) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int p = 8 * jj + col0;
      if (p < P)
        *reinterpret_cast<float2*>(yg + (size_t)l * P + p) =
            make_float2(yacc[4 * jj + 2 * r], yacc[4 * jj + 2 * r + 1]);
    }
  }
}

// Shared memory of the states kernel: the B block tiles (kBufs buffers),
// the B staging area (fp32 / fp16), the x staging area, then dt, dA and
// the weights exp(dA[Q-1] - dA[s]) * dt[s] (Qp floats each), warp totals.
template <typename T, int NT>
constexpr size_t state_smem(int Qp) {
  using In = TcIn<T>;
  return (size_t)In::kBufs * In::kParts * tile_bytes<NT>() + stage_bytes<T, NT>() +
         kTcRows * stage_row<T, 64>() + (3 * (size_t)Qp + 4) * sizeof(float) + 1024;
}

// The chunk state of chunk g (grid: G), written once:
//   states[p, n] = sum_s (exp(dA[Q-1] - dA[s]) dt[s] x[s, p]) B[s, n]
// as wgmma with M = P (rows past P zero), K = s in 64-row blocks of B
// (N-major, as B is (s, n)) and A = (decay * dt * x)^T formed in registers
// from the staged x block and split three ways.  The block also writes
// chunk_decay and state_decay.
template <typename T, int NT>
__global__ void __launch_bounds__(kTcThreads)
    ssd_wgmma_state_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                           const T* __restrict__ A, const T* __restrict__ Bm,
                           float* __restrict__ st, float* __restrict__ cd,
                           float* __restrict__ sd, int Q, int P, int N, int nL) {
  using In = TcIn<T>;
  constexpr int kParts = In::kParts;
  constexpr int kNT = tile_bytes<NT>();
  constexpr int kXRow = stage_row<T, 64>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align_1024(smem_raw);
  uint8_t* bs = sm;                                  // kBufs x kParts tiles
  uint8_t* bst = bs + In::kBufs * kParts * kNT;      // staging (fp32 / fp16)
  uint8_t* xst = bst + stage_bytes<T, NT>();         // x block, row-major
  float* dts = reinterpret_cast<float*>(xst + kTcRows * kXRow);
  float* dA = dts + nL * kTcRows;
  float* wq = dA + nL * kTcRows;
  float* wsum = wq + nL * kTcRows;

  const int g = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t gq = (size_t)g * Q;
  const T* bg = Bm + gq * N;
  const T* xg = x + gq * P;
  // x is staged row-major in every dtype (it is read into registers)
  auto stage_x = [&](int s0) {
    constexpr int kPiece = 16 / (int)sizeof(T), kRowPieces = 64 / kPiece;
#pragma unroll
    for (int i = 0; i < kTcRows * kRowPieces / kTcThreads; ++i) {
      const int pc = i * kTcThreads + threadIdx.x;
      const int r = pc / kRowPieces, e0 = (pc % kRowPieces) * kPiece;
      const bool ok = s0 + r < Q && e0 < P;
      hopper::cp_async16(xst + r * kXRow + e0 * (int)sizeof(T),
                         ok ? xg + (size_t)(s0 + r) * P + e0 : xg, ok);
    }
  };
  stage_tile<T, NT, kTcThreads>(bg, 0, Q, N, kParts == 1 ? bs : bst);
  stage_x(0);
  hopper::cp_async_commit();
  chunk_cumsum(dt + gq, to_f32(A[g]), dts, dA, wsum, Q);
  const float last = dA[Q - 1];
  for (int i = threadIdx.x; i < nL * kTcRows; i += kTcThreads) {
    wq[i] = i < Q ? expf(last - dA[i]) * dts[i] : 0.f;
    if (i < Q) sd[gq + i] = expf(dA[i]);
  }
  if (threadIdx.x == 0) cd[g] = expf(last);

  const int p0 = 16 * warp + lane / 4, col0 = 2 * (lane % 4);
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < nL; ++j) {
    const int s0 = j * kTcRows;
    const int buf = In::kBufs == 2 ? j % 2 : 0;
    uint8_t* bt = bs + buf * kParts * kNT;
    hopper::cp_async_wait_all();
    __syncthreads();  // block j is in, wq is written; the last block's products are done
    if constexpr (kParts == 3) convert_tile<T, NT, kTcThreads>(bst, bt);
    // A fragments: row p0 + 8 (m % 2), columns 16 kk + 8 (m / 2) + col0 + c
    uint32_t af[3][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int p = p0 + 8 * (m % 2);
        float v[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int sl = 16 * kk + 8 * (m / 2) + col0 + c;
          v[c] = p < P ? to_f32(*reinterpret_cast<const T*>(xst + sl * kXRow +
                                                           p * (int)sizeof(T))) * wq[s0 + sl]
                       : 0.f;
        }
        split3(v[0], v[1], af[0][kk][m], af[1][kk][m], af[2][kk][m]);
      }
    hopper::fence_proxy_async();
    __syncthreads();  // the x and B staging areas are free again
    if (j + 1 < nL) {  // block j + 1's copies run under this block's products
      const int nb = In::kBufs == 2 ? (j + 1) % 2 : 0;
      stage_tile<T, NT, kTcThreads>(bg, s0 + kTcRows, Q, N, kParts == 1 ? bs + nb * kNT : bst);
      stage_x(s0 + kTcRows);
      hopper::cp_async_commit();
    }
    const uint32_t ba = hopper::smem_u32(bt);

    auto st_slice = [&](float(&d)[NT / 2], int kk, bool add) {
      if constexpr (kParts == 1) {
#pragma unroll
        for (int q = 0; q < 3; ++q)
          hopper::wgmma_rs<NT, false, 1>(d, af[2 - q][kk],
                                         hopper::smem_desc(ba + kk * 2048, kTcAtom, 1024),
                                         add || q > 0);
      } else {
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const int q = pair_order(i);
          hopper::wgmma_rs<NT, false, 1>(
              d, af[pair_a(q)][kk],
              hopper::smem_desc(ba + pair_b(q) * kNT + kk * 2048, kTcAtom, 1024), add || i > 0);
        }
      }
    };
    slices<4>(acc, st_slice, false);
  }

  float* stg = st + (size_t)g * P * N;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = p0 + 8 * r;
    if (p >= P) continue;
#pragma unroll
    for (int jj = 0; jj < NT / 8; ++jj) {
      const int n = 8 * jj + col0;
      if (n < N)
        *reinterpret_cast<float2*>(stg + (size_t)p * N + n) =
            make_float2(acc[4 * jj + 2 * r], acc[4 * jj + 2 * r + 1]);
    }
  }
}

template <typename T, int NT>
int launch_wgmma(const void* x, const void* dt, const void* A, const void* B, const void* C,
                 void* y, void* st, void* cd, void* sd, int G, int Q, int P, int N,
                 cudaStream_t stream) {
  const int nL = (Q + kTcRows - 1) / kTcRows;
  const size_t ys = y_smem<T, NT>(nL * kTcRows), ss = state_smem<T, NT>(nL * kTcRows);
  auto yk = ssd_wgmma_y_kernel<T, NT>;
  auto sk = ssd_wgmma_state_kernel<T, NT>;
  cudaError_t e = hopper::allow_smem(yk, ys);
  if (e == cudaSuccess) e = hopper::allow_smem(sk, ss);
  if (e != cudaSuccess) return (int)e;
  sk<<<G, kTcThreads, ss, stream>>>((const T*)x, (const T*)dt, (const T*)A, (const T*)B,
                                    (float*)st, (float*)cd, (float*)sd, Q, P, N, nL);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  yk<<<(nL + 1) / 2 * G, kYThreads, ys, stream>>>((const T*)x, (const T*)dt, (const T*)A,
                                                  (const T*)B, (const T*)C, (float*)y, Q, P, N,
                                                  nL);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wgmma_n(const void* x, const void* dt, const void* A, const void* B, const void* C,
                   void* y, void* st, void* cd, void* sd, int G, int Q, int P, int N,
                   cudaStream_t stream) {
  if (P % 16 != 0 || N % 16 != 0 || P > 64 || N > 128 || Q > 512)
    return (int)cudaErrorInvalidValue;
  if (N <= 64) return launch_wgmma<T, 64>(x, dt, A, B, C, y, st, cd, sd, G, Q, P, N, stream);
  return launch_wgmma<T, 128>(x, dt, A, B, C, y, st, cd, sd, G, Q, P, N, stream);
}

}  // namespace

// x: (G, Q, P); dt: (G, Q); A: (G,); B, C: (G, Q, N), one dtype (0 fp32,
// 1 bf16, 2 fp16), contiguous.  Outputs fp32: y (G, Q, P), states (G, P, N),
// chunk_decay (G,), state_decay (G, Q).  route 0 = "simt", 1 = "wgmma"
// (P and N multiples of 16, P <= 64, N <= 128, Q <= 512, 16-byte-aligned
// bases).
// Returns the cudaError_t of the launch.
extern "C" int rt_ssd_chunk(const void* x, const void* dt, const void* A, const void* B,
                            const void* C, void* y, void* st, void* cd, void* sd, int dtype, int G,
                            int Q, int P, int N, int route, void* stream) {
  if (G == 0) return 0;
  if (Q <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    switch (dtype) {
      case 0:
        return launch_wgmma_n<float>(x, dt, A, B, C, y, st, cd, sd, G, Q, P, N, s);
      case 1:
        return launch_wgmma_n<__nv_bfloat16>(x, dt, A, B, C, y, st, cd, sd, G, Q, P, N, s);
      case 2:
        return launch_wgmma_n<__half>(x, dt, A, B, C, y, st, cd, sd, G, Q, P, N, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<float>(x, dt, A, B, C, y, st, cd, sd, G, Q, P, N, s);
    case 1:
      return launch<__nv_bfloat16>(x, dt, A, B, C, y, st, cd, sd, G, Q, P, N, s);
    case 2:
      return launch<__half>(x, dt, A, B, C, y, st, cd, sd, G, Q, P, N, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
