// The Mamba-2 SSD intra-chunk computation's backward, for sm_90a.
//
// Replaces no TPU kernel: the Pallas kernel src/repro/kernels/ssd_scan.py:
// ssd_chunk (def :56, pl.pallas_call :70) has no custom_vjp, and the JAX
// model differentiates its own einsums (src/repro/models/mamba2.py:
// ssd_chunked).  This is the gradient of the port's forward kernel
// (ssd_scan.cu), so that a training step on the card builds no (G, Q, Q)
// fp32 temporaries.  Per chunk g, with a = dt A, c = cumsum(a), L[l, s] =
// exp(c_l - c_s) for l >= s (else 0), CB = C B^T, M = CB o L, u = dt o x
// and w_s = exp(c_last - c_s) dt_s, and the cotangents gy (Q, P), gst (P,
// N), gcd, gsd (Q) of y_diag, states, chunk_decay, state_decay:
//     gM = (gy u^T) o mask;  G2 = gM o L;  gu = M^T gy
//     gC = G2 B;  gB = G2^T C + diag(w) x gst;  gx = dt o gu + diag(w) B gst^T
//     gw_s = sum_p x[s, p] (B gst^T)[s, p]
//     gc = rowsum(G2 o CB) - colsum(G2 o CB) - gw o w + gsd o exp(c),
//          plus sum(gw o w) + gcd exp(c_last) at the last step
//     ga = reverse cumsum(gc);  gdt = sum_p x o gu + gw exp(c_last - c) + A ga
//     gA = sum ga o dt
// all in fp32: the inputs, the cotangents and the gradients (the wrapper
// widens 16-bit inputs first: no path of the models gives the SSD any).
//
// What bounds it, at mamba2-780m's training shape (G 1536, Q 256, P 64, N
// 128, fp32): its bytes (x, B, C and the cotangents in, the five gradients
// out: 0.76 MB a chunk, 1.16 GB a call, `roofline.ssd_bwd_work`) at 3.35
// TB/s, 0.347 ms; its products, counted once, are 2 Q (Q + 1) / 2 (3 N + 2
// P) + 4 Q P N FLOPs a chunk, 0.065 TFLOP a call.  The tensor-core route
// below issues six part products for each and recomputes C B^T and gy u^T
// in both of its tile passes, about 0.5 PFLOP of bf16 products a call, 0.5
// ms at the 989 TFLOP/s of bf16 tensor cores.  On the H100 the products
// took half of its time at that shape (read by building it without them);
// the other half is the work around them in one block an SM (its 199 KB of
// shared memory allow no second): the chunk's cumsum and the strip's split
// at each block's start, the split of each streamed tile, the sums'
// exchange at its end.
//
// Deterministic, with no atomics: three kernels, each output written once.
//   * "l": one block per (64-row strip i of l, chunk), the last strips (the
//     longest) first.  For each tile j <= i of s: CB and gM of the (i, j)
//     tile (recomputed), G2, the row sums of G2 o CB, and gC_i += G2 B_j.
//     Writes gC and the row sums.
//   * "s": one block per (strip j of s, chunk), strip 0 first.  For each
//     tile i >= j: CB^T and gM^T, G2^T and M^T, the column sums, gB_j +=
//     G2^T C_i and gu_j += M^T gy_i; then the state's terms (B gst^T, x
//     gst).  Writes gx, gB and per step the column sums, gw and sum_p x o gu.
//   * "fin": one block per chunk: the O(Q) rest (gc, the reverse cumsum,
//     gdt, gA), from those per-step sums.
// A missing cotangent is a flag: "l" does not run without gy, "s" without
// gy and gst, and their terms are left out.  Every sum runs in a fixed
// order.
//
// Two routes, chosen by the caller (kernels/ssd_scan.py: ssd_bwd_route) from
// dtype, widths and alignment before the launch, as the forward's:
//
// "wgmma" (P and N multiples of 16, P <= 64, N <= 128, Q <= 512, 16-byte
// aligned bases), on the forward's "wgmma" parts (ssd_wgmma.cuh).  fp32
// accuracy as the forward gets it: every operand, the inputs and the fp32
// intermediates (G2, M, w o x) alike, enters as three bf16 parts, hi =
// bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid); a product sums the
// six leading part products, each 16-deep slice summed alone by the tensor
// cores and added to its accumulator in fp32 (their own fp32 sum
// truncates).  u = dt o x is taken as x with dt applied to the product.
// What bound the warp-level mma.sync route it replaces (11 % of its bytes
// bound): each streamed tile copied and split synchronously (two barriers a
// tile, no copy under the products), every warp reloading the other tile's
// fragments for its own 16 rows, and one block an SM with nothing to hide
// the loads.  Here a block of two warpgroups takes one 64-row strip: its
// fixed tiles (C_i and gy_i in "l", B_j and x_j in "s") are split once into
// 128-byte-swizzled planes, and the streamed tile pair's fp32 rows are
// copied by cp.async under the current tile's products, then split by all
// threads.  Warpgroup h computes the 64 x 32 half of each score tile at
// columns 32 h .. 32 h + 31 (wgmma m64n32, both operands K-major) and the
// accumulating products over those 32 steps (A from the split fragments in
// registers, B read N-major): both warpgroups issue the same products, and
// each holds one 64 x NT accumulator (and in "s" the 64 x 64 gu) over half
// the steps.  The halves are added in shared memory at the end, warpgroup
// 0's first.  A whole strip per warpgroup, as the forward's y kernel runs
// it, would need both strips' fixed tiles and the streamed pair's planes
// and staging, 266 KB at N 128.  In "s", gst's rows are staged under the
// last tile's products and split into C_i's planes.  The elementwise work
// (G2, M) takes exp of every element, of values clamped into the chunk, and
// the mask by a select: a condition around the exp made a branch of every
// element.  c = cumsum(dt A) is kept in fp64 (chunk_c).
//
// "simt" (other widths, Q past 512, layouts 16-byte loads cannot read):
// fp32 on the CUDA cores, the same three kernels on 32-row tiles, 256
// threads, every accumulator in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ssd_wgmma.cuh"

namespace {

using namespace ssd_wgmma;

// In-place inclusive scan of v[0, Q) (reverse: from the end) by warp 0 of
// the block, added in fp64 and rounded to F once per value: lane t adds its
// ceil(Q / 32) consecutive values in order, the lanes' totals are scanned by
// shuffles, and each lane adds the totals before it.  Every thread of the
// block must reach the barriers around it.
template <typename F>
__device__ __forceinline__ void warp_scan(F* v, int Q, bool reverse) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x, K = (Q + 31) / 32;
  auto at = [&](int i) -> F& { return v[reverse ? Q - 1 - i : i]; };
  double run = 0.0;
  for (int k = 0; k < K; ++k) {
    const int i = lane * K + k;
    if (i < Q) run += at(i);
  }
  double inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double up = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += up;
  }
  run = inc - run;  // the totals of the lanes before
  for (int k = 0; k < K; ++k) {
    const int i = lane * K + k;
    if (i < Q) {
      run += at(i);
      at(i) = (F)run;
    }
  }
}

// dt of chunk g into dts[0, Q) and c = cumsum(dt A) into c[0, Q) (C:
// float on the "simt" route; double on the "wgmma" route and in the
// finishing kernel, where each dt A is exact and c is rounded once, so that
// exp(c_l - c_s) is taken of an exact difference: |c| reaches a few hundred
// in a chunk, where fp32 holds it to 1.5e-5, which moved the gradients by
// twice the fp32 plain version's own error); ends with a barrier.
template <typename C>
__device__ __forceinline__ void chunk_c(const float* __restrict__ dt, float a, float* dts, C* c,
                                        int Q) {
  for (int i = threadIdx.x; i < Q; i += blockDim.x) {
    dts[i] = dt[i];
    c[i] = (C)dts[i] * (C)a;
  }
  __syncthreads();
  warp_scan(c, Q, false);
  __syncthreads();
}

// L[l, s] = exp(c_l - c_s) where s <= l < Q, else 0 (the exp only there:
// above the diagonal it may overflow)
__device__ __forceinline__ float decay(const float* c, int l, int s, int Q) {
  return (s <= l && l < Q) ? expf(c[l] - c[s]) : 0.f;
}

// ---- the finishing kernel, both routes -----------------------------------

// One block of 32 threads per chunk g: gc, ga, gdt and gA from the per-step
// sums of "l" (rs: row sums of G2 o CB; with has_l) and "s" (cs: column
// sums, gw, xgu: sum_p x o gu; with has_s).
__global__ void __launch_bounds__(32)
    ssd_bwd_fin_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                       const float* __restrict__ rs, const float* __restrict__ cs,
                       const float* __restrict__ gw, const float* __restrict__ xgu,
                       const float* __restrict__ gcd, const float* __restrict__ gsd,
                       float* __restrict__ gdt, float* __restrict__ gA, int Q, int has_l,
                       int has_s) {
  extern __shared__ double fsm[];
  double* c = fsm;
  float* dts = reinterpret_cast<float*>(c + Q);
  float* gc = dts + Q;
  const int g = blockIdx.x, lane = threadIdx.x;
  const size_t gq = (size_t)g * Q;
  const float a = A[g];
  chunk_c(dt + gq, a, dts, c, Q);
  const double last = c[Q - 1];
  float tot = 0.f;  // sum of gw o w
  for (int s = lane; s < Q; s += 32) {
    float v = 0.f;
    if (has_l) v += rs[gq + s];
    if (has_s) {
      const float w = expf((float)(last - c[s])) * dts[s];
      v -= cs[gq + s] + gw[gq + s] * w;
      tot += gw[gq + s] * w;
    }
    if (gsd != nullptr) v += gsd[gq + s] * (float)exp(c[s]);
    gc[s] = v;
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, m);
  __syncwarp();
  if (lane == 0) gc[Q - 1] += tot + (gcd != nullptr ? gcd[g] * (float)exp(last) : 0.f);
  __syncwarp();
  warp_scan(gc, Q, true);  // ga
  __syncwarp();
  float ga_dt = 0.f;
  for (int s = lane; s < Q; s += 32) {
    float v = a * gc[s];
    if (has_s) v += xgu[gq + s] + gw[gq + s] * expf((float)(last - c[s]));
    gdt[gq + s] = v;
    ga_dt += gc[s] * dts[s];
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) ga_dt += __shfl_xor_sync(0xffffffffu, ga_dt, m);
  if (lane == 0) gA[g] = ga_dt;
}

// ---- the "simt" route ----------------------------------------------------

constexpr int kSThreads = 256;
constexpr int kST = 32;       // rows of a tile
constexpr int kSP = kST + 1;  // padded row stride of the (32 x 32) tiles

// rows [r0, r0 + 32) of the (Q, W) tensor at src into dst [32][W + 1] as
// fp32, zeros past Q
__device__ __forceinline__ void simt_load(const float* __restrict__ src, int r0, int Q, int W,
                                          float* dst) {
  for (int idx = threadIdx.x; idx < kST * W; idx += kSThreads) {
    const int r = idx / W, col = idx % W;
    dst[r * (W + 1) + col] = r0 + r < Q ? src[(size_t)(r0 + r) * W + col] : 0.f;
  }
}

__host__ __device__ inline size_t simt_l_smem(int Q, int P, int N) {
  return sizeof(float) * (2 * (size_t)kST * (N + 1) + 2 * (size_t)kST * (P + 1) +
                          (size_t)kST * kSP + (size_t)kST * N + kST + 2 * (size_t)Q);
}
__host__ __device__ inline size_t simt_s_smem(int Q, int P, int N) {
  return sizeof(float) * (2 * (size_t)kST * (N + 1) + 2 * (size_t)kST * (P + 1) +
                          2 * (size_t)kST * kSP + (size_t)kST * (N + P) + 3 * kST +
                          2 * (size_t)Q);
}

// "l" on the CUDA cores: grid (ceil(Q / 32), G).
__global__ void __launch_bounds__(kSThreads)
    ssd_bwd_l_simt(const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                   const float* __restrict__ Bm, const float* __restrict__ Cm,
                   const float* __restrict__ gy, float* __restrict__ gC,
                   float* __restrict__ rs, int Q, int P, int N) {
  extern __shared__ float sm[];
  float* cs = sm;                     // [32][N + 1] C rows of tile i
  float* bs = cs + kST * (N + 1);     // [32][N + 1] B rows of tile j
  float* gys = bs + kST * (N + 1);    // [32][P + 1]
  float* xs = gys + kST * (P + 1);    // [32][P + 1]
  float* g2 = xs + kST * (P + 1);     // [32][kSP] G2 of the (i, j) tile
  float* acc = g2 + kST * kSP;        // [32][N] gC of tile i
  float* rsum = acc + kST * N;        // [32]
  float* dts = rsum + kST;
  float* c = dts + Q;
  const int g = blockIdx.y, l0 = blockIdx.x * kST, tid = threadIdx.x;
  const size_t gq = (size_t)g * Q;
  chunk_c(dt + gq, A[g], dts, c, Q);
  simt_load(Cm + gq * N, l0, Q, N, cs);
  simt_load(gy + gq * P, l0, Q, P, gys);
  for (int idx = tid; idx < kST * N; idx += kSThreads) acc[idx] = 0.f;
  if (tid < kST) rsum[tid] = 0.f;
  for (int s0 = 0; s0 <= l0; s0 += kST) {
    __syncthreads();  // the last tile is done with bs, xs and g2
    simt_load(Bm + gq * N, s0, Q, N, bs);
    simt_load(x + gq * P, s0, Q, P, xs);
    __syncthreads();
    for (int e = tid; e < kST * kST; e += kSThreads) {  // a warp takes one row l
      const int l = e / kST, s = e % kST;
      float v = 0.f, ev = 0.f;
      const float L = decay(c, l0 + l, s0 + s, Q);
      if (L != 0.f && s0 + s < Q) {
        float cb = 0.f, gm = 0.f;
        for (int n = 0; n < N; ++n) cb = fmaf(cs[l * (N + 1) + n], bs[s * (N + 1) + n], cb);
        for (int p = 0; p < P; ++p) gm = fmaf(gys[l * (P + 1) + p], xs[s * (P + 1) + p], gm);
        v = gm * dts[s0 + s] * L;
        ev = v * cb;
      }
      g2[l * kSP + s] = v;
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) ev += __shfl_xor_sync(0xffffffffu, ev, m);
      if (s == 0) rsum[l] += ev;
    }
    __syncthreads();
    for (int idx = tid; idx < kST * N; idx += kSThreads) {
      const int l = idx / N, n = idx % N;
      float a = acc[idx];
#pragma unroll 8
      for (int s = 0; s < kST; ++s) a = fmaf(g2[l * kSP + s], bs[s * (N + 1) + n], a);
      acc[idx] = a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kST * N; idx += kSThreads) {
    const int l = idx / N;
    if (l0 + l < Q) gC[(gq + l0) * N + idx] = acc[idx];
  }
  if (tid < kST && l0 + tid < Q) rs[gq + l0 + tid] = rsum[tid];
}

// "s" on the CUDA cores: grid (ceil(Q / 32), G).
__global__ void __launch_bounds__(kSThreads)
    ssd_bwd_s_simt(const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                   const float* __restrict__ Bm, const float* __restrict__ Cm,
                   const float* __restrict__ gy, const float* __restrict__ gst,
                   float* __restrict__ gx, float* __restrict__ gB, float* __restrict__ csum,
                   float* __restrict__ gw, float* __restrict__ xgu, int Q, int P, int N) {
  extern __shared__ float sm[];
  float* bs = sm;                     // [32][N + 1] B rows of tile j
  float* cs = bs + kST * (N + 1);     // [32][N + 1] C rows of tile i
  float* xs = cs + kST * (N + 1);     // [32][P + 1]
  float* gys = xs + kST * (P + 1);    // [32][P + 1]
  float* g2 = gys + kST * (P + 1);    // [32][kSP] G2^T of the (i, j) tile
  float* mt = g2 + kST * kSP;         // [32][kSP] M^T
  float* accb = mt + kST * kSP;       // [32][N] gB of tile j
  float* accu = accb + kST * N;       // [32][P] gu
  float* colsum = accu + kST * P;     // [32]
  float* gws = colsum + kST;          // [32]
  float* xgus = gws + kST;            // [32]
  float* dts = xgus + kST;
  float* c = dts + Q;
  const int g = blockIdx.y, s0 = blockIdx.x * kST, tid = threadIdx.x;
  const size_t gq = (size_t)g * Q;
  chunk_c(dt + gq, A[g], dts, c, Q);
  const float last = c[Q - 1];
  simt_load(Bm + gq * N, s0, Q, N, bs);
  simt_load(x + gq * P, s0, Q, P, xs);
  for (int idx = tid; idx < kST * N; idx += kSThreads) accb[idx] = 0.f;
  for (int idx = tid; idx < kST * P; idx += kSThreads) accu[idx] = 0.f;
  if (tid < kST) colsum[tid] = gws[tid] = xgus[tid] = 0.f;
  if (gy != nullptr) {
    for (int l0 = s0; l0 < Q; l0 += kST) {
      __syncthreads();  // the last tile is done with cs, gys, g2 and mt
      simt_load(Cm + gq * N, l0, Q, N, cs);
      simt_load(gy + gq * P, l0, Q, P, gys);
      __syncthreads();
      for (int e = tid; e < kST * kST; e += kSThreads) {  // a warp takes one row s
        const int s = e / kST, l = e % kST;
        float gv = 0.f, mv = 0.f, ev = 0.f;
        const float L = s0 + s < Q ? decay(c, l0 + l, s0 + s, Q) : 0.f;
        if (L != 0.f) {
          float cb = 0.f, gm = 0.f;
          for (int n = 0; n < N; ++n) cb = fmaf(bs[s * (N + 1) + n], cs[l * (N + 1) + n], cb);
          for (int p = 0; p < P; ++p) gm = fmaf(xs[s * (P + 1) + p], gys[l * (P + 1) + p], gm);
          gv = gm * dts[s0 + s] * L;
          mv = cb * L;
          ev = gv * cb;
        }
        g2[s * kSP + l] = gv;
        mt[s * kSP + l] = mv;
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) ev += __shfl_xor_sync(0xffffffffu, ev, m);
        if (l == 0) colsum[s] += ev;
      }
      __syncthreads();
      for (int idx = tid; idx < kST * N; idx += kSThreads) {
        const int s = idx / N, n = idx % N;
        float a = accb[idx];
#pragma unroll 8
        for (int l = 0; l < kST; ++l) a = fmaf(g2[s * kSP + l], cs[l * (N + 1) + n], a);
        accb[idx] = a;
      }
      for (int idx = tid; idx < kST * P; idx += kSThreads) {
        const int s = idx / P, p = idx % P;
        float a = accu[idx];
#pragma unroll 8
        for (int l = 0; l < kST; ++l) a = fmaf(mt[s * kSP + l], gys[l * (P + 1) + p], a);
        accu[idx] = a;
      }
    }
  }
  __syncthreads();
  // gx = dt o gu + w (B gst^T); gw = sum_p x (B gst^T); xgu = sum_p x gu.
  // A warp takes one row s at a time, its lanes the columns.
  const int warp = tid / 32, lane = tid % 32;
  for (int s = warp; s < kST; s += kSThreads / 32) {
    const int sg = s0 + s;
    if (sg >= Q) break;
    const float w = expf(last - c[sg]) * dts[sg];
    float gws_ = 0.f, xgu_ = 0.f;
    for (int p = lane; p < P; p += 32) {
      const float xv = xs[s * (P + 1) + p], gu = accu[s * P + p];
      float bg = 0.f;
      if (gst != nullptr) {
        const float* gp = gst + ((size_t)g * P + p) * N;
        for (int n = 0; n < N; ++n) bg = fmaf(bs[s * (N + 1) + n], gp[n], bg);
      }
      gx[(gq + sg) * P + p] = dts[sg] * gu + w * bg;
      gws_ = fmaf(xv, bg, gws_);
      xgu_ = fmaf(xv, gu, xgu_);
    }
    for (int n = lane; n < N; n += 32) {
      float xg = 0.f;
      if (gst != nullptr)
        for (int p = 0; p < P; ++p)
          xg = fmaf(xs[s * (P + 1) + p], gst[((size_t)g * P + p) * N + n], xg);
      gB[(gq + sg) * N + n] = accb[s * N + n] + w * xg;
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      gws_ += __shfl_xor_sync(0xffffffffu, gws_, m);
      xgu_ += __shfl_xor_sync(0xffffffffu, xgu_, m);
    }
    if (lane == 0) {
      csum[gq + sg] = colsum[s];
      gw[gq + sg] = gws_;
      xgu[gq + sg] = xgu_;
    }
  }
}

// ---- the "wgmma" route ---------------------------------------------------
//
// Tiles as the forward's (ssd_wgmma.cuh): 64 rows of NT (N rounded up to
// 64 or 128) or 64 bf16 columns in the 128-byte swizzle, three planes (hi,
// mid, lo) each, written by threads.

constexpr int kWgThreads = 256;  // two warpgroups a block

// Shared memory of the l and s kernels: the block's fixed strip (an NT- and
// a 64-wide tile of three planes), the streamed tile pair (the same), their
// fp32 staging areas, dt (Qp floats) and c (Qp doubles), and 1024 bytes for
// the alignment.
template <int NT>
constexpr size_t wg_smem(int Qp) {
  return 2 * (3 * (size_t)tile_bytes<NT>() + 3 * (size_t)tile_bytes<64>()) +
         stage_bytes<float, NT>() + stage_bytes<float, 64>() +
         (size_t)Qp * (sizeof(float) + sizeof(double)) +
         1024;
}

// X (64 x K, three planes at xa) Y^T over K = 16 KS, on rows 32 h .. 32 h +
// 31 of Y (three planes at ya), both K-major, WX and WY their tiles' plane
// bytes: each 16-deep slice of the six part products summed by the tensor
// cores, the slices added in fp32 (slices, ssd_wgmma.cuh).
template <int KS, int WX, int WY>
__device__ __forceinline__ void xyt_half(float (&d)[16], uint32_t xa, uint32_t ya, int h) {
  slices<KS>(d, [&](float(&acc)[16], int kk, bool add) {
    const uint32_t off = (kk / 4) * kTcAtom + (kk % 4) * 32;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int q = pair_order(i);
      hopper::wgmma_ss<32, false, 0>(acc, hopper::smem_desc(xa + pair_a(q) * WX + off, 16, 1024),
                                     hopper::smem_desc(ya + pair_b(q) * WY + off + h * 4096, 16,
                                                       1024),
                                     add || i > 0);
    }
  }, true);
}

// acc (64 x W) += A (64 x 32, split fragments a) Y[32 h .. 32 h + 31], Y a
// tile of three planes at ya (plane bytes WY) read N-major, slice by slice.
template <int W, int WY>
__device__ __forceinline__ void ay_half(float (&acc)[W / 2], const uint32_t (&a)[3][2][4],
                                        uint32_t ya, int h) {
  slices<2>(acc, [&](float(&d)[W / 2], int kk, bool add) {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int q = pair_order(i);
      hopper::wgmma_rs<W, false, 1>(
          d, a[pair_a(q)][kk],
          hopper::smem_desc(ya + pair_b(q) * WY + (2 * h + kk) * 2048, kTcAtom, 1024),
          add || i > 0);
    }
  }, false);
}

// The split A fragments (three parts of two k16 fragments) of a 64 x 32
// accumulator.
__device__ __forceinline__ void frags3(const float (&v)[16], uint32_t (&a)[3][2][4]) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = jj / 2, i = 2 * (jj % 2) + r;
      split3(v[4 * jj + 2 * r], v[4 * jj + 2 * r + 1], a[0][k][i], a[1][k][i], a[2][k][i]);
    }
}

// "l" on the tensor cores: grid (ceil(Q / 64), G), the longest strips (the
// last) first.  The block's strip i of l: C_i and gy_i split once; tile j
// <= i of s streamed (B_j, x_j: cp.async of the next tile's fp32 rows under
// this tile's products, split by all threads at the next step).  Warpgroup
// h takes columns 32 h .. 32 h + 31 of each (i, j) tile: CB = C_i B_j^T
// and gM = gy_i x_j^T there, G2 = gM dt L, the row sums of G2 o CB, and gC_i
// += G2 B_j over those 32 steps of s.  The two warpgroups' gC and row sums
// are added at the end through shared memory, warpgroup 0's first.
template <int NT>
__global__ void __launch_bounds__(kWgThreads, 1)
    ssd_bwd_l_wgmma(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ gy,
                    float* __restrict__ gC, float* __restrict__ rs, int Q, int P, int N) {
  constexpr int kNT = tile_bytes<NT>(), kXT = tile_bytes<64>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align_1024(smem_raw);
  uint8_t* cs = sm;              // C_i, three planes
  uint8_t* gys = cs + 3 * kNT;   // gy_i
  uint8_t* bs = gys + 3 * kXT;   // B_j
  uint8_t* xs = bs + 3 * kNT;    // x_j
  uint8_t* bst = xs + 3 * kXT;   // B_j + 1, x_j + 1 staged as fp32 rows
  uint8_t* xst = bst + stage_bytes<float, NT>();
  const int nT = (Q + kTcRows - 1) / kTcRows;
  float* dts = reinterpret_cast<float*>(xst + stage_bytes<float, 64>());
  double* c = reinterpret_cast<double*>(dts + nT * kTcRows);
  const int g = blockIdx.y, i = nT - 1 - (int)blockIdx.x, l0 = kTcRows * i;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = __shfl_sync(0xffffffffu, warp / 4, 0);  // uniform, as the compiler sees it
  const int tid = threadIdx.x % 128;
  const int row0 = 16 * (warp % 4) + lane / 4, col0 = 2 * (lane % 4);
  const size_t gq = (size_t)g * Q;
  const float* bg = Bm + gq * N;
  const float* xg = x + gq * P;
  // tile 0's copies run under the cumsum and the strip's split
  stage_tile<float, NT, kWgThreads>(bg, 0, Q, N, bst);
  stage_tile<float, 64, kWgThreads>(xg, 0, Q, P, xst);
  hopper::cp_async_commit();
  chunk_c(dt + gq, A[g], dts, c, Q);
  load_tile<float, NT, kWgThreads>(Cm + gq * N, l0, Q, N, cs, threadIdx.x);
  load_tile<float, 64, kWgThreads>(gy + gq * P, l0, Q, P, gys, threadIdx.x);
  float acc[NT / 2];
#pragma unroll
  for (int e = 0; e < NT / 2; ++e) acc[e] = 0.f;
  float rsum[2] = {0.f, 0.f};
  double cl[2];
  int lr[2];  // this thread's rows l0 + row0 (+ 8) and their c
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lr[r] = l0 + row0 + 8 * r;
    cl[r] = c[min(lr[r], Q - 1)];
  }
  const uint32_t ca = hopper::smem_u32(cs), ga = hopper::smem_u32(gys);
  const uint32_t ba = hopper::smem_u32(bs), xa = hopper::smem_u32(xs);
  for (int j = 0; j <= i; ++j) {
    const int s0 = kTcRows * j;
    hopper::cp_async_wait_all();
    __syncthreads();  // tile j is staged; the last tile's products are done
    convert_tile<float, NT, kWgThreads>(bst, bs);
    convert_tile<float, 64, kWgThreads>(xst, xs);
    hopper::fence_proxy_async();
    __syncthreads();
    if (j < i) {  // tile j + 1's copies run under this tile's products
      stage_tile<float, NT, kWgThreads>(bg, s0 + kTcRows, Q, N, bst);
      stage_tile<float, 64, kWgThreads>(xg, s0 + kTcRows, Q, P, xst);
      hopper::cp_async_commit();
    }
    float cb[16], gm[16];
    xyt_half<NT / 16, kNT, kNT>(cb, ca, ba, h);  // C_i B_j^T
    xyt_half<4, kXT, kXT>(gm, ga, xa, h);        // gy_i x_j^T
    // G2 = gM dt L on the fragments: the exp is taken for every element (of
    // values clamped into the chunk) and the mask applied by a select, as a
    // condition around it made a branch of every element
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int cx = 0; cx < 2; ++cx) {
        const int sg = s0 + 32 * h + 8 * jj + col0 + cx, sq = min(sg, Q - 1);
        const double cs_ = c[sq];
        const float dt_ = dts[sq];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 4 * jj + 2 * r + cx;
          const float v = gm[e] * dt_ * expf((float)(cl[r] - cs_));
          const float g2 = sg <= lr[r] && lr[r] < Q ? v : 0.f;
          rsum[r] += g2 * cb[e];
          gm[e] = g2;
        }
      }
    uint32_t af[3][2][4];
    frags3(gm, af);
    ay_half<NT, kNT>(acc, af, ba, h);  // gC_i += G2 B_j over this warpgroup's steps
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
    rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
  }
  __syncthreads();  // done with the streamed tiles: warpgroup 1's sums go there
  float* part = reinterpret_cast<float*>(bs);  // [NT / 2][128] gC, [2][128] row sums
  if (h == 1) {
#pragma unroll
    for (int e = 0; e < NT / 2; ++e) part[e * 128 + tid] = acc[e];
    part[(NT / 2) * 128 + tid] = rsum[0];
    part[(NT / 2 + 1) * 128 + tid] = rsum[1];
  }
  __syncthreads();
  if (h == 1) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int l = l0 + row0 + 8 * r;
    if (l >= Q) continue;
    if (lane % 4 == 0) rs[gq + l] = rsum[r] + part[(NT / 2 + r) * 128 + tid];
#pragma unroll
    for (int jj = 0; jj < NT / 8; ++jj) {
      const int n = 8 * jj + col0, e = 4 * jj + 2 * r;
      if (n < N)
        *reinterpret_cast<float2*>(gC + (gq + l) * N + n) =
            make_float2(acc[e] + part[e * 128 + tid], acc[e + 1] + part[(e + 1) * 128 + tid]);
    }
  }
}

// "s" on the tensor cores: grid (ceil(Q / 64), G), strip 0 (the longest)
// first.  The block's strip j of s: B_j and x_j split once; tile i >= j of
// l streamed (C_i, gy_i), as in "l", and then gst (its P rows in the place
// of C_i), staged under the last tile's products.  Warpgroup h takes
// columns 32 h .. 32 h + 31 of each (j, i) tile: CB^T = B_j C_i^T and gM^T =
// x_j gy_i^T there, G2^T and M^T = CB^T o L, the column sums, gu_j += M^T
// gy_i and gB_j += G2^T C_i over those 32 steps of l.  Then the state's
// terms on the same split, over 32 values of p each: bg = B_j gst^T and gB_j
// += (w o x_j) gst.  The two warpgroups' sums are added through shared
// memory, warpgroup 0's first, and warpgroup 0 writes.
template <int NT>
__global__ void __launch_bounds__(kWgThreads, 1)
    ssd_bwd_s_wgmma(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ gy,
                    const float* __restrict__ gst, float* __restrict__ gx,
                    float* __restrict__ gB, float* __restrict__ csum, float* __restrict__ gw,
                    float* __restrict__ xgu, int Q, int P, int N) {
  constexpr int kNT = tile_bytes<NT>(), kXT = tile_bytes<64>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align_1024(smem_raw);
  uint8_t* bs = sm;              // B_j, three planes
  uint8_t* xs = bs + 3 * kNT;    // x_j
  uint8_t* cs = xs + 3 * kXT;    // C_i, then gst, then the partial sums
  uint8_t* gys = cs + 3 * kNT;   // gy_i
  uint8_t* cst = gys + 3 * kXT;  // C_i + 1, gy_i + 1 (or gst) staged as fp32 rows
  uint8_t* gyst = cst + stage_bytes<float, NT>();
  const int nT = (Q + kTcRows - 1) / kTcRows;
  float* dts = reinterpret_cast<float*>(gyst + stage_bytes<float, 64>());
  double* c = reinterpret_cast<double*>(dts + nT * kTcRows);
  const int g = blockIdx.y, j = blockIdx.x, s0 = kTcRows * j;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = __shfl_sync(0xffffffffu, warp / 4, 0);  // uniform, as the compiler sees it
  const int tid = threadIdx.x % 128;
  const int row0 = 16 * (warp % 4) + lane / 4, col0 = 2 * (lane % 4);
  const size_t gq = (size_t)g * Q;
  const float* cg = Cm + gq * N;
  const float* gyg = gy + gq * P;
  const float* gsg = gst + (size_t)g * P * N;
  // the first streamed tile's copies (or gst's) run under the cumsum and
  // the strip's split
  if (gy != nullptr) {
    stage_tile<float, NT, kWgThreads>(cg, s0, Q, N, cst);
    stage_tile<float, 64, kWgThreads>(gyg, s0, Q, P, gyst);
  } else if (gst != nullptr) {
    stage_tile<float, NT, kWgThreads>(gsg, 0, P, N, cst);
  }
  hopper::cp_async_commit();
  chunk_c(dt + gq, A[g], dts, c, Q);
  const float* xg = x + gq * P;
  load_tile<float, NT, kWgThreads>(Bm + gq * N, s0, Q, N, bs, threadIdx.x);
  load_tile<float, 64, kWgThreads>(xg, s0, Q, P, xs, threadIdx.x);
  float accb[NT / 2], accu[32];
#pragma unroll
  for (int e = 0; e < NT / 2; ++e) accb[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) accu[e] = 0.f;
  float colsum[2] = {0.f, 0.f}, dtr[2], w[2];
  double cs_[2];
  int sr[2];
  const double last = c[Q - 1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // this thread's rows s0 + row0 (+ 8)
    const int sg = s0 + row0 + 8 * r;
    sr[r] = sg;
    cs_[r] = c[min(sg, Q - 1)];
    dtr[r] = sg < Q ? dts[sg] : 0.f;
    w[r] = sg < Q ? expf((float)(last - c[sg])) * dtr[r] : 0.f;
  }
  const uint32_t ba = hopper::smem_u32(bs), xa = hopper::smem_u32(xs);
  const uint32_t ca = hopper::smem_u32(cs), ga = hopper::smem_u32(gys);
  for (int i = gy != nullptr ? j : nT; i < nT; ++i) {
    const int l0 = kTcRows * i;
    hopper::cp_async_wait_all();
    __syncthreads();  // tile i is staged; the last tile's products are done
    convert_tile<float, NT, kWgThreads>(cst, cs);
    convert_tile<float, 64, kWgThreads>(gyst, gys);
    hopper::fence_proxy_async();
    __syncthreads();
    if (i + 1 < nT) {  // tile i + 1's copies (or gst's) run under this tile's products
      stage_tile<float, NT, kWgThreads>(cg, l0 + kTcRows, Q, N, cst);
      stage_tile<float, 64, kWgThreads>(gyg, l0 + kTcRows, Q, P, gyst);
      hopper::cp_async_commit();
    } else if (gst != nullptr) {
      stage_tile<float, NT, kWgThreads>(gsg, 0, P, N, cst);
      hopper::cp_async_commit();
    }
    float cb[16], gm[16];
    xyt_half<NT / 16, kNT, kNT>(cb, ba, ca, h);  // B_j C_i^T
    xyt_half<4, kXT, kXT>(gm, xa, ga, h);        // x_j gy_i^T
    // G2^T and M^T on the fragments, the exp for every element and the mask
    // by a select, as in "l"
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int cx = 0; cx < 2; ++cx) {
        const int l = l0 + 32 * h + 8 * jj + col0 + cx;
        const double cl = c[min(l, Q - 1)];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 4 * jj + 2 * r + cx;
          const float ex = expf((float)(cl - cs_[r]));
          const float L = sr[r] <= l && l < Q ? ex : 0.f;
          const float g2 = gm[e] * dtr[r] * L;
          colsum[r] += g2 * cb[e];
          gm[e] = g2;
          cb[e] *= L;
        }
      }
    // one set of split fragments live at a time
    uint32_t mf[3][2][4];
    frags3(cb, mf);
    ay_half<64, kXT>(accu, mf, ga, h);   // gu_j += M^T gy_i over this warpgroup's steps
    uint32_t af[3][2][4];
    frags3(gm, af);
    ay_half<NT, kNT>(accb, af, ca, h);   // gB_j += G2^T C_i
  }
  // the state's terms on this warpgroup's 32 values of p
  float bg[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) bg[e] = 0.f;
  if (gst != nullptr) {
    hopper::cp_async_wait_all();
    __syncthreads();  // gst is staged; the last tile's products are done
    convert_tile<float, NT, kWgThreads>(cst, cs);
    hopper::fence_proxy_async();
    __syncthreads();
    xyt_half<NT / 16, kNT, kNT>(bg, ba, ca, h);  // B_j gst^T
    // (w o x_j) as split A fragments: row row0 + 8 (m % 2), value p = 32 h
    // + 16 kk + 8 (m / 2) + col0 (+ 1)
    uint32_t wf[3][2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int sg = s0 + row0 + 8 * (m % 2);
        const int p = 32 * h + 16 * kk + 8 * (m / 2) + col0;
        float v0 = 0.f, v1 = 0.f;
        if (sg < Q && p < P) {
          v0 = w[m % 2] * xg[(size_t)sg * P + p];
          v1 = w[m % 2] * xg[(size_t)sg * P + p + 1];
        }
        split3(v0, v1, wf[0][kk][m], wf[1][kk][m], wf[2][kk][m]);
      }
    ay_half<NT, kNT>(accb, wf, ca, h);  // gB_j += (w o x_j) gst
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    colsum[r] += __shfl_xor_sync(0xffffffffu, colsum[r], 1);
    colsum[r] += __shfl_xor_sync(0xffffffffu, colsum[r], 2);
  }
  __syncthreads();  // done with gst and the streamed tiles: warpgroup 1's sums go there
  // [NT / 2][128] gB, [32][128] gu, [16][128] bg, [2][128] column sums
  float* pb = reinterpret_cast<float*>(cs);
  float* pu = pb + (NT / 2) * 128;
  float* pg = pu + 32 * 128;
  float* pc = pg + 16 * 128;
  if (h == 1) {
#pragma unroll
    for (int e = 0; e < NT / 2; ++e) pb[e * 128 + tid] = accb[e];
#pragma unroll
    for (int e = 0; e < 32; ++e) pu[e * 128 + tid] = accu[e];
#pragma unroll
    for (int e = 0; e < 16; ++e) pg[e * 128 + tid] = bg[e];
    pc[tid] = colsum[0];
    pc[128 + tid] = colsum[1];
  }
  __syncthreads();
  if (h == 1) return;
#pragma unroll
  for (int e = 0; e < NT / 2; ++e) accb[e] += pb[e * 128 + tid];
#pragma unroll
  for (int e = 0; e < 32; ++e) accu[e] += pu[e * 128 + tid];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int sg = s0 + row0 + 8 * r;
    const float cr = colsum[r] + pc[r * 128 + tid];
    float gws = 0.f, xgus = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int p = 8 * jj + col0, e = 4 * jj + 2 * r;
      // bg of p < 32 is this warpgroup's, of p >= 32 warpgroup 1's
      const float b0 = jj < 4 ? bg[e] : pg[(e - 16) * 128 + tid];
      const float b1 = jj < 4 ? bg[e + 1] : pg[(e - 15) * 128 + tid];
      if (sg < Q && p < P) {
        const float x0 = xg[(size_t)sg * P + p], x1 = xg[(size_t)sg * P + p + 1];
        const float u0 = accu[e], u1 = accu[e + 1];
        *reinterpret_cast<float2*>(gx + (gq + sg) * P + p) =
            make_float2(dtr[r] * u0 + w[r] * b0, dtr[r] * u1 + w[r] * b1);
        gws += x0 * b0 + x1 * b1;
        xgus += x0 * u0 + x1 * u1;
      }
    }
#pragma unroll
    for (int jj = 0; jj < NT / 8; ++jj) {
      const int n = 8 * jj + col0, e = 4 * jj + 2 * r;
      if (sg < Q && n < N)
        *reinterpret_cast<float2*>(gB + (gq + sg) * N + n) = make_float2(accb[e], accb[e + 1]);
    }
#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
      gws += __shfl_xor_sync(0xffffffffu, gws, m);
      xgus += __shfl_xor_sync(0xffffffffu, xgus, m);
    }
    if (sg < Q && lane % 4 == 0) {
      csum[gq + sg] = cr;
      gw[gq + sg] = gws;
      xgu[gq + sg] = xgus;
    }
  }
}

struct Args {
  const float *x, *dt, *A, *B, *C;
  const float *gy, *gst, *gcd, *gsd;
  float *gx, *gdt, *gA, *gB, *gC;
  float* scratch;  // 4 (G, Q) planes: rs, cs, gw, xgu
  int G, Q, P, N;
};

int finish(const Args& a, cudaStream_t st) {
  const size_t gqs = (size_t)a.G * a.Q;
  float* rs = a.scratch;
  const int has_s = a.gy != nullptr || a.gst != nullptr;
  ssd_bwd_fin_kernel<<<a.G, 32, (size_t)a.Q * (sizeof(double) + 2 * sizeof(float)), st>>>(
      a.dt, a.A, rs, rs + gqs, rs + 2 * gqs, rs + 3 * gqs, a.gcd, a.gsd,
      a.gdt, a.gA, a.Q, a.gy != nullptr, has_s);
  return (int)cudaGetLastError();
}

int launch_simt(const Args& a, cudaStream_t st) {
  const size_t gqs = (size_t)a.G * a.Q;
  float* rs = a.scratch;
  const dim3 grid((a.Q + kST - 1) / kST, a.G);
  cudaError_t e = cudaSuccess;
  if (a.gy != nullptr) {
    const size_t smem = simt_l_smem(a.Q, a.P, a.N);
    auto k = ssd_bwd_l_simt;
    e = hopper::allow_smem(k, smem);
    if (e != cudaSuccess) return (int)e;
    k<<<grid, kSThreads, smem, st>>>(a.x, a.dt, a.A,
                                     a.B, a.C, a.gy, a.gC, rs, a.Q, a.P,
                                     a.N);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (a.gy != nullptr || a.gst != nullptr) {
    const size_t smem = simt_s_smem(a.Q, a.P, a.N);
    auto k = ssd_bwd_s_simt;
    e = hopper::allow_smem(k, smem);
    if (e != cudaSuccess) return (int)e;
    k<<<grid, kSThreads, smem, st>>>(a.x, a.dt, a.A,
                                     a.B, a.C, a.gy, a.gst, a.gx, a.gB,
                                     rs + gqs, rs + 2 * gqs, rs + 3 * gqs, a.Q, a.P, a.N);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return finish(a, st);
}

template <int NT>
int launch_wgmma(const Args& a, cudaStream_t st) {
  const size_t gqs = (size_t)a.G * a.Q;
  float* rs = a.scratch;
  const int nT = (a.Q + kTcRows - 1) / kTcRows;
  const size_t smem = wg_smem<NT>(nT * kTcRows);
  const dim3 grid(nT, a.G);
  auto kl = ssd_bwd_l_wgmma<NT>;
  auto ks = ssd_bwd_s_wgmma<NT>;
  cudaError_t e = hopper::allow_smem(kl, smem);
  if (e == cudaSuccess) e = hopper::allow_smem(ks, smem);
  if (e != cudaSuccess) return (int)e;
  if (a.gy != nullptr) {
    kl<<<grid, kWgThreads, smem, st>>>(a.x, a.dt, a.A, a.B, a.C, a.gy, a.gC, rs, a.Q, a.P, a.N);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (a.gy != nullptr || a.gst != nullptr) {
    ks<<<grid, kWgThreads, smem, st>>>(a.x, a.dt, a.A, a.B, a.C, a.gy, a.gst, a.gx, a.gB,
                                       rs + gqs, rs + 2 * gqs, rs + 3 * gqs, a.Q, a.P, a.N);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return finish(a, st);
}

int run(const Args& a, int route, cudaStream_t st) {
  if (route == 0) return launch_simt(a, st);
  if (a.P % 16 != 0 || a.N % 16 != 0 || a.P > 64 || a.N > 128 || a.Q > 512)
    return (int)cudaErrorInvalidValue;
  if (a.N <= 64) return launch_wgmma<64>(a, st);
  return launch_wgmma<128>(a, st);
}

}  // namespace

// x: (G, Q, P); dt: (G, Q); A: (G,); B, C: (G, Q, N), fp32, contiguous.
// Cotangents fp32, each null when missing: gy (G, Q, P), gst (G, P, N), gcd
// (G,), gsd (G, Q).  Gradients fp32: gx, gdt, gA, gB, gC shaped as the
// inputs; gC is written only with gy, gx and gB only with gy or gst (the
// caller zeroes what is not written).  scratch: 4 G Q floats.  route 0 =
// "simt", 1 = "wgmma" (P and N multiples of 16, P <= 64, N <= 128, Q <= 512,
// 16-byte-aligned bases).  Returns the cudaError_t of the first launch
// that failed, else 0.
extern "C" int rt_ssd_chunk_bwd(const void* x, const void* dt, const void* A, const void* B,
                                const void* C, const void* gy, const void* gst, const void* gcd,
                                const void* gsd, void* gx, void* gdt, void* gA, void* gB,
                                void* gC, void* scratch, int G, int Q, int P, int N, int route,
                                void* stream) {
  if (G == 0) return 0;
  if (Q <= 0 || (route != 0 && route != 1)) return (int)cudaErrorInvalidValue;
  Args a{(const float*)x, (const float*)dt, (const float*)A, (const float*)B, (const float*)C,
         (const float*)gy, (const float*)gst, (const float*)gcd, (const float*)gsd, (float*)gx,
         (float*)gdt, (float*)gA, (float*)gB, (float*)gC, (float*)scratch, G, Q, P, N};
  return run(a, route, (cudaStream_t)stream);
}
