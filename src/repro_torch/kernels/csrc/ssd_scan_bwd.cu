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
// P) + 4 Q P N FLOPs a chunk, 0.065 TFLOP a call.  The route below issues
// six part products for each and recomputes C B^T and gy u^T in both of
// its tile passes, about 0.5 PFLOP of bf16 mma a call.
//
// Deterministic, with no atomics: three kernels, each output written once.
//   * "l": one block per (64-row tile i of l, chunk).  For each tile j <= i
//     of s: CB and gM of the (i, j) tile (recomputed), G2, the row sums of
//     G2 o CB, and gC_i += G2 B_j in registers.  Writes gC and the row sums.
//   * "s": one block per (tile j of s, chunk).  For each tile i >= j: CB^T
//     and gM^T, G2^T and M^T, the column sums, gB_j += G2^T C_i and gu_j +=
//     M^T gy_i; then the state's terms (B gst^T, x gst).  Writes gx, gB and
//     per step the column sums, gw and sum_p x o gu.
//   * "fin": one block per chunk: the O(Q) rest (gc, the reverse cumsum,
//     gdt, gA), from those per-step sums.
// A missing cotangent is a flag: "l" does not run without gy, "s" without
// gy and gst, and their terms are left out.
//
// Two routes, chosen by the caller (kernels/ssd_scan.py: ssd_bwd_route) from
// dtype, widths and alignment before the launch, as the forward's:
//
// "mma" (P and N multiples of 16, P <= 64, N <= 128, Q <= 512, 16-byte
// aligned bases): four strips of 16 rows a block, warp-level mma.sync
// (m16n8k16, bf16) on padded shared-memory tiles; at N > 64 each strip is
// shared by two warps that take half of the other tile's 64 steps and add
// their partial sums in shared memory at the end (in a fixed order).  fp32 accuracy as the
// forward gets it: every operand, the inputs and the fp32 intermediates
// (G2, M) alike, enters as three bf16 parts, hi = bf16(v), mid = bf16(v -
// hi), lo = bf16(v - hi - mid); a product sums the six leading part
// products, and each 16-deep slice is summed alone by the tensor cores and
// added to its accumulator in fp32 on the CUDA cores (their own fp32 sum
// truncates).  u = dt o x is taken as x with dt applied to the product.
//
// "simt" (other widths, Q past 512, layouts 16-byte loads cannot read):
// fp32 on the CUDA cores, the same three kernels on 32-row tiles, 256
// threads, every accumulator in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// In-place inclusive scan of v[0, Q) (reverse: from the end) by warp 0 of
// the block: lane t adds its ceil(Q / 32) consecutive values in order, the
// lanes' totals are scanned by shuffles, and each lane adds the totals
// before it.  Every thread of the block must reach the barriers around it.
__device__ __forceinline__ void warp_scan(float* v, int Q, bool reverse) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x, K = (Q + 31) / 32;
  auto at = [&](int i) -> float& { return v[reverse ? Q - 1 - i : i]; };
  float run = 0.f;
  for (int k = 0; k < K; ++k) {
    const int i = lane * K + k;
    if (i < Q) {
      run += at(i);
      at(i) = run;
    }
  }
  float inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += up;
  }
  const float excl = inc - run;
  for (int k = 0; k < K; ++k) {
    const int i = lane * K + k;
    if (i < Q) at(i) += excl;
  }
}

// dt of chunk g into dts[0, Q) and c = cumsum(dt A) into c[0, Q); ends
// with a barrier.
__device__ __forceinline__ void chunk_c(const float* __restrict__ dt, float a, float* dts, float* c,
                                        int Q) {
  for (int i = threadIdx.x; i < Q; i += blockDim.x) {
    dts[i] = dt[i];
    c[i] = dts[i] * a;
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
  extern __shared__ float fsm[];
  float* dts = fsm;
  float* c = dts + Q;
  float* gc = c + Q;
  const int g = blockIdx.x, lane = threadIdx.x;
  const size_t gq = (size_t)g * Q;
  const float a = A[g];
  chunk_c(dt + gq, a, dts, c, Q);
  const float last = c[Q - 1];
  float tot = 0.f;  // sum of gw o w
  for (int s = lane; s < Q; s += 32) {
    float v = 0.f;
    if (has_l) v += rs[gq + s];
    if (has_s) {
      const float w = expf(last - c[s]) * dts[s];
      v -= cs[gq + s] + gw[gq + s] * w;
      tot += gw[gq + s] * w;
    }
    if (gsd != nullptr) v += gsd[gq + s] * expf(c[s]);
    gc[s] = v;
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, m);
  __syncwarp();
  if (lane == 0) gc[Q - 1] += tot + (gcd != nullptr ? gcd[g] * expf(last) : 0.f);
  __syncwarp();
  warp_scan(gc, Q, true);  // ga
  __syncwarp();
  float ga_dt = 0.f;
  for (int s = lane; s < Q; s += 32) {
    float v = a * gc[s];
    if (has_s) v += xgu[gq + s] + gw[gq + s] * expf(last - c[s]);
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

// ---- the "mma" route -----------------------------------------------------
//
// Every operand tile is 64 rows of W (64 or NT) bf16 columns, rows padded by
// 16 bytes, in three planes (hi, mid, lo) one after the other.

constexpr int kMT = 64;

template <int W>
__host__ __device__ constexpr int row_bytes() { return (W + 8) * 2; }
template <int W>
__host__ __device__ constexpr int plane_bytes() { return kMT * row_bytes<W>(); }
template <int W>
__host__ __device__ constexpr int tile3_bytes() { return 3 * plane_bytes<W>(); }

using hopper::split3;  // (a, b) -> packed bf16 hi, mid, lo pairs

// 8 floats at p (16-byte aligned).
__device__ __forceinline__ void get8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// Rows [r0, r0 + 64) of the (rows, cols) row-major tensor at src (cols a
// multiple of 16, 16-byte-aligned rows) into the three planes at dst,
// zeros past rows and past cols.
template <int W>
__device__ __forceinline__ void load3(const float* __restrict__ src, int r0, int rows, int cols,
                                      uint8_t* dst) {
  constexpr int kChunks = W / 8;
  for (int i = threadIdx.x; i < kMT * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c8 = i % kChunks;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r0 + r < rows && 8 * c8 < cols) get8(src + (size_t)(r0 + r) * cols + 8 * c8, f);
    uint4 h, m, l;
    split3(f[0], f[1], h.x, m.x, l.x);
    split3(f[2], f[3], h.y, m.y, l.y);
    split3(f[4], f[5], h.z, m.z, l.z);
    split3(f[6], f[7], h.w, m.w, l.w);
    uint8_t* at = dst + r * row_bytes<W>() + 16 * c8;
    *reinterpret_cast<uint4*>(at) = h;
    *reinterpret_cast<uint4*>(at + plane_bytes<W>()) = m;
    *reinterpret_cast<uint4*>(at + 2 * plane_bytes<W>()) = l;
  }
}

// the part products summed for two split operands, q = 0 .. 5, smallest
// first: part pa(q) of A times part pb(q) of B: (hi, lo), (lo, hi),
// (mid, mid), (hi, mid), (mid, hi), (hi, hi)
__host__ __device__ constexpr int pa(int q) { return q == 1 ? 2 : q == 2 || q == 4 ? 1 : 0; }
__host__ __device__ constexpr int pb(int q) { return q == 0 ? 2 : q == 2 || q == 3 ? 1 : 0; }

__device__ __forceinline__ void add4(float (&d)[4], const float (&t)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = __fadd_rn(d[e], t[e]);
}

// acc (16 x 16 NP) = X[r0 .. r0 + 15] Y[n0 .. n0 + 16 NP - 1]^T over the
// first K columns (a multiple of 16) of two split tiles of width W.  The
// NP pairs of 8-column tiles take each part product in turn, so 2 NP
// accumulators are in flight.
template <int W, int NP>
__device__ __forceinline__ void xyt3(float (&acc)[2 * NP][4], uint32_t xs, uint32_t ys, int r0,
                                     int n0, int K, int lane) {
  constexpr int RB = row_bytes<W>(), PB = plane_bytes<W>();
#pragma unroll
  for (int j = 0; j < 2 * NP; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 1
  for (int kk = 0; 16 * kk < K; ++kk) {
    uint32_t a[3][4], b[NP][3][4];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      hopper::ldsm_x4(a[p], hopper::frag_a_addr(xs + p * PB, RB, r0, 16 * kk, lane));
#pragma unroll
      for (int n2 = 0; n2 < NP; ++n2)
        hopper::ldsm_x4(b[n2][p],
                        hopper::frag_b_addr(ys + p * PB, RB, n0 + 16 * n2, 16 * kk, lane));
    }
    float t[2 * NP][4];
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j) t[j][0] = t[j][1] = t[j][2] = t[j][3] = 0.f;
#pragma unroll
    for (int q = 0; q < 6; ++q)
#pragma unroll
      for (int n2 = 0; n2 < NP; ++n2) {
        hopper::mma16816<false>(t[2 * n2], a[pa(q)], b[n2][pb(q)][0], b[n2][pb(q)][1]);
        hopper::mma16816<false>(t[2 * n2 + 1], a[pa(q)], b[n2][pb(q)][2], b[n2][pb(q)][3]);
      }
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j) add4(acc[j], t[j]);
  }
}

// acc (16 x W) += A (16 x 16 KQ: split, KQ k16 fragments a part) Y[k0 ..
// k0 + 16 KQ - 1] with Y a split tile of width W stored k-major; columns at
// or past ncols skipped.  Each 16-deep slice is summed alone and added in
// fp32; two column pairs take each part product in turn.
template <int W, int KQ>
__device__ __forceinline__ void ay3(float (&acc)[W / 8][4], const uint32_t (&a)[3][KQ][4],
                                    uint32_t ys, int k0, int ncols, int lane) {
  constexpr int RB = row_bytes<W>(), PB = plane_bytes<W>();
#pragma unroll
  for (int n4 = 0; n4 < W / 32; ++n4) {
    if (32 * n4 >= ncols) break;
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq) {
      uint32_t b[2][3][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int p = 0; p < 3; ++p)
          hopper::ldsm_x4_t(b[h][p], hopper::frag_bt_addr(ys + p * PB, RB, 32 * n4 + 16 * h,
                                                          k0 + 16 * kq, lane));
      float t[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) t[j][0] = t[j][1] = t[j][2] = t[j][3] = 0.f;
#pragma unroll
      for (int q = 0; q < 6; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          hopper::mma16816<false>(t[2 * h], a[pa(q)][kq], b[h][pb(q)][0], b[h][pb(q)][1]);
          hopper::mma16816<false>(t[2 * h + 1], a[pa(q)][kq], b[h][pb(q)][2], b[h][pb(q)][3]);
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) add4(acc[4 * n4 + j], t[j]);
    }
  }
}

// The split A fragments (three parts of NT8 / 2 k16 fragments) of a 16 x 8
// NT8 accumulator.
template <int NT8>
__device__ __forceinline__ void frags3(const float (&v)[NT8][4], uint32_t (&a)[3][NT8 / 2][4]) {
#pragma unroll
  for (int kq = 0; kq < NT8 / 2; ++kq)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        split3(v[2 * kq + h][2 * i], v[2 * kq + h][2 * i + 1], a[0][kq][2 * h + i],
               a[1][kq][2 * h + i], a[2][kq][2 * h + i]);
}

template <int NT>
constexpr size_t mma_smem(int Qp) {
  return 2 * (size_t)tile3_bytes<NT>() + 2 * (size_t)tile3_bytes<64>() + 2 * (size_t)Qp * 4;
}

// "l" on the tensor cores: grid (ceil(Q / 64), G), 128 H threads.  Warp w
// takes rows l0 + 16 (w % 4) .. + 15 and part h = w / 4 of the H parts of
// each 64-step tile of s: its 64 / H columns of CB and gM, and their share
// of gC_i += G2 B_j (over those steps); with H = 2 the two parts' gC and
// row sums are added in shared memory at the end, in a fixed order.
template <int NT, int H>
__global__ void __launch_bounds__(128 * H, 1)
    ssd_bwd_l_mma(const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ gy, float* __restrict__ gC, float* __restrict__ rs,
                  int Q, int P, int N) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* cs = smem_raw;                     // C_i
  uint8_t* bs = cs + tile3_bytes<NT>();       // B_j, then the halves' partial sums
  uint8_t* gys = bs + tile3_bytes<NT>();      // gy_i
  uint8_t* xs = gys + tile3_bytes<64>();      // x_j
  float* dts = reinterpret_cast<float*>(xs + tile3_bytes<64>());
  float* c = dts + (Q + 63) / 64 * 64;
  constexpr int CW = 64 / H, NP = 4 / H;  // a warp's columns of the tile, pairs of 8
  const int g = blockIdx.y, i = blockIdx.x, l0 = 64 * i;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * (warp % 4), h = warp / 4;
  const size_t gq = (size_t)g * Q;
  chunk_c(dt + gq, A[g], dts, c, Q);
  load3<NT>(Cm + gq * N, l0, Q, N, cs);
  load3<64>(gy + gq * P, l0, Q, P, gys);
  float acc[NT / 8][4];
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float rsum[2] = {0.f, 0.f};
  const uint32_t ca = hopper::smem_u32(cs), ba = hopper::smem_u32(bs);
  const uint32_t ga = hopper::smem_u32(gys), xa = hopper::smem_u32(xs);
  for (int j = 0; j <= i; ++j) {
    const int s0 = 64 * j;
    __syncthreads();  // the last tile is done with bs and xs
    load3<NT>(Bm + gq * N, s0, Q, N, bs);
    load3<64>(x + gq * P, s0, Q, P, xs);
    __syncthreads();
    float cb[2 * NP][4], gm[2 * NP][4];
    xyt3<NT, NP>(cb, ca, ba, r0, CW * h, N, lane);  // C_i B_j^T, this part's columns
    xyt3<64, NP>(gm, ga, xa, r0, CW * h, P, lane);  // gy_i x_j^T
#pragma unroll
    for (int jj = 0; jj < 2 * NP; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int l = l0 + r0 + lane / 4 + 8 * (e >> 1);
        const int s = s0 + CW * h + 8 * jj + 2 * (lane % 4) + (e & 1);
        const float g2 = s < Q ? gm[jj][e] * dts[s] * decay(c, l, s, Q) : 0.f;
        rsum[e >> 1] += g2 * cb[jj][e];
        gm[jj][e] = g2;
      }
    uint32_t af[3][NP][4];
    frags3(gm, af);
    ay3<NT, NP>(acc, af, ba, CW * h, N, lane);  // gC_i += G2 B_j over this part's steps
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    rsum[k] += __shfl_xor_sync(0xffffffffu, rsum[k], 1);
    rsum[k] += __shfl_xor_sync(0xffffffffu, rsum[k], 2);
  }
  float* part = reinterpret_cast<float*>(bs);  // [64][NT] gC, then [64] row sums
  float* prs = part + 64 * NT;
  if constexpr (H == 2) {
    __syncthreads();  // done with bs: the second part's sums go there
    if (h == 1) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int row = r0 + lane / 4 + 8 * k;
#pragma unroll
        for (int jj = 0; jj < NT / 8; ++jj)
          *reinterpret_cast<float2*>(part + row * NT + 8 * jj + 2 * (lane % 4)) =
              make_float2(acc[jj][2 * k], acc[jj][2 * k + 1]);
        if (lane % 4 == 0) prs[row] = rsum[k];
      }
    }
    __syncthreads();
    if (h == 1) return;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int row = r0 + lane / 4 + 8 * k, l = l0 + row;
    if (l >= Q) continue;
    if (lane % 4 == 0) rs[gq + l] = rsum[k] + (H == 2 ? prs[row] : 0.f);
#pragma unroll
    for (int jj = 0; jj < NT / 8; ++jj) {
      const int n = 8 * jj + 2 * (lane % 4);
      if (n < N) {
        float2 o = make_float2(0.f, 0.f);
        if constexpr (H == 2) o = *reinterpret_cast<const float2*>(part + row * NT + n);
        *reinterpret_cast<float2*>(gC + (gq + l) * N + n) =
            make_float2(acc[jj][2 * k] + o.x, acc[jj][2 * k + 1] + o.y);
      }
    }
  }
}

// "s" on the tensor cores: grid (ceil(Q / 64), G), 128 H threads.  Warp w
// takes rows s0 + 16 (w % 4) .. + 15 and part h = w / 4 of each 64-step
// tile of l, as in "l"; with H = 2 the parts' gB, gu and column sums are
// added in shared memory, then the first part's warps add the state's
// terms and write.
template <int NT, int H>
__global__ void __launch_bounds__(128 * H, 1)
    ssd_bwd_s_mma(const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ gy, const float* __restrict__ gst,
                  float* __restrict__ gx, float* __restrict__ gB, float* __restrict__ csum,
                  float* __restrict__ gw, float* __restrict__ xgu, int Q, int P, int N) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* bs = smem_raw;                     // B_j
  uint8_t* xs = bs + tile3_bytes<NT>();       // x_j
  uint8_t* cs = xs + tile3_bytes<64>();       // C_i, then the partial sums, then gst
  uint8_t* gys = cs + tile3_bytes<NT>();      // gy_i (the partial sums run into it)
  float* dts = reinterpret_cast<float*>(gys + tile3_bytes<64>());
  float* c = dts + (Q + 63) / 64 * 64;
  constexpr int CW = 64 / H, NP = 4 / H;  // a warp's columns of the tile, pairs of 8
  const int g = blockIdx.y, j = blockIdx.x, s0 = 64 * j;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * (warp % 4), h = warp / 4;
  const size_t gq = (size_t)g * Q;
  chunk_c(dt + gq, A[g], dts, c, Q);
  load3<NT>(Bm + gq * N, s0, Q, N, bs);
  load3<64>(x + gq * P, s0, Q, P, xs);
  const uint32_t ba = hopper::smem_u32(bs), ca = hopper::smem_u32(cs);
  const uint32_t xa = hopper::smem_u32(xs), ga = hopper::smem_u32(gys);
  float accb[NT / 8][4], accu[8][4];
#pragma unroll
  for (int jj = 0; jj < NT / 8; ++jj) accb[jj][0] = accb[jj][1] = accb[jj][2] = accb[jj][3] = 0.f;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) accu[jj][0] = accu[jj][1] = accu[jj][2] = accu[jj][3] = 0.f;
  float colsum[2] = {0.f, 0.f};
  // this thread's rows s0 + r0 + lane / 4 (+ 8) and their dt
  float dtr[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int s = s0 + r0 + lane / 4 + 8 * k;
    dtr[k] = s < Q ? dts[s] : 0.f;
  }
  const int nT = (Q + 63) / 64;
  for (int i = gy != nullptr ? j : nT; i < nT; ++i) {
    const int l0 = 64 * i;
    __syncthreads();  // the last tile is done with cs and gys
    load3<NT>(Cm + gq * N, l0, Q, N, cs);
    load3<64>(gy + gq * P, l0, Q, P, gys);
    __syncthreads();
    float cb[2 * NP][4], gm[2 * NP][4];
    xyt3<NT, NP>(cb, ba, ca, r0, CW * h, N, lane);  // B_j C_i^T, this part's columns
    xyt3<64, NP>(gm, xa, ga, r0, CW * h, P, lane);  // x_j gy_i^T
#pragma unroll
    for (int jj = 0; jj < 2 * NP; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = s0 + r0 + lane / 4 + 8 * (e >> 1);
        const int l = l0 + CW * h + 8 * jj + 2 * (lane % 4) + (e & 1);
        const float L = s < Q ? decay(c, l, s, Q) : 0.f;
        const float g2 = gm[jj][e] * dtr[e >> 1] * L;
        colsum[e >> 1] += g2 * cb[jj][e];
        gm[jj][e] = g2;
        cb[jj][e] *= L;
      }
    uint32_t af[3][NP][4];
    frags3(gm, af);
    ay3<NT, NP>(accb, af, ca, CW * h, N, lane);  // gB_j += G2^T C_i over this part's steps
    frags3(cb, af);
    ay3<64, NP>(accu, af, ga, CW * h, P, lane);  // gu_j += M^T gy_i
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    colsum[k] += __shfl_xor_sync(0xffffffffu, colsum[k], 1);
    colsum[k] += __shfl_xor_sync(0xffffffffu, colsum[k], 2);
  }
  if constexpr (H == 2) {
    float* pb = reinterpret_cast<float*>(cs);  // [64][NT] gB, [64][64] gu, [64] column sums
    float* pu = pb + 64 * NT;
    float* pc = pu + 64 * 64;
    __syncthreads();  // done with cs and gys: the second part's sums go there
    if (h == 1) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int row = r0 + lane / 4 + 8 * k;
#pragma unroll
        for (int jj = 0; jj < NT / 8; ++jj)
          *reinterpret_cast<float2*>(pb + row * NT + 8 * jj + 2 * (lane % 4)) =
              make_float2(accb[jj][2 * k], accb[jj][2 * k + 1]);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          *reinterpret_cast<float2*>(pu + row * 64 + 8 * jj + 2 * (lane % 4)) =
              make_float2(accu[jj][2 * k], accu[jj][2 * k + 1]);
        if (lane % 4 == 0) pc[row] = colsum[k];
      }
    }
    __syncthreads();
    if (h == 0) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int row = r0 + lane / 4 + 8 * k;
#pragma unroll
        for (int jj = 0; jj < NT / 8; ++jj) {
          const float2 o =
              *reinterpret_cast<const float2*>(pb + row * NT + 8 * jj + 2 * (lane % 4));
          accb[jj][2 * k] += o.x;
          accb[jj][2 * k + 1] += o.y;
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 o =
              *reinterpret_cast<const float2*>(pu + row * 64 + 8 * jj + 2 * (lane % 4));
          accu[jj][2 * k] += o.x;
          accu[jj][2 * k + 1] += o.y;
        }
        colsum[k] += pc[row];
      }
    }
  }
  // the state's terms: bg = B_j gst^T (16 x P, kept for gx and gw), and
  // gB_j += (w o x_j) gst, the A fragments of w o x built from x in
  // registers
  const float last = c[Q - 1];
  const float* xg = x + gq * P;
  float w[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int s = s0 + r0 + lane / 4 + 8 * k;
    w[k] = s < Q ? expf(last - c[s]) * dtr[k] : 0.f;
  }
  float bg[8][4];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) bg[jj][0] = bg[jj][1] = bg[jj][2] = bg[jj][3] = 0.f;
  if (gst != nullptr) {
    __syncthreads();  // done with the partial sums in cs
    load3<NT>(gst + (size_t)g * P * N, 0, P, N, cs);
    __syncthreads();
    if (h == 0) {
      float half[4][4];
      xyt3<NT, 2>(half, ba, ca, r0, 0, N, lane);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) bg[jj][e] = half[jj][e];
      xyt3<NT, 2>(half, ba, ca, r0, 32, N, lane);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) bg[4 + jj][e] = half[jj][e];
      // A fragment m of k16 slice kq: row r0 + lane / 4 + 8 (m % 2), columns
      // 16 kq + 8 (m / 2) + 2 (lane % 4) + {0, 1}
      uint32_t af[3][4][4];
#pragma unroll
      for (int kq = 0; kq < 4; ++kq)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int s = s0 + r0 + lane / 4 + 8 * (m % 2);
          const int p = 16 * kq + 8 * (m / 2) + 2 * (lane % 4);
          float v0 = 0.f, v1 = 0.f;
          if (s < Q && p < P) {
            v0 = w[m % 2] * xg[(size_t)s * P + p];
            v1 = w[m % 2] * xg[(size_t)s * P + p + 1];
          }
          split3(v0, v1, af[0][kq][m], af[1][kq][m], af[2][kq][m]);
        }
      ay3<NT, 4>(accb, af, ca, 0, N, lane);
    }
  }
  if (h == 1) return;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int s = s0 + r0 + lane / 4 + 8 * k;
    float gws = 0.f, xgus = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int p = 8 * jj + 2 * (lane % 4);
      if (s < Q && p < P) {
        const float x0 = xg[(size_t)s * P + p], x1 = xg[(size_t)s * P + p + 1];
        const float u0 = accu[jj][2 * k], u1 = accu[jj][2 * k + 1];
        const float b0 = bg[jj][2 * k], b1 = bg[jj][2 * k + 1];
        *reinterpret_cast<float2*>(gx + (gq + s) * P + p) =
            make_float2(dtr[k] * u0 + w[k] * b0, dtr[k] * u1 + w[k] * b1);
        gws += x0 * b0 + x1 * b1;
        xgus += x0 * u0 + x1 * u1;
      }
    }
#pragma unroll
    for (int jj = 0; jj < NT / 8; ++jj) {
      const int n = 8 * jj + 2 * (lane % 4);
      if (s < Q && n < N)
        *reinterpret_cast<float2*>(gB + (gq + s) * N + n) =
            make_float2(accb[jj][2 * k], accb[jj][2 * k + 1]);
    }
#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
      gws += __shfl_xor_sync(0xffffffffu, gws, m);
      xgus += __shfl_xor_sync(0xffffffffu, xgus, m);
    }
    if (s < Q && lane % 4 == 0) {
      csum[gq + s] = colsum[k];
      gw[gq + s] = gws;
      xgu[gq + s] = xgus;
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
  ssd_bwd_fin_kernel<<<a.G, 32, 3 * (size_t)a.Q * sizeof(float), st>>>(
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

template <int NT, int H>
int launch_mma(const Args& a, cudaStream_t st) {
  const size_t gqs = (size_t)a.G * a.Q;
  float* rs = a.scratch;
  const int nT = (a.Q + kMT - 1) / kMT;
  const size_t smem = mma_smem<NT>(nT * kMT);
  const dim3 grid(nT, a.G);
  auto kl = ssd_bwd_l_mma<NT, H>;
  auto ks = ssd_bwd_s_mma<NT, H>;
  cudaError_t e = hopper::allow_smem(kl, smem);
  if (e == cudaSuccess) e = hopper::allow_smem(ks, smem);
  if (e != cudaSuccess) return (int)e;
  if (a.gy != nullptr) {
    kl<<<grid, 128 * H, smem, st>>>(a.x, a.dt, a.A,
                                      a.B, a.C, a.gy, a.gC, rs, a.Q, a.P,
                                      a.N);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (a.gy != nullptr || a.gst != nullptr) {
    ks<<<grid, 128 * H, smem, st>>>(a.x, a.dt, a.A,
                                      a.B, a.C, a.gy, a.gst, a.gx, a.gB,
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
  // N <= 64: four warps a block (two blocks fit an SM); N <= 128: eight,
  // the strips' columns in two parts (on the H100, zamba2-7b's G 1792 N 64
  // read 2.28 ms with four warps and 2.65 with eight, mamba2-780m's G 1536
  // N 128 3.24 ms with eight and 4.56 with four)
  if (a.N <= 64) return launch_mma<64, 1>(a, st);
  return launch_mma<128, 2>(a, st);
}

}  // namespace

// x: (G, Q, P); dt: (G, Q); A: (G,); B, C: (G, Q, N), fp32, contiguous.
// Cotangents fp32, each null when missing: gy (G, Q, P), gst (G, P, N), gcd
// (G,), gsd (G, Q).  Gradients fp32: gx, gdt, gA, gB, gC shaped as the
// inputs; gC is written only with gy, gx and gB only with gy or gst (the
// caller zeroes what is not written).  scratch: 4 G Q floats.  route 0 =
// "simt", 2 = "mma" (P and N multiples of 16, P <= 64, N <= 128, Q <= 512,
// 16-byte-aligned bases).  Returns the cudaError_t of the first launch
// that failed, else 0.
extern "C" int rt_ssd_chunk_bwd(const void* x, const void* dt, const void* A, const void* B,
                                const void* C, const void* gy, const void* gst, const void* gcd,
                                const void* gsd, void* gx, void* gdt, void* gA, void* gB,
                                void* gC, void* scratch, int G, int Q, int P, int N, int route,
                                void* stream) {
  if (G == 0) return 0;
  if (Q <= 0 || (route != 0 && route != 2)) return (int)cudaErrorInvalidValue;
  Args a{(const float*)x, (const float*)dt, (const float*)A, (const float*)B, (const float*)C,
         (const float*)gy, (const float*)gst, (const float*)gcd, (const float*)gsd, (float*)gx,
         (float*)gdt, (float*)gA, (float*)gB, (float*)gC, (float*)scratch, G, Q, P, N};
  return run(a, route, (cudaStream_t)stream);
}
