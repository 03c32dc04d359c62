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
// Q = 256, P = 64, N = 128, fp32): about 4*Q^2/2*(N + P)/2 + 2*Q*P*N FLOPs a
// chunk, 0.04 TFLOP in all, over 0.8 GB of fp32 inputs and outputs: about
// 50 FLOPs a byte, under the fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20), so
// bound by operations, at the fp32 rate as the work is fp32.
//
// Design.  One block of 256 threads per chunk g.  The (Q, Q) matrix
// C B^T o L is 256 KiB in fp32 at Q = 256, more than a block's 227 KB of
// shared memory, so the kernel tiles it: for each 32-row tile of l, it
// streams the 32-column tiles of s with s <= l (tiles above the diagonal are
// wholly masked and skipped), forms the 32 x 32 tile of
// (C B^T) * exp(dA_cum[l] - dA_cum[s]) * dt[s] in shared memory, and adds its
// product with the x tile to the y rows it accumulates in shared memory.
// exp is evaluated only where l >= s: above the diagonal dA_cum[l] -
// dA_cum[s] > 0 may overflow, and inf * 0 would give NaN.  The cumsum is
// one thread's sequential loop over the chunk, in the order jnp.cumsum adds,
// with the multiply and add kept apart (no fused multiply-add), because
// exp amplifies any reordering.  The last l tile visits every s tile, and
// on that pass the block also adds each s tile's share of the chunk state
// into the fp32 output, which only this block writes.  Ragged Q, P and N are
// zero filled on load and masked on store.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

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

}  // namespace

// x: (G, Q, P); dt: (G, Q); A: (G,); B, C: (G, Q, N), one dtype (0 fp32,
// 1 bf16, 2 fp16), contiguous.  Outputs fp32: y (G, Q, P), states (G, P, N),
// chunk_decay (G,), state_decay (G, Q).  Returns the cudaError_t of the
// launch.
extern "C" int rt_ssd_chunk(const void* x, const void* dt, const void* A, const void* B,
                            const void* C, void* y, void* st, void* cd, void* sd, int dtype, int G,
                            int Q, int P, int N, void* stream) {
  if (G == 0) return 0;
  if (Q <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
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
