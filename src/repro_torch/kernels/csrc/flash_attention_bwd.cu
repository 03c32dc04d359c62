// Flash attention's backward, for sm_90a.
//
// Replaces no TPU kernel: the Pallas kernel src/repro/kernels/flash_attention.py:
// flash_attention (def :89, pl.pallas_call :107) has no custom_vjp, and the
// JAX models differentiate their attention einsums
// (src/repro/models/layers.py: attention_scores).  This is the gradient of
// the port's forward kernel (flash_attention.cu) as that transcription
// defines it, so that a training step on the card runs no fp32 (B, H, S, S)
// scores.  With s = q k^T, t = softcap tanh(s scale / softcap) (or s
// scale), P = exp(t - lse) from the forward's row log-sum-exp, and the
// forward's mask:
//     Delta = rowsum(dO o O)
//     dV = P^T dO             (P rounded to v's dtype, as the transcription
//                              rounds it before P V)
//     dP = dO V^T;  dS = P o (dP - Delta) o scale (1 - tanh^2)
//     dQ = dS K;  dK = dS^T Q
// with fp32 accumulators, the outputs in q's dtype, on q, o, dO (B, S, Hq,
// D) and k, v (B, S, Hkv, D) given by element strides; query head h reads
// kv head h / (Hq / Hkv).
//
// What bounds it, at gemma2-2b's training shape (B 2, S 4608, 8 / 4 heads
// of 256, causal): 2.5x the forward's operations (q K^T and dO V^T again,
// then P^T dO, dS^T Q and dS K, 10 D FLOPs a seen (q, k) pair), about
// 0.43 TFLOP a layer, so 0.434 ms (local) and 0.440 ms (global) at the 989
// TFLOP/s of bf16 tensor cores; its bytes (q, k, v, o, dO and the lse in;
// dq, dk, dv out) are 0.23 GB (`roofline.flash_bwd_work`).
//
// Deterministic, with no atomics: three kernels, each output written once.
//   * delta: one warp a query row, rowsum(dO o O) in fp32.
//   * dkv: one block per (64-key tile, b * Hkv + kv head), which loops over
//     the Hq / Hkv query heads of its group and the 64-row query tiles the
//     mask leaves (the causal diagonal and the window skip the rest), and
//     keeps dK and dV of its keys in registers.
//   * dq: one block per (64-row query tile, b * Hq + h), the last tiles
//     first, which loops over the key tiles the mask leaves, as the forward
//     does, and keeps dQ in registers.
// Each recomputes S and dP, as FlashAttention-2's backward does.
//
// Two routes, chosen by the caller (kernels/flash_attention.py:
// flash_bwd_route) from dtype, layout and head dim before the launch:
//
// "mma" (bf16 / fp16, D of 64, 96, 112, 128 or 256, 16-byte-aligned bases
// and strides; its kernels in flash_attention_bwd_mma.cu, built in
// parallel with this file): warp-level mma.sync (m16n8k16) with ldmatrix
// from padded shared-memory tiles (rows 16 bytes longer than the tile, so
// the 8 rows of one ldmatrix fall in different banks).  Four warps take 16
// rows each of the block's fixed tile (keys in dkv, query rows in dq); at
// D = 256 the output columns are split over two warp sets (eight warps),
// because a 16 x 256 fp32 accumulator pair (dK and dV) would be 256
// registers a thread: each set computes the scores of half the other
// tile's rows and the sets trade P and dS, rounded to 16 bits, through
// shared memory.  The looped tiles are double-buffered by cp.async: the
// next tile's copies run under this tile's products.  S and dP stay in the
// accumulator registers; P and dS become the A fragments of the next
// products in registers (rounded to the input dtype, dS's rounding being
// the one the plain version does not make, 2^-9 relative in bf16).  Head
// dims 96 and 112 run the D = 128 template on zero-filled columns (the
// copies zero fill past d), whose products are skipped.
//
// "simt" (fp32, other head dims, or a layout 16-byte loads cannot read):
// fp32 on the CUDA cores, 32 x 32 tiles, 256 threads.  The score tile
// is formed in shared memory, one (query, key) pair of dot products a
// thread at a time, then each thread accumulates D / 8 columns of one row
// of its outputs.
#include "flash_attention_bwd.cuh"

namespace {

using namespace flash_bwd;

// ---- Delta = rowsum(dO o O): one warp a row (b, h, s) -------------------

template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ delta, int Hq, int S, int D, long long sb,
                           long long sh, long long ss, int rows) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int s = row % S, bh = row / S;
  const size_t off = (size_t)(bh / Hq) * sb + (size_t)(bh % Hq) * sh + (size_t)s * ss;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(o[off + d]), to_f32(dout[off + d]), acc);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) delta[row] = acc;
}

// ---- the "simt" route ----------------------------------------------------

constexpr int kSThreads = 256;
constexpr int kST = 32;        // query rows and keys a tile
constexpr int kSP = kST + 1;   // padded row stride of the score tiles

template <int DP>
constexpr size_t simt_smem() {
  return sizeof(float) * (4 * (size_t)kST * (DP + 1) + 2 * (size_t)kST * kSP + 2 * kST);
}

// P (rounded to T) and dS of the 32 x 32 tile (rows q0.., keys k0..) into
// ps and dss ([row][key], stride kSP), from the fp32 tiles in shared
// memory (stride DP + 1) and the rows' lse2 and Delta.
template <typename T, int DP>
__device__ __forceinline__ void simt_scores(const Att& at, const float* qs, const float* dos,
                                            const float* ks, const float* vs,
                                            const float* lse2, const float* dlt, float* ps,
                                            float* dss, int q0, int k0) {
  constexpr int QS = DP + 1;
#pragma unroll
  for (int e4 = 0; e4 < kST * kST / kSThreads; ++e4) {
    const int e = threadIdx.x + kSThreads * e4;
    const int m = e / kST, n = e % kST;
    float p = 0.f, ds = 0.f;
    if (seen(at, q0 + m, k0 + n)) {
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < at.D; ++d) {
        s = fmaf(qs[m * QS + d], ks[n * QS + d], s);
        dp = fmaf(dos[m * QS + d], vs[n * QS + d], dp);
      }
      p_ds(at, s, dp, lse2[m], dlt[m], p, ds);
    }
    ps[m * kSP + n] = round_to(p, (T*)nullptr);
    dss[m * kSP + n] = ds;
  }
}

// rows [r0, r0 + 32) of a (B, S, H, D) tensor at `base` (its batch and head
// applied) into shared memory as fp32 [32][DP + 1], zeros past S and D
template <typename T, int DP>
__device__ __forceinline__ void simt_load(const T* __restrict__ base, long long ss, int r0,
                                          const Att& at, float* dst) {
  for (int idx = threadIdx.x; idx < kST * DP; idx += kSThreads) {
    const int r = idx / DP, d = idx % DP, s = r0 + r;
    dst[r * (DP + 1) + d] = (s < at.S && d < at.D) ? to_f32(base[(size_t)s * ss + d]) : 0.f;
  }
}

// dK and dV of 32 keys of kv head (b, hk): grid (ceil(S / 32), B * Hkv).
template <typename T, int DP>
__global__ void __launch_bounds__(kSThreads)
    flash_bwd_dkv_simt(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv, long long q_sb,
                       long long q_sh, long long q_ss, long long kv_sb, long long kv_sh,
                       long long kv_ss, Att at) {
  constexpr int QS = DP + 1, kCols = DP / 8;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kST * QS;
  float* qs = vs + kST * QS;
  float* dos = qs + kST * QS;
  float* ps = dos + kST * QS;
  float* dss = ps + kST * kSP;
  float* lse2 = dss + kST * kSP;
  float* dlt = lse2 + kST;

  const int k0 = blockIdx.x * kST;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv, rep = Hq / Hkv;
  const size_t kvo = (size_t)b * kv_sb + (size_t)hk * kv_sh;
  simt_load<T, DP>(k + kvo, kv_ss, k0, at, ks);
  simt_load<T, DP>(v + kvo, kv_ss, k0, at, vs);
  const int n = threadIdx.x / 8, c0 = threadIdx.x % 8;  // this thread's key and columns
  float acc_k[kCols], acc_v[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc_k[j] = acc_v[j] = 0.f;

  int lo, hi;
  q_tiles(at, k0, kST, kST, lo, hi);
  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const size_t qo = (size_t)b * q_sb + (size_t)h * q_sh;
    const size_t ro = (size_t)(b * Hq + h) * at.S;
    for (int qt = lo; qt < hi; ++qt) {
      const int q0 = qt * kST;
      __syncthreads();  // the last tile is done with qs, dos, ps and dss
      simt_load<T, DP>(q + qo, q_ss, q0, at, qs);
      simt_load<T, DP>(dout + qo, q_ss, q0, at, dos);
      if (threadIdx.x < kST) {
        const int s = q0 + threadIdx.x;
        lse2[threadIdx.x] = s < at.S ? lse[ro + s] * kLog2e : 0.f;
        dlt[threadIdx.x] = s < at.S ? delta[ro + s] : 0.f;
      }
      __syncthreads();
      simt_scores<T, DP>(at, qs, dos, ks, vs, lse2, dlt, ps, dss, q0, k0);
      __syncthreads();
#pragma unroll 4
      for (int m = 0; m < kST; ++m) {
        const float p = ps[m * kSP + n], ds = dss[m * kSP + n];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          acc_v[j] = fmaf(p, dos[m * QS + c0 + 8 * j], acc_v[j]);
          acc_k[j] = fmaf(ds, qs[m * QS + c0 + 8 * j], acc_k[j]);
        }
      }
    }
  }
  if (k0 + n >= at.S) return;
  const size_t out = kvo + (size_t)(k0 + n) * kv_ss;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int d = c0 + 8 * j;
    if (d < at.D) {
      store(dk + out + d, acc_k[j]);
      store(dv + out + d, acc_v[j]);
    }
  }
}

// dQ of 32 query rows of head (b, h): grid (ceil(S / 32), B * Hq), the last
// tiles first.
template <typename T, int DP>
__global__ void __launch_bounds__(kSThreads)
    flash_bwd_dq_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dq, int Hq, int Hkv,
                      long long q_sb, long long q_sh, long long q_ss, long long kv_sb,
                      long long kv_sh, long long kv_ss, Att at) {
  constexpr int QS = DP + 1, kCols = DP / 8;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kST * QS;
  float* ks = dos + kST * QS;
  float* vs = ks + kST * QS;
  float* ps = vs + kST * QS;
  float* dss = ps + kST * kSP;
  float* lse2 = dss + kST * kSP;
  float* dlt = lse2 + kST;

  const int nq = (at.S + kST - 1) / kST;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kST;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq, hk = h / (Hq / Hkv);
  const size_t qo = (size_t)b * q_sb + (size_t)h * q_sh;
  const size_t kvo = (size_t)b * kv_sb + (size_t)hk * kv_sh;
  const size_t ro = (size_t)(b * Hq + h) * at.S;
  simt_load<T, DP>(q + qo, q_ss, q0, at, qs);
  simt_load<T, DP>(dout + qo, q_ss, q0, at, dos);
  if (threadIdx.x < kST) {
    const int s = q0 + threadIdx.x;
    lse2[threadIdx.x] = s < at.S ? lse[ro + s] * kLog2e : 0.f;
    dlt[threadIdx.x] = s < at.S ? delta[ro + s] : 0.f;
  }
  const int m = threadIdx.x / 8, c0 = threadIdx.x % 8;  // this thread's row and columns
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;

  int lo, hi;
  k_tiles(at, q0, kST, kST, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kST;
    __syncthreads();  // the last tile is done with ks, vs and dss
    simt_load<T, DP>(k + kvo, kv_ss, k0, at, ks);
    simt_load<T, DP>(v + kvo, kv_ss, k0, at, vs);
    __syncthreads();
    simt_scores<T, DP>(at, qs, dos, ks, vs, lse2, dlt, ps, dss, q0, k0);
    __syncthreads();
#pragma unroll 4
    for (int n = 0; n < kST; ++n) {
      const float ds = dss[m * kSP + n];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[j] = fmaf(ds, ks[n * QS + c0 + 8 * j], acc[j]);
    }
  }
  if (q0 + m >= at.S) return;
  const size_t out = qo + (size_t)(q0 + m) * q_ss;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int d = c0 + 8 * j;
    if (d < at.D) store(dq + out + d, acc[j]);
  }
}

template <typename T>
int launch_delta(const Args& a, const Att& at, cudaStream_t st) {
  const int rows = a.B * a.Hq * at.S;
  flash_bwd_delta_kernel<T><<<(rows + 7) / 8, 256, 0, st>>>(
      (const T*)a.o, (const T*)a.dout, a.delta, a.Hq, at.S, at.D, a.q_sb, a.q_sh, a.q_ss, rows);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_simt(const Args& a, const Att& at, cudaStream_t st) {
  const size_t smem = simt_smem<DP>();
  auto kkv = flash_bwd_dkv_simt<T, DP>;
  auto kq = flash_bwd_dq_simt<T, DP>;
  cudaError_t e = hopper::allow_smem(kkv, smem);
  if (e == cudaSuccess) e = hopper::allow_smem(kq, smem);
  if (e != cudaSuccess) return (int)e;
  const int nt = (at.S + kST - 1) / kST;
  if (a.need_dkv) {
    kkv<<<dim3(nt, a.B * a.Hkv), kSThreads, smem, st>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, (const float*)a.lse,
        a.delta, (T*)a.dk, (T*)a.dv, a.Hq, a.Hkv, a.q_sb, a.q_sh, a.q_ss, a.kv_sb, a.kv_sh,
        a.kv_ss, at);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (a.need_dq) {
    kq<<<dim3(nt, a.B * a.Hq), kSThreads, smem, st>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, (const float*)a.lse,
        a.delta, (T*)a.dq, a.Hq, a.Hkv, a.q_sb, a.q_sh, a.q_ss, a.kv_sb, a.kv_sh, a.kv_ss, at);
    e = cudaGetLastError();
  }
  return (int)e;
}

template <typename T>
int launch_simt_d(const Args& a, const Att& at, cudaStream_t st) {
  if (at.D <= 64) return launch_simt<T, 64>(a, at, st);
  if (at.D <= 128) return launch_simt<T, 128>(a, at, st);
  if (at.D <= 256) return launch_simt<T, 256>(a, at, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o, dout, dq: (B, S, Hq, D) by element strides q_* (batch, head,
// sequence; D contiguous); k, v, dk, dv: (B, S, Hkv, D) by kv_*; lse and
// delta (scratch): (B, Hq, S) fp32, lse the forward's row log-sum-exp.  One
// dtype: 0 fp32, 1 bf16, 2 fp16.  window < 0 means none.  need_dq /
// need_dkv: which outputs to compute.  route 0 = "simt", 2 = "mma" (bf16 /
// fp16, D of 64, 96, 112, 128 or 256, 16-byte-aligned bases and strides).
// Returns the cudaError_t of the first launch that failed, else 0.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                      const void* lse, const void* dout, void* dq, void* dk,
                                      void* dv, void* delta, int dtype, int B, int Hq, int Hkv,
                                      int S, int D, long long q_sb, long long q_sh,
                                      long long q_ss, long long kv_sb, long long kv_sh,
                                      long long kv_ss, int causal, int window, int has_softcap,
                                      float softcap, float scale, int need_dq, int need_dkv,
                                      int route, void* stream) {
  if (B == 0 || Hq == 0 || S == 0 || (!need_dq && !need_dkv)) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256) return (int)cudaErrorInvalidValue;
  if (route != 0 && route != 2) return (int)cudaErrorInvalidValue;
  Att at;
  at.S = S;
  at.D = D;
  at.causal = causal;
  at.window = window;
  at.cap = has_softcap;
  at.scale = scale;
  at.t_scale = has_softcap ? 2.f * kLog2e * scale / softcap : scale * kLog2e;
  at.t_cap = softcap * kLog2e;
  Args a{q, k, v, o, lse, dout, dq, dk, dv, (float*)delta, B, Hq, Hkv,
         q_sb, q_sh, q_ss, kv_sb, kv_sh, kv_ss, need_dq, need_dkv};
  cudaStream_t st = (cudaStream_t)stream;
  int e;
  switch (dtype) {
    case 0:
      if (route != 0) return (int)cudaErrorInvalidValue;
      e = launch_delta<float>(a, at, st);
      return e != 0 ? e : launch_simt_d<float>(a, at, st);
    case 1:
      e = launch_delta<__nv_bfloat16>(a, at, st);
      if (e != 0) return e;
      return route == 2 ? run_mma(a, at, dtype, st) : launch_simt_d<__nv_bfloat16>(a, at, st);
    case 2:
      e = launch_delta<__half>(a, at, st);
      if (e != 0) return e;
      return route == 2 ? run_mma(a, at, dtype, st) : launch_simt_d<__half>(a, at, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
