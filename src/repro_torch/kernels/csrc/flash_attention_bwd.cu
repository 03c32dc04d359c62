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
//   * delta: rowsum(dO o O) in fp32, 16-byte loads of 16-bit rows where the
//     layout allows (else one warp a row).
//   * dkv: one block per (key tile, b * Hkv + kv head), key tile 0 first
//     (under the causal mask it sees the most query tiles), which loops
//     over the Hq / Hkv query heads of its group and the 64-row query tiles
//     the mask leaves (the causal diagonal and the window skip the rest),
//     and keeps dK and dV of its keys in registers.
//   * dq: one block per (query tile, b * Hq + h), the last tiles first,
//     which loops over the key tiles the mask leaves, as the forward does,
//     and keeps dQ in registers.
// Each recomputes S and dP, as FlashAttention-2's backward does: 14 D FLOPs
// a seen pair issued against the 10 D counted.
//
// Two routes, chosen by the caller (kernels/flash_attention.py:
// flash_bwd_route) from dtype, layout and head dim before the launch:
//
// "wgmma" (bf16 / fp16, D of 64, 96, 112, 128 or 256, 16-byte-aligned bases
// and strides; its kernels in flash_attention_bwd_wgmma.cu, built in
// parallel with this file), on the forward's "wgmma" parts
// (flash_attention.cu): 4-D TMA tensor maps over (D, S, H, B) by the
// tensors' own strides, so GQA needs no copy and rows past S arrive as
// zeros; a producer warpgroup, one thread of which keeps a ring of tiles
// in flight on mbarriers and which gives its registers to the consumers
// (setmaxnreg); consumer warpgroups on wgmma, the fp32 scores and their
// elementwise work on the accumulator fragments in registers.  What bound
// the warp-level mma.sync route it replaces (1.6-3.8x SDPA's backward,
// 9-15 % of its bound): every warp reloading the other tile's B fragments
// from shared memory for its own 16 rows, copies issued by every thread,
// and, above all, the elementwise pass: a mask test around each element's
// exp made a branch of every element, which took three quarters of the
// time (measured by building the kernels without that pass).  Here one
// wgmma per 16-deep slice reads each operand once for a warpgroup's 64
// rows, one thread issues each tile's copies, p and dS are taken for every
// element of a tile and the mask (only on tiles that cross S, the causal
// diagonal or the window's edge) zeroes them by selects, and the exp is
// the special function unit's, its results below 2^-126 flushed to 0.
//   * dkv at D <= 128: 128 keys a block, 64 a consumer warpgroup, each
//     computing its keys' four products: S^T = K q^T and dP^T = V dO^T
//     (both operands K-major, one commit), P^T and dS^T on the fragments,
//     then dV += P^T dO and dK += dS^T q with A from registers and B read
//     N-major, as the forward reads V.  A query tile (q, dO) loaded once
//     serves 128 keys; a ring of 3 (D 128) or 4 (D 64) stages.
//   * dkv at D = 256, where dK and dV of 64 keys are 256 fp32 a thread: 64
//     keys a block, split by product, which keeps registers in bounds (a
//     thread holds a 64 x 64 score tile and one 64 x D accumulator, 32 +
//     128 fp32, as the forward's consumer does): warpgroup 0 computes S^T
//     and owns dV, warpgroup 1 computes dP^T and owns dK.  P^T (times 1 -
//     tanh^2 under the softcap: the factor dS takes from S) passes from 0
//     to 1 as fp32 through a 16 KB tile in shared memory, each thread's 32
//     values in the slots of its fragment, under two named barriers.
//   In both, the lse and Delta of a stage's rows are written to shared
//   memory by the producer warp's lanes, which arrive on the stage's
//   barrier beside the TMA bytes.
//   * dq: one warpgroup per 64 query rows (two at D <= 128, one at D = 256,
//     where q, dO and two stages of K and V take 192 KB), 128 keys a tile
//     at D = 64 (64 above), a ring of 3 stages (2 at D = 256): S = q K^T
//     and dP = dO V^T, dS on the fragments, dQ += dS K with K read N-major.
//     With two warpgroups they take turns at the tensor cores, as the
//     forward's do: a turn issues dQ += dS K of the last tile and S, dP of
//     this one, then waits once.
// P and dS are rounded to the input dtype in registers before they enter a
// product (dS's rounding is the one the plain version does not make, 2^-9
// relative in bf16).  Rows past S read lse = +inf, so their p is exactly 0.
// Head dims 96 and 112 run the D = 128 template: the tensor maps span the
// true head dim, TMA zero fills the columns up to 128, and the outputs'
// columns past d are not stored.
//
// "simt" (fp32, other head dims, or a layout TMA cannot read):
// fp32 on the CUDA cores, 32 x 32 tiles, 256 threads.  The score tile
// is formed in shared memory, one (query, key) pair of dot products a
// thread at a time, then each thread accumulates D / 8 columns of one row
// of its outputs.
#include "flash_attention_bwd.cuh"

namespace {

using namespace flash_bwd;

// ---- Delta = rowsum(dO o O) ---------------------------------------------

// One warp a row (b, h, s), any dtype and layout.
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

// 16-bit rows of D % 8 == 0 values at 16-byte-aligned addresses: C lanes a
// row (D / 8 rounded up to a power of two), each reading 16 bytes of o and
// of dO, so a warp takes 32 / C rows in two loads a lane; the C lanes' sums
// are added by shuffles in a fixed order.
template <typename T, int C>
__global__ void __launch_bounds__(256)
    flash_bwd_delta_vec_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                               float* __restrict__ delta, int Hq, int S, int D, long long sb,
                               long long sh, long long ss, int rows) {
  const int lane = threadIdx.x % 32, c = lane % C;
  const int row = (blockIdx.x * 8 + threadIdx.x / 32) * (32 / C) + lane / C;
  float acc = 0.f;
  if (row < rows && 8 * c < D) {
    const int s = row % S, bh = row / S;
    const size_t off =
        (size_t)(bh / Hq) * sb + (size_t)(bh % Hq) * sh + (size_t)s * ss + 8 * (size_t)c;
    const uint4 a = *reinterpret_cast<const uint4*>(o + off);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + off);
    const T* x = reinterpret_cast<const T*>(&a);
    const T* y = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = fmaf(to_f32(x[k]), to_f32(y[k]), acc);
  }
#pragma unroll
  for (int m = C / 2; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (row < rows && c == 0) delta[row] = acc;
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
  const bool vec = sizeof(T) == 2 && at.D % 8 == 0 &&
                   (((uintptr_t)a.o | (uintptr_t)a.dout) % 16) == 0 &&
                   (a.q_sb | a.q_sh | a.q_ss) % 8 == 0;
  const int c = at.D <= 64 ? 8 : at.D <= 128 ? 16 : 32;
#define RT_DELTA_VEC(C)                                                                      \
  flash_bwd_delta_vec_kernel<T, C><<<(rows + 8 * (32 / C) - 1) / (8 * (32 / C)), 256, 0, st>>>( \
      (const T*)a.o, (const T*)a.dout, a.delta, a.Hq, at.S, at.D, a.q_sb, a.q_sh, a.q_ss, rows)
  if (vec && c == 8) {
    RT_DELTA_VEC(8);
  } else if (vec && c == 16) {
    RT_DELTA_VEC(16);
  } else if (vec) {
    RT_DELTA_VEC(32);
  } else {
    flash_bwd_delta_kernel<T><<<(rows + 7) / 8, 256, 0, st>>>(
        (const T*)a.o, (const T*)a.dout, a.delta, a.Hq, at.S, at.D, a.q_sb, a.q_sh, a.q_ss,
        rows);
  }
#undef RT_DELTA_VEC
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
// need_dkv: which outputs to compute.  route 0 = "simt", 1 = "wgmma" (bf16 /
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
  if (route != 0 && route != 1) return (int)cudaErrorInvalidValue;
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
      return route == 1 ? run_wgmma(a, at, dtype, st) : launch_simt_d<__nv_bfloat16>(a, at, st);
    case 2:
      e = launch_delta<__half>(a, at, st);
      if (e != 0) return e;
      return route == 1 ? run_wgmma(a, at, dtype, st) : launch_simt_d<__half>(a, at, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
