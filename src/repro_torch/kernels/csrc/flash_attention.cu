// Flash attention (block-tiled online softmax), for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (def :89, pl.pallas_call :107)
//     s = q k^T * D^-1/2;  s = softcap * tanh(s / softcap)  (optional)
//     mask: k < S and (causal => q >= k) and (window => q - k < window)
//     out = softmax(s) v, with fp32 accumulators and acc / max(l, 1e-30)
// on q (B, S, Hq, D) and k, v (B, S, Hkv, D) given by element strides, so
// the (BH, S, D) form (H = 1) and the (B, S, H, D) GQA form (query head h
// reads kv head h / (Hq / Hkv)) run without a copy.  q, k, v are fp32, bf16
// or fp16; the output is in q's dtype.
//
// What bounds it, at the gemma2-2b (S = 8192, D = 256, 8 query heads) and
// minitron-4b (S = 8192, D = 128, 24 query heads) shapes: 4 * D FLOPs per
// unmasked (q, k) pair, about 0.3-0.4 TFLOP a call, over about 0.1 GB of
// bf16 inputs and output.  So it is bound by operations.  This first kernel
// computes in fp32 on the CUDA cores (no tensor cores yet), so it is far
// from the bf16 tensor-core bound.
//
// Design.  One block of 256 threads per (64 query rows, b * Hq + h), the
// last query blocks (the longest causal rows) first.  The q tile stays in
// shared memory as fp32; 64-key K and V tiles stream through shared memory
// (dynamic: 214 KB at D = 256, over the default 48 KB).  Each thread forms
// a 4 x 4 micro-tile of scores, then four threads per row take the row's
// max and sum (online softmax, as the TPU kernel's m / l scratch), and each
// thread keeps 4 rows x D/16 columns of the output accumulator in
// registers.  The TPU kernel zeroes padding by value; here ragged S and D
// are masked by index: rows and columns past S or D are zero filled in
// shared memory and never stored, and masked scores are -inf, so exp gives
// exactly 0 there.  Key blocks that causal or window masks wholly are
// skipped, which is exact.  A row with no unmasked key (window = 0) ends
// with l = 0 and gives 0, as max(l, 1e-30) does on the TPU.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half(v); }

constexpr int kThreads = 256;
constexpr int kBQ = 64;      // query rows per block
constexpr int kBK = 64;      // keys per step
constexpr int kGroups = 16;  // 16 x 16 threads; each owns 4 rows
constexpr int kRows = kBQ / kGroups;
constexpr int kKeys = kBK / kGroups;
constexpr int kPS = kBK + 1;  // padded row stride of the score tile
constexpr float kNegInit = -1e30f;

template <int DP>
constexpr size_t smem_floats() {
  return (size_t)kBQ * (DP + 1) + (size_t)kBK * (DP + 1) + (size_t)kBK * DP + (size_t)kBQ * kPS +
         3 * kBQ;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv, int S,
                           int D, long long q_sb, long long q_sh, long long q_ss, long long kv_sb,
                           long long kv_sh, long long kv_ss, int causal, int window,
                           int has_softcap, float softcap, float scale) {
  constexpr int QS = DP + 1;        // padded row stride of the q and k tiles
  constexpr int kCols = DP / kGroups;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                     // [kBQ][QS]
  float* ks = qs + kBQ * QS;            // [kBK][QS]
  float* vs = ks + kBK * QS;            // [kBK][DP]
  float* ps = vs + kBK * DP;            // [kBQ][kPS] scores, then probabilities
  float* row_corr = ps + kBQ * kPS;     // [kBQ]
  float* row_m = row_corr + kBQ;        // [kBQ]
  float* row_l = row_m + kBQ;           // [kBQ]

  const int nq = (S + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const T* qp = q + b * q_sb + h * q_sh;
  const T* kp = k + b * kv_sb + hk * kv_sh;
  const T* vp = v + b * kv_sb + hk * kv_sh;
  T* op = o + b * q_sb + h * q_sh;

  const int tid = threadIdx.x;
  const int tx = tid % kGroups, ty = tid / kGroups;

  for (int idx = tid; idx < kBQ * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP, s = q0 + r;
    qs[r * QS + d] = (s < S && d < D) ? to_f32(qp[s * q_ss + d]) : 0.f;
  }
  if (tid < kBQ) {
    row_m[tid] = kNegInit;
    row_l[tid] = 0.f;
  }
  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  // keys that any row of this block may see
  const int k_hi = causal ? min(S, q0 + kBQ) : S;
  const int k_lo = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int kb_hi = (k_hi + kBK - 1) / kBK;

  for (int kb = k_lo / kBK; kb < kb_hi; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the last step is done with ks, vs and ps
    for (int idx = tid; idx < kBK * DP; idx += kThreads) {
      const int r = idx / DP, d = idx % DP, s = k0 + r;
      const bool ok = s < S && d < D;
      ks[r * QS + d] = ok ? to_f32(kp[s * kv_ss + d]) : 0.f;
      vs[r * DP + d] = ok ? to_f32(vp[s * kv_ss + d]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty*4 + i, keys tx + 16*j
    float sc[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float a[kRows], bk[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qs[(ty * kRows + i) * QS + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) bk[j] = ks[(tx + kGroups * j) * QS + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int c = tx + kGroups * j, kpos = k0 + c;
        float s = sc[i][j] * scale;
        if (has_softcap) s = softcap * tanhf(s / softcap);
        const bool ok = kpos < S && (!causal || qpos >= kpos) &&
                        (window < 0 || qpos - kpos < window);
        ps[r * kPS + c] = ok ? s : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes per row, keys part + 4*jj
    {
      const int r = tid >> 2, part = tid & 3;
      float* pr = ps + r * kPS;
      const float m_prev = row_m[r];
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kBK / 4; ++jj) mx = fmaxf(mx, pr[part + 4 * jj]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kBK / 4; ++jj) {
        const float p = expf(pr[part + 4 * jj] - m_new);  // exp(-inf) = 0 where masked
        pr[part + 4 * jj] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        row_corr[r] = corr;
        row_l[r] = corr * row_l[r] + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = corr * acc + p v: rows ty*4 + i, columns tx + 16*j
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float corr = row_corr[ty * kRows + i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = ps[(ty * kRows + i) * kPS + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = vs[c * DP + tx + kGroups * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();  // row_l is final

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i, s = q0 + r;
    if (s >= S) continue;
    const float l = fmaxf(row_l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = tx + kGroups * j;
      if (d < D) store(op + s * q_ss + d, acc[i][j] / l);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int S,
           int D, long long q_sb, long long q_sh, long long q_ss, long long kv_sb, long long kv_sh,
           long long kv_ss, int causal, int window, int has_softcap, float softcap, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DP>();
  auto kern = flash_attention_kernel<T, DP>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((S + kBQ - 1) / kBQ, B * Hq);
  kern<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, Hq, Hkv, S,
                                         D, q_sb, q_sh, q_ss, kv_sb, kv_sh, kv_ss, causal, window,
                                         has_softcap, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int S,
             int D, long long q_sb, long long q_sh, long long q_ss, long long kv_sb,
             long long kv_sh, long long kv_ss, int causal, int window, int has_softcap,
             float softcap, float scale, cudaStream_t stream) {
#define RT_FA_LAUNCH(DP)                                                                       \
  return launch<T, DP>(q, k, v, o, B, Hq, Hkv, S, D, q_sb, q_sh, q_ss, kv_sb, kv_sh, kv_ss,     \
                       causal, window, has_softcap, softcap, scale, stream)
  if (D <= 32) RT_FA_LAUNCH(32);
  if (D <= 64) RT_FA_LAUNCH(64);
  if (D <= 128) RT_FA_LAUNCH(128);
  if (D <= 256) RT_FA_LAUNCH(256);
#undef RT_FA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o: (B, S, Hq, D) and k, v: (B, S, Hkv, D) by element strides (batch,
// head, sequence; D contiguous), one dtype: 0 fp32, 1 bf16, 2 fp16.
// window < 0 means none; D <= 256.  Returns the cudaError_t of the launch.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o, int dtype,
                                  int B, int Hq, int Hkv, int S, int D, long long q_sb,
                                  long long q_sh, long long q_ss, long long kv_sb, long long kv_sh,
                                  long long kv_ss, int causal, int window, int has_softcap,
                                  float softcap, float scale, void* stream) {
  if (B == 0 || Hq == 0 || S == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_d<float>(q, k, v, o, B, Hq, Hkv, S, D, q_sb, q_sh, q_ss, kv_sb, kv_sh, kv_ss,
                             causal, window, has_softcap, softcap, scale, st);
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, S, D, q_sb, q_sh, q_ss, kv_sb, kv_sh,
                                     kv_ss, causal, window, has_softcap, softcap, scale, st);
    case 2:
      return launch_d<__half>(q, k, v, o, B, Hq, Hkv, S, D, q_sb, q_sh, q_ss, kv_sb, kv_sh, kv_ss,
                              causal, window, has_softcap, softcap, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
