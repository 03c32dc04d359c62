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
// unmasked (q, k) pair, about 0.2-0.4 TFLOP a call, over about 0.1 GB of
// bf16 inputs and output.  So it is bound by operations: 0.42 ms
// (minitron-4b), 0.28 ms (gemma2-2b global), 0.21 ms (local, window 4096)
// at the 989 TFLOP/s of bf16 tensor cores.
//
// Two routes, chosen by the caller (kernels/flash_attention.py:
// flash_route) from dtype, layout and head dim before the launch, never
// after a failure:
//
// "wgmma" (bf16 / fp16, D of 64, 96, 112, 128 or 256, 16-byte-aligned
// bases and strides), after FlashAttention-3 but smaller.  One block per
// (128 query rows, b * Hq + h), the last query blocks (the longest causal
// rows) first:
// two consumer warpgroups of 64 rows each and one producer warpgroup,
// which gives most of its registers to the consumers (setmaxnreg: 40 and
// 232 a thread; one of its threads issues every load).  The producer loads
// the q tile once, then K and V tiles (128 keys at D <= 128, 64 at D = 256)
// into a 2-stage ring, all by TMA through 4-D tensor maps over (D, S, H, B)
// by the tensors' own strides, so GQA (kv head h / (Hq / Hkv)) needs no
// copy and rows past S arrive as zeros.
//   The consumers take turns at the tensor cores (two named barriers): one
// issues its products while the other runs its softmax.  A turn issues
// O += P V of the previous tile (wgmma with P from registers, V read
// N-major, as V is (S, D) with D contiguous) and S = q K^T of this one
// (q and K both K-major), then waits once.  The fp32 scores stay in
// registers and the online softmax runs on the accumulator fragments: the
// row max is reduced over the 4 lanes that share a row by shuffles,
// scale * log2(e) is folded into one multiply and exp2f takes the
// exponent; the row sum stays per thread until the end; the corrections
// are applied to the register accumulator.  Masks are applied only to
// tiles that cross the causal diagonal, the window edge or S, and key
// tiles that no row of the block sees are skipped.  Both warpgroups
// compute every tile of the block's range (one whose rows see none of a
// tile masks it whole), so whether a wgmma is issued depends on the loop
// count alone: ptxas serialises a wgmma on a path it cannot prove uniform.
// A masked score is -inf, so its p is exactly 0, and a row with no key ends
// with l = 0 and gives 0, as max(l, 1e-30) does on the TPU.  P is rounded
// to q's dtype in registers before P V (the only rounding the plain version
// does not make, 2^-9 relative in bf16).  At D = 256 the 64 x 256
// accumulator is 128 registers a thread; the block holds 192 KB of shared
// memory (q 64 KB, two stages of K and V at 32 KB each).  Softcap keeps an
// exact tanh, as 1 - 2 / (2^(2x log2 e) + 1) with an fp32 exp2f (within
// 2e-7 of tanh, so 1e-5 on a logit at softcap 50); tanh.approx.f32's 2^-11
// would move such logits by up to 0.02 and p by about 2 %.  The softcap and
// mask choices are made outside the per-element loops.
//
//   Head dims 96 (phi-3-vision) and 112 (zamba2) run the D = 128 template:
// the tensor maps span the true head dim and the boxes stay two 64-column
// atoms a row, so TMA zero fills columns d..127 of q, K and V in shared
// memory (rows of 192 or 224 bytes are multiples of 16, as TMA needs).  q
// K^T over 128 columns is then exactly q K^T over d, scale stays d^-1/2, and
// the output's columns past d (P times V's zeros) are not stored.  The
// price is 128/112 (128/96) of the MMA work of a native width, and it
// reuses a template whose swizzle and descriptors are proven; a native N =
// 112 / 96 P V would need a second atom 48 or 32 columns wide.
//
// "simt" (fp32, other head dims, or a layout TMA cannot take): the first
// kernel, unchanged.  One block of 256 threads per (64 query rows, b * Hq +
// h), the last query blocks first.  The q tile stays in shared memory as
// fp32; 64-key K and V tiles stream through shared memory (dynamic: 214 KB
// at D = 256).  Each thread forms a 4 x 4 micro-tile of scores, then four
// threads per row take the row's max and sum, and each thread keeps 4 rows
// x D/16 columns of the output accumulator in registers.  Ragged S and D
// are masked by index: rows and columns past S or D are zero filled in
// shared memory and never stored, and masked scores are -inf.  Key blocks
// that causal or window masks wholly are skipped, which is exact.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
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
                           const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                           int Hq, int Hkv, int S, int D, long long q_sb, long long q_sh,
                           long long q_ss, long long kv_sb, long long kv_sh, long long kv_ss,
                           int causal, int window,
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

  if (lse != nullptr && tid < kBQ && q0 + tid < S)  // a row with no key: +inf
    lse[(size_t)bh * S + q0 + tid] = row_l[tid] > 0.f ? row_m[tid] + logf(row_l[tid]) : INFINITY;
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
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Hq,
           int Hkv, int S, int D, long long q_sb, long long q_sh, long long q_ss, long long kv_sb,
           long long kv_sh, long long kv_ss, int causal, int window, int has_softcap,
           float softcap, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DP>();
  auto kern = flash_attention_kernel<T, DP>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((S + kBQ - 1) / kBQ, B * Hq);
  kern<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Hq,
                                         Hkv, S, D, q_sb, q_sh, q_ss, kv_sb, kv_sh, kv_ss, causal,
                                         window, has_softcap, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Hq,
             int Hkv, int S, int D, long long q_sb, long long q_sh, long long q_ss, long long kv_sb,
             long long kv_sh, long long kv_ss, int causal, int window, int has_softcap,
             float softcap, float scale, cudaStream_t stream) {
#define RT_FA_LAUNCH(DP)                                                                       \
  return launch<T, DP>(q, k, v, o, lse, B, Hq, Hkv, S, D, q_sb, q_sh, q_ss, kv_sb, kv_sh,    \
                       kv_ss, causal, window, has_softcap, softcap, scale, stream)
  if (D <= 32) RT_FA_LAUNCH(32);
  if (D <= 64) RT_FA_LAUNCH(64);
  if (D <= 128) RT_FA_LAUNCH(128);
  if (D <= 256) RT_FA_LAUNCH(256);
#undef RT_FA_LAUNCH
  return (int)cudaErrorInvalidValue;
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
template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack2(a, b, (T*)nullptr);
}

template <int D>
struct TcCfg {
  static constexpr int kBM = 128;                  // query rows a block
  static constexpr int kBK = D == 256 ? 64 : 128;  // keys a stage
  static constexpr int kAtoms = D / 64;            // 64-column atoms of a row
  static constexpr int kConsumers = 256;           // two warpgroups
  static constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
  // registers a thread after rebalancing (launch: 65536 / 384 = 168):
  // the producer gives back to 40, the consumers take 232 (at D = 256 the
  // output accumulator alone is 128)
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;
  static constexpr int kQAtom = kBM * 128, kKVAtom = kBK * 128;
  static constexpr int kQBytes = kAtoms * kQAtom, kKVBytes = kAtoms * kKVAtom;
  static constexpr int kStage = 2 * kKVBytes;       // K then V
  static constexpr size_t kSmem = (size_t)kQBytes + 2 * kStage + 5 * sizeof(uint64_t) + 1024;
};

constexpr float kLog2e = 1.4426950408889634f;

template <typename T, bool F16, int D>
__global__ void __launch_bounds__(TcCfg<D>::kThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                                 const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap, T* __restrict__ o,
                                 float* __restrict__ lse, int Hq, int Hkv, int S, int d,
                                 long long o_sb, long long o_sh, long long o_ss, int causal,
                                 int window, int has_softcap,
                                 float softcap, float scale) {
  using Cfg = TcCfg<D>;
  constexpr int BM = Cfg::kBM, BK = Cfg::kBK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* sq = smem;
  uint8_t* skv = smem + Cfg::kQBytes;  // stage s: K at s * kStage, V kKVBytes after
  uint64_t* qbar = reinterpret_cast<uint64_t*>(skv + 2 * Cfg::kStage);
  uint64_t* full = qbar + 1;
  uint64_t* empty = qbar + 3;

  const int nq = (S + BM - 1) / BM;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BM;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  // keys that any row of this block may see
  const int k_hi = causal ? min(S, q0 + BM) : S;
  const int k_lo = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int kb0 = k_lo / BK;
  const int nkb = max(0, (k_hi + BK - 1) / BK - kb0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(qbar, 1);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], Cfg::kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= Cfg::kConsumers / 32) {  // producer: one thread issues every load
    hopper::regs_release<Cfg::kProducerRegs>();
    if (warp == Cfg::kConsumers / 32 && lane == 0) {
      hopper::mbar_expect_tx(qbar, Cfg::kQBytes);
#pragma unroll
      for (int a = 0; a < Cfg::kAtoms; ++a)
        hopper::tma_load_4d(sq + a * Cfg::kQAtom, &qmap, qbar, 64 * a, q0, h, b);
      for (int i = 0; i < nkb; ++i) {
        const int s = i & 1;
        hopper::mbar_wait(&empty[s], ((i >> 1) & 1) ^ 1);
        uint8_t* kt = skv + s * Cfg::kStage;
        uint8_t* vt = kt + Cfg::kKVBytes;
        const int k0 = (kb0 + i) * BK;
        hopper::mbar_expect_tx(&full[s], Cfg::kStage);
#pragma unroll
        for (int a = 0; a < Cfg::kAtoms; ++a) {
          hopper::tma_load_4d(kt + a * Cfg::kKVAtom, &kmap, &full[s], 64 * a, k0, hk, b);
          hopper::tma_load_4d(vt + a * Cfg::kKVAtom, &vmap, &full[s], 64 * a, k0, hk, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows r_lo .. r_lo + 63; this thread
  // rows row0 and row0 + 8 of them
  hopper::regs_take<Cfg::kConsumerRegs>();
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);  // uniform, as the compiler sees it
  const int r_lo = q0 + 64 * wg, r_hi = r_lo + 63;
  const int row0 = r_lo + 16 * (warp % 4) + lane / 4;
  const int col0 = 2 * (lane % 4);
  // softcap: x = s * scale / softcap enters tanh as 2^(2 x log2 e)
  const float t_scale = has_softcap ? 2.f * kLog2e * scale / softcap : scale * kLog2e;
  const float t_cap = softcap * kLog2e;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const uint32_t qa = hopper::smem_u32(sq) + wg * (64 * 128);
  hopper::mbar_wait(qbar, 0);

  // Turns at the tensor cores (named barriers 1 and 2, warpgroup 0 first):
  // turn i issues O += P V of tile i - 1 and S = q K^T of tile i, then
  // waits once, while the other warpgroup runs its softmax.  Both
  // warpgroups compute every tile of the block's key range (a tile that one
  // warpgroup's rows cannot see is masked whole), so whether a wgmma is
  // issued depends on the loop count alone.
  uint32_t pf[BK / 16][4];  // P of the previous tile, in q's dtype
  float sc[BK / 2];         // S of this tile, fp32
  const int my_turn = 1 + wg, their_turn = 2 - wg;
  if (wg == 1) hopper::named_arrive(1, Cfg::kConsumers);
  for (int i = 0; i <= nkb; ++i) {  // the last turn only adds P V of the last tile
    const int s = i & 1;
    const int k0 = (kb0 + i) * BK;
    if (i < nkb) hopper::mbar_wait(&full[s], (i >> 1) & 1);
    const uint32_t kt = hopper::smem_u32(skv + s * Cfg::kStage);

    hopper::named_sync(my_turn, Cfg::kConsumers);
    hopper::fence_regs(acc);
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
    if (i > 0) {
      const uint32_t vt = hopper::smem_u32(skv + (s ^ 1) * Cfg::kStage) + Cfg::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hopper::wgmma_rs<D, F16, 1>(acc, pf[kk],
                                    hopper::smem_desc(vt + kk * 2048, Cfg::kKVAtom, 1024), 1);
    }
    if (i < nkb) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // the 16-column slice of its atom
        hopper::wgmma_ss<BK, F16, 0>(
            sc, hopper::smem_desc(qa + (kk / 4) * Cfg::kQAtom + off, 16, 1024),
            hopper::smem_desc(kt + (kk / 4) * Cfg::kKVAtom + off, 16, 1024), kk > 0);
      }
    }
    hopper::wgmma_commit();
    if (i < nkb || wg == 0) hopper::named_arrive(their_turn, Cfg::kConsumers);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(sc);
    if (i > 0) hopper::mbar_arrive(&empty[s ^ 1]);  // done with the previous tile
    if (i == nkb) break;

    // logits in the log2 domain: t = log2(e) * (softcapped) s * scale; the
    // branches stay outside the loops, so neither path pays for the other
    if (has_softcap) {  // tanh(x) = 1 - 2 / (e^2x + 1), exact to 2e-7 in fp32
#pragma unroll
      for (int e = 0; e < BK / 2; ++e)
        sc[e] = t_cap * (1.f - __fdividef(2.f, exp2f(sc[e] * t_scale) + 1.f));
    } else {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) sc[e] *= t_scale;
    }
    // masks, only on tiles that cross the diagonal, the window edge or S
    if (k0 + BK > S || (causal && k0 + BK - 1 > r_lo) || (window >= 0 && k0 <= r_hi - window)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int qpos = row0 + 8 * r, kpos = k0 + 8 * j + col0 + c;
            const bool ok = kpos < S && (!causal || qpos >= kpos) &&
                            (window < 0 || qpos - kpos < window);
            if (!ok) sc[4 * j + 2 * r + c] = -INFINITY;
          }
    }

    // online softmax on the fragments: 4 lanes share a row
    float corr[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // no key yet: p = 0, not NaN
      corr[r] = exp2f(m[r] - m_use[r]);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = exp2f(sc[4 * j + 2 * r] - m_use[r]);
        const float p1 = exp2f(sc[4 * j + 2 * r + 1] - m_use[r]);
        sum[r] += p0 + p1;
        pf[j / 2][2 * (j % 2) + r] = pack2(p0, p1, (T*)nullptr);
      }
    // the accumulator holds every earlier tile's P V: bring it to m
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        acc[4 * j + 2 * r] *= corr[r];
        acc[4 * j + 2 * r + 1] *= corr[r];
      }
  }

  // the row sums over the 4 lanes of a row, then out = acc / max(l, 1e-30)
  // on the head dim's d <= D columns (past d the accumulator holds the 0s
  // of V's zero-filled columns, which are not stored)
  T* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    // the row's log-sum-exp, natural log (m is in the log2 domain); a row
    // with no key: +inf
    if (lse != nullptr && lane % 4 == 0)
      lse[(size_t)bh * S + row] = lr > 0.f ? (m[r] + log2f(lr)) * 0.6931471805599453f : INFINITY;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (D == d || 8 * j < d)
        store2(ob + row * o_ss + 8 * j + col0, acc[4 * j + 2 * r] * inv,
               acc[4 * j + 2 * r + 1] * inv);
  }
}

// D: the template's head dim (64, 128 or 256); d <= D the tensors' own.
template <typename T, bool F16, int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Hq,
                 int Hkv, int S, int d, long long q_sb, long long q_sh, long long q_ss,
                 long long kv_sb, long long kv_sh, long long kv_ss, int causal, int window,
                 int has_softcap,
                 float softcap, float scale, cudaStream_t stream) {
  using Cfg = TcCfg<D>;
  // 4-D maps over (d, S, H, B) by byte strides; a head axis of extent 1 may
  // come with stride 0, which TMA refuses, so it gets the next axis' extent.
  // The boxes span D columns: those past d arrive as zeros
  auto make = [&](CUtensorMap* map, const void* ptr, int H, long long sb, long long sh,
                  long long ss, uint32_t rows) {
    if (H == 1) sh = ss * S;
    const uint64_t dims[4] = {(uint64_t)d, (uint64_t)S, (uint64_t)H, (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)ss * 2, (uint64_t)sh * 2, (uint64_t)sb * 2};
    const uint32_t box[4] = {64, rows, 1, 1};
    return hopper::make_tensor_map(map, F16, 4, ptr, dims, strides, box);
  };
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err = make(&qmap, q, Hq, q_sb, q_sh, q_ss, Cfg::kBM);
  if (err == cudaSuccess) err = make(&kmap, k, Hkv, kv_sb, kv_sh, kv_ss, Cfg::kBK);
  if (err == cudaSuccess) err = make(&vmap, v, Hkv, kv_sb, kv_sh, kv_ss, Cfg::kBK);
  auto kern = flash_attention_wgmma_kernel<T, F16, D>;
  if (err == cudaSuccess) err = hopper::allow_smem(kern, Cfg::kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + Cfg::kBM - 1) / Cfg::kBM, B * Hq);
  kern<<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(qmap, kmap, vmap, (T*)o, lse, Hq, Hkv, S, d,
                                                    q_sb, q_sh, q_ss, causal, window,
                                                    has_softcap, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool F16>
int launch_wgmma_d(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Hq, int Hkv, int S, int D, long long q_sb, long long q_sh, long long q_ss,
                   long long kv_sb, long long kv_sh, long long kv_ss, int causal, int window,
                   int has_softcap,
                   float softcap, float scale, cudaStream_t stream) {
#define RT_FA_WGMMA(DP)                                                                       \
  return launch_wgmma<T, F16, DP>(q, k, v, o, lse, B, Hq, Hkv, S, D, q_sb, q_sh, q_ss, kv_sb,  \
                                  kv_sh, kv_ss, causal, window, has_softcap, softcap, scale,  \
                                  stream)
  if (D == 64) RT_FA_WGMMA(64);
  if (D == 96 || D == 112 || D == 128) RT_FA_WGMMA(128);  // 96, 112: zero-filled to 128
  if (D == 256) RT_FA_WGMMA(256);
#undef RT_FA_WGMMA
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o: (B, S, Hq, D) and k, v: (B, S, Hkv, D) by element strides (batch,
// head, sequence; D contiguous), one dtype: 0 fp32, 1 bf16, 2 fp16.
// window < 0 means none; D <= 256.  route 0 = "simt", 1 = "wgmma" (bf16 /
// fp16, D of 64, 96, 112, 128 or 256, 16-byte-aligned bases and strides).
// lse: null, or (B, Hq, S) fp32 for the rows' natural log-sum-exp of the
// (softcapped, scaled) logits, +inf for a row that sees no key (the
// backward reads it).  Returns the cudaError_t of the launch.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o, void* lse,
                                  int dtype, int B, int Hq, int Hkv, int S, int D, long long q_sb,
                                  long long q_sh, long long q_ss, long long kv_sb, long long kv_sh,
                                  long long kv_ss, int causal, int window, int has_softcap,
                                  float softcap, float scale, int route, void* stream) {
  if (B == 0 || Hq == 0 || S == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (route == 1) {
    switch (dtype) {
      case 1:
        return launch_wgmma_d<__nv_bfloat16, false>(q, k, v, o, l, B, Hq, Hkv, S, D, q_sb, q_sh,
                                                    q_ss, kv_sb, kv_sh, kv_ss, causal, window,
                                                    has_softcap, softcap, scale, st);
      case 2:
        return launch_wgmma_d<__half, true>(q, k, v, o, l, B, Hq, Hkv, S, D, q_sb, q_sh, q_ss,
                                            kv_sb, kv_sh, kv_ss, causal, window, has_softcap,
                                            softcap, scale, st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch_d<float>(q, k, v, o, l, B, Hq, Hkv, S, D, q_sb, q_sh, q_ss, kv_sb, kv_sh,
                             kv_ss, causal, window, has_softcap, softcap, scale, st);
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, o, l, B, Hq, Hkv, S, D, q_sb, q_sh, q_ss, kv_sb,
                                     kv_sh, kv_ss, causal, window, has_softcap, softcap, scale,
                                     st);
    case 2:
      return launch_d<__half>(q, k, v, o, l, B, Hq, Hkv, S, D, q_sb, q_sh, q_ss, kv_sb, kv_sh,
                              kv_ss, causal, window, has_softcap, softcap, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
