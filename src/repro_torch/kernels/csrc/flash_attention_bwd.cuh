// Flash attention's backward: what its two translation units share.
// flash_attention_bwd.cu holds Delta's kernel, the "simt" route and the
// entry point; flash_attention_bwd_wgmma.cu the "wgmma" route (two files,
// so that nvcc builds them in parallel).  See flash_attention_bwd.cu for
// the function, the bound and the design.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash_bwd {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half(v); }
// v rounded to T and back
__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float round_to(float v, __half*) {
  return __half2float(__float2half(v));
}

constexpr float kLog2e = 1.4426950408889634f;

// The attention's variant, as every kernel here reads it.  Logits are in
// the log2 domain: t2 = log2(e) t, so p = exp2(t2 - lse2) with lse2 =
// log2(e) lse.
struct Att {
  int S, D, causal, window, cap;
  float t_scale;  // no softcap: scale log2(e); softcap: 2 log2(e) scale / softcap
  float t_cap;    // softcap log2(e)
  float scale;
};

// Whether (qpos, kpos) is seen.
__device__ __forceinline__ bool seen(const Att& at, int qpos, int kpos) {
  return qpos < at.S && kpos < at.S && (!at.causal || qpos >= kpos) &&
         (at.window < 0 || qpos - kpos < at.window);
}

// p and dS of one (query, key) pair from its score s = q . k, dp = dO . v,
// and its row's lse2 and Delta.  tanh(x) = 1 - 2 / (e^2x + 1), as the
// forward takes it.
__device__ __forceinline__ void p_ds(const Att& at, float s, float dp, float lse2, float delta,
                                     float& p, float& ds) {
  if (at.cap) {
    const float th = 1.f - __fdividef(2.f, exp2f(s * at.t_scale) + 1.f);
    p = exp2f(at.t_cap * th - lse2);
    ds = p * (dp - delta) * at.scale * (1.f - th * th);
  } else {
    p = exp2f(s * at.t_scale - lse2);
    ds = p * (dp - delta) * at.scale;
  }
}

// The query tiles [lo, hi) of `bm` rows that see some key of [k0, k0 + bn).
__device__ __forceinline__ void q_tiles(const Att& at, int k0, int bn, int bm, int& lo,
                                        int& hi) {
  const int q_lo = at.causal ? k0 : 0;
  const int q_hi = at.window >= 0 ? min(at.S, k0 + bn - 1 + at.window) : at.S;
  lo = q_lo / bm;
  hi = max(lo, (q_hi + bm - 1) / bm);
}

// The key tiles [lo, hi) of `bn` keys that some row of [q0, q0 + bm) sees.
__device__ __forceinline__ void k_tiles(const Att& at, int q0, int bm, int bn, int& lo,
                                        int& hi) {
  const int k_hi = at.causal ? min(at.S, q0 + bm) : at.S;
  const int k_lo = at.window >= 0 ? max(0, q0 - at.window + 1) : 0;
  lo = k_lo / bn;
  hi = max(lo, (k_hi + bn - 1) / bn);
}

// Whether a (query tile, key tile) pair needs the mask: it crosses S, the
// causal diagonal or the window's edge.
__device__ __forceinline__ bool needs_mask(const Att& at, int q0, int bm, int k0, int bn) {
  return q0 + bm > at.S || k0 + bn > at.S || (at.causal && q0 < k0 + bn - 1) ||
         (at.window >= 0 && q0 + bm - 1 - k0 >= at.window);
}

struct Args {
  const void *q, *k, *v, *o, *lse, *dout;
  void *dq, *dk, *dv;
  float* delta;
  int B, Hq, Hkv;
  long long q_sb, q_sh, q_ss, kv_sb, kv_sh, kv_ss;
  int need_dq, need_dkv;
};

// The "wgmma" route's dkv and dq kernels (flash_attention_bwd_wgmma.cu)
// for dtype 1 (bf16) or 2 (fp16), after Delta's kernel; the cudaError_t of
// the first launch that failed, else 0.
int run_wgmma(const Args& a, const Att& at, int dtype, cudaStream_t st);

}  // namespace flash_bwd
