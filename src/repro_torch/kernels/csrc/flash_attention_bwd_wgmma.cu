// Flash attention's backward, the "wgmma" route (bf16 / fp16 at head dims 64,
// 96, 112, 128 and 256): the dkv and dq kernels on warpgroup wgmma, fed by
// TMA.  The function, its bound and the design are described in
// flash_attention_bwd.cu; the shared parts are in flash_attention_bwd.cuh.
#include <type_traits>

#include "flash_attention_bwd.cuh"

namespace {

using namespace flash_bwd;

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

// D: the template's head dim (64, 128 or 256; 96 and 112 run 128).
template <int D>
struct WgCfg {
  static constexpr int kAtoms = D / 64;          // 64-column atoms of a row
  static constexpr int kAtom = 64 * 128;         // bytes of a 64-row atom
  static constexpr int kTile = kAtoms * kAtom;   // a 64 x D tile
  // dkv: two consumer warpgroups and a producer warpgroup, which gives
  // most of its registers to the consumers (setmaxnreg: 24 and 240 a
  // thread, from 168 at launch).  At D <= 128 each consumer warpgroup takes
  // 64 of the block's 128 keys and computes all four products (dK and dV
  // of 64 x D in its registers); at D = 256, where that would be 256 fp32
  // a thread, the two split the products of the block's 64 keys.  K and V
  // once; a ring of (q, dO, lse2, Delta) of 64 query rows (the row floats
  // in a 1024-byte slot, so the next stage stays aligned); at D = 256 the
  // 64 x 64 fp32 tile passed between the warpgroups
  static constexpr bool kByProduct = D == 256;
  static constexpr int kBN = kByProduct ? 64 : 128;  // keys of a dkv block
  static constexpr int kKAtom = kBN * 128;
  static constexpr int kKTile = kAtoms * kKAtom;
  static constexpr int kStages = D == 256 ? 2 : D == 128 ? 3 : 4;
  static constexpr int kKvThreads = 384;
  static constexpr int kProducerRegs = 24, kConsumerRegs = 240;
  static constexpr int kKvStage = 2 * kTile + 1024;
  static constexpr size_t kKvSmem = 2 * (size_t)kKTile + kStages * (size_t)kKvStage +
                                    (kByProduct ? 64 * 64 * 4 : 0) +
                                    (2 * kStages + 1) * sizeof(uint64_t) + 1024;
  // dq: one consumer warpgroup per 64 query rows (128 rows a block, 64 at
  // D = 256, where q, dO and two stages of K and V fill 192 KB) and a
  // producer warpgroup (with two consumer warpgroups it gives them its
  // registers, as in dkv); q and dO once, a ring of (K, V) of kBK keys
  // (128 at D = 64, where a thread's S, dP and dS of 64 x 128 fit beside
  // dQ, else 64)
  static constexpr int kBM = D == 256 ? 64 : 128;
  static constexpr int kQWGs = kBM / 64;
  static constexpr int kQThreads = 128 * (kQWGs + 1);
  static constexpr int kBK = D == 64 ? 128 : 64;
  static constexpr int kQStages = D == 256 ? 2 : 3;
  static constexpr int kQAtom = kBM * 128, kKvAtom = kBK * 128;
  static constexpr int kQBytes = kAtoms * kQAtom, kKvBytes = kAtoms * kKvAtom;
  static constexpr size_t kQSmem = 2 * (size_t)kQBytes + 2 * kQStages * (size_t)kKvBytes +
                                   (2 * kQStages + 1) * sizeof(uint64_t) + 1024;
};

// 2^x by the special function unit, results below 2^-126 flushed to 0
// (exp2f's handling of them cost an eighth of the kernels' time)
__device__ __forceinline__ float ex2f(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// p = exp2(t - lse2) of a logit s and the factor g that dS takes from it:
// dS = g (dP - Delta) scale, with g = p, or p (1 - tanh^2) under the
// softcap (tanh(x) = 1 - 2 / (e^2x + 1), as the forward takes it).  Taken
// for every element of a tile; the mask then zeroes p and g by selects
// (a condition around the exp made a branch of every element, and cost
// three quarters of the kernels' time).
template <bool CAP>
__device__ __forceinline__ void p_g(const Att& at, float s, float lse2, float& p, float& g) {
  if constexpr (CAP) {
    const float th = 1.f - __fdividef(2.f, ex2f(s * at.t_scale) + 1.f);
    p = ex2f(at.t_cap * th - lse2);
    g = p * (1.f - th * th);
  } else {
    p = ex2f(s * at.t_scale - lse2);
    g = p;
  }
}

// The A fragments (64 x N as N / 16 k16 fragments, in T) of a 64 x N
// accumulator: slice kk holds columns 16 kk .. 16 kk + 15.
template <typename T, int N>
__device__ __forceinline__ void to_frags(const float (&v)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      a[j / 2][2 * (j % 2) + r] = pack2(v[4 * j + 2 * r], v[4 * j + 2 * r + 1], (T*)nullptr);
}

// acc (64 x N) = X Y^T over the D columns of X (64 rows) and Y (N rows),
// both K-major, their 64-column atoms xa_atom and ya_atom bytes apart.
template <bool F16, int D, int N>
__device__ __forceinline__ void xyt(float (&acc)[N / 2], uint32_t xa, int xa_atom, uint32_t ya,
                                    int ya_atom) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;  // the 16-column slice of its atom
    hopper::wgmma_ss<N, F16, 0>(acc, hopper::smem_desc(xa + (kk / 4) * xa_atom + off, 16, 1024),
                                hopper::smem_desc(ya + (kk / 4) * ya_atom + off, 16, 1024),
                                kk > 0);
  }
}

// acc (64 x D) += A (64 x K, registers) Y, Y a K x D tile read N-major,
// its 64-column atoms ya_atom bytes apart.
template <bool F16, int D, int K>
__device__ __forceinline__ void ay(float (&acc)[D / 2], const uint32_t (&a)[K / 16][4],
                                   uint32_t ya, int ya_atom) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    hopper::wgmma_rs<D, F16, 1>(acc, a[kk], hopper::smem_desc(ya + kk * 2048, ya_atom, 1024), 1);
}

// Write rows r0 (+ 8) of a 64 x D accumulator to a (S, d) slice at `base`
// with row stride ss: rows below S, columns below d.
template <typename T, int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], T* base, long long ss,
                                           int r0, int col0, int S, int d) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (D == d || 8 * j < d)
        store2(base + (size_t)row * ss + 8 * j + col0, acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// dK and dV of kBN keys of kv head (b, hk): grid (ceil(S / kBN), B * Hkv),
// key tile 0 (under the causal mask the longest) first.  One thread of the
// producer warpgroup loads K and V once, then for each query head of the
// group and each 64-row query tile the mask leaves, q and dO into a ring of
// kStages; the lanes of its warp write the rows' lse2 and Delta beside
// them.  At D <= 128 warpgroup w takes keys 64 w .. 64 w + 63: S^T = K q^T
// and dP^T = V dO^T (one commit), P^T and dS^T on the fragments, dV += P^T
// dO and dK += dS^T q.  At D = 256 warpgroup 0 computes S^T, P^T from it,
// hands P^T (times 1 - tanh^2 under the softcap) to warpgroup 1 through
// shared memory and adds dV += P^T dO; warpgroup 1 computes dP^T, then dS^T
// from P^T, and adds dK += dS^T q.  Both warpgroups issue the same products
// (on other tiles), so whether a wgmma is issued depends on the loop count
// alone.
template <typename T, bool F16, int D>
__global__ void __launch_bounds__(WgCfg<D>::kKvThreads, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                        int Hq, int Hkv, long long kv_sb, long long kv_sh, long long kv_ss,
                        Att at) {
  using Cfg = WgCfg<D>;
  constexpr int BN = Cfg::kBN, NS = Cfg::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* sk = smem;
  uint8_t* sv = sk + Cfg::kKTile;
  uint8_t* stage0 = sv + Cfg::kKTile;  // stage s: q, dO, lse2[64], Delta[64]
  float* sp = reinterpret_cast<float*>(stage0 + NS * Cfg::kKvStage);  // [32][128] (D = 256)
  uint64_t* kvbar =
      reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(sp) + (Cfg::kByProduct ? 16384 : 0));
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + NS;

  const int k0 = blockIdx.x * BN;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv, rep = Hq / Hkv;
  int lo, hi;
  q_tiles(at, k0, BN, 64, lo, hi);
  const int nqt = hi - lo, items = rep * nqt;  // (head of the group, query tile)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kvbar, 1);
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&full[s], 33);  // the TMA bytes' arrival and the 32 lanes'
      hopper::mbar_init(&empty[s], 256);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer: lane 0 issues the loads, the lanes write the row floats
    hopper::regs_release<Cfg::kProducerRegs>();
    if (warp != 8) return;
    if (lane == 0) {
      hopper::mbar_expect_tx(kvbar, 2 * Cfg::kKTile);
#pragma unroll
      for (int a = 0; a < Cfg::kAtoms; ++a) {
        hopper::tma_load_4d(sk + a * Cfg::kKAtom, &kmap, kvbar, 64 * a, k0, hk, b);
        hopper::tma_load_4d(sv + a * Cfg::kKAtom, &vmap, kvbar, 64 * a, k0, hk, b);
      }
    }
    for (int it = 0; it < items; ++it) {
      const int s = it % NS;
      const int h = hk * rep + it / nqt, q0 = (lo + it % nqt) * 64;
      uint8_t* st = stage0 + s * Cfg::kKvStage;
      hopper::mbar_wait(&empty[s], ((it / NS) & 1) ^ 1);
      if (lane == 0) {
        hopper::mbar_expect_tx(&full[s], 2 * Cfg::kTile);
#pragma unroll
        for (int a = 0; a < Cfg::kAtoms; ++a) {
          hopper::tma_load_4d(st + a * Cfg::kAtom, &qmap, &full[s], 64 * a, q0, h, b);
          hopper::tma_load_4d(st + Cfg::kTile + a * Cfg::kAtom, &domap, &full[s], 64 * a, q0, h,
                              b);
        }
      }
      // rows past S: lse2 = +inf, so their p is 0
      float* rows = reinterpret_cast<float*>(st + 2 * Cfg::kTile);
      const size_t ro = (size_t)(b * Hq + h) * at.S;
      for (int t = lane; t < 64; t += 32) {
        const int r = q0 + t;
        rows[t] = r < at.S ? lse[ro + r] * kLog2e : INFINITY;
        rows[64 + t] = r < at.S ? delta[ro + r] : 0.f;
      }
      hopper::mbar_arrive(&full[s]);
    }
    return;
  }

  // consumers: this thread holds key rows row and row + 8 of its
  // warpgroup's 64, query columns 8 j + col0 (+ 1) of the scores
  hopper::regs_take<Cfg::kConsumerRegs>();
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);  // uniform, as the compiler sees it
  const int tid = threadIdx.x % 128;
  const int row = 16 * (warp % 4) + lane / 4, col0 = 2 * (lane % 4);
  const int r_lo = Cfg::kByProduct ? k0 : k0 + 64 * wg;  // this warpgroup's keys
  const long long kvo = b * kv_sb + hk * kv_sh;
  hopper::mbar_wait(kvbar, 0);

  if constexpr (Cfg::kByProduct) {
    float acc[D / 2];  // dV (warpgroup 0) or dK (1)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint32_t xa = hopper::smem_u32(wg == 0 ? sk : sv);
    for (int it = 0; it < items; ++it) {
      const int s = it % NS;
      const int q0 = (lo + it % nqt) * 64;
      uint8_t* st = stage0 + s * Cfg::kKvStage;
      const float* rows = reinterpret_cast<const float*>(st + 2 * Cfg::kTile);
      const uint32_t qa = hopper::smem_u32(st), da = qa + Cfg::kTile;
      hopper::mbar_wait(&full[s], (it / NS) & 1);

      // S^T = K q^T (warpgroup 0) or dP^T = V dO^T (1)
      float sc[32];
      hopper::wgmma_fence();
      xyt<F16, D, 64>(sc, xa, Cfg::kKAtom, wg == 0 ? qa : da, Cfg::kAtom);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      uint32_t af[4][4];
      if (wg == 0) {
        // P^T into sc, g into sp once warpgroup 1 has read the last tile's
        if (it > 0) hopper::named_sync(2, 256);
        auto pass = [&](auto cap_c) {
          constexpr bool kCap = decltype(cap_c)::value;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int e = 4 * j + 2 * r + c;
                float p, g;
                p_g<kCap>(at, sc[e], rows[8 * j + col0 + c], p, g);
                sc[e] = p;
                sp[e * 128 + tid] = g;
              }
        };
        if (at.cap) pass(std::true_type()); else pass(std::false_type());
        if (needs_mask(at, q0, 64, k0, 64)) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int c = 0; c < 2; ++c)
                if (!seen(at, q0 + 8 * j + col0 + c, k0 + row + 8 * r)) {
                  sc[4 * j + 2 * r + c] = 0.f;
                  sp[(4 * j + 2 * r + c) * 128 + tid] = 0.f;
                }
        }
        hopper::named_arrive(1, 256);
        to_frags<T, 64>(sc, af);  // P^T, rounded to T
      } else {
        hopper::named_sync(1, 256);  // g of this tile is in
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * j + 2 * r + c, m = 8 * j + col0 + c;
              sc[e] = sp[e * 128 + tid] * (sc[e] - rows[64 + m]) * at.scale;
            }
        if (it + 1 < items) hopper::named_arrive(2, 256);
        to_frags<T, 64>(sc, af);  // dS^T, rounded to T
      }

      // dV += P^T dO (warpgroup 0) or dK += dS^T q (1)
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      ay<F16, D, 64>(acc, af, wg == 0 ? da : qa, Cfg::kAtom);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::mbar_arrive(&empty[s]);
    }
    store_rows<T, D>(acc, (wg == 0 ? dv : dk) + kvo, kv_ss, r_lo + row, col0, at.S, at.D);
  } else {
    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    const uint32_t ka = hopper::smem_u32(sk) + wg * (64 * 128);
    const uint32_t va = hopper::smem_u32(sv) + wg * (64 * 128);
    for (int it = 0; it < items; ++it) {
      const int s = it % NS;
      const int q0 = (lo + it % nqt) * 64;
      uint8_t* st = stage0 + s * Cfg::kKvStage;
      const float* rows = reinterpret_cast<const float*>(st + 2 * Cfg::kTile);
      const uint32_t qa = hopper::smem_u32(st), da = qa + Cfg::kTile;
      hopper::mbar_wait(&full[s], (it / NS) & 1);

      // S^T = K q^T and dP^T = V dO^T on this warpgroup's keys
      float sc[32], dp[32];
      hopper::wgmma_fence();
      xyt<F16, D, 64>(sc, ka, Cfg::kKAtom, qa, Cfg::kAtom);
      xyt<F16, D, 64>(dp, va, Cfg::kKAtom, da, Cfg::kAtom);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);

      // P^T into sc, dS^T into dp, then the mask
      auto pass = [&](auto cap_c) {
        constexpr bool kCap = decltype(cap_c)::value;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * j + 2 * r + c, m = 8 * j + col0 + c;
              float p, g;
              p_g<kCap>(at, sc[e], rows[m], p, g);
              sc[e] = p;
              dp[e] = g * (dp[e] - rows[64 + m]) * at.scale;
            }
      };
      if (at.cap) pass(std::true_type()); else pass(std::false_type());
      if (needs_mask(at, q0, 64, r_lo, 64)) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (!seen(at, q0 + 8 * j + col0 + c, r_lo + row + 8 * r))
                sc[4 * j + 2 * r + c] = dp[4 * j + 2 * r + c] = 0.f;
      }
      uint32_t pf[4][4], df[4][4];
      to_frags<T, 64>(sc, pf);  // P^T, rounded to T
      to_frags<T, 64>(dp, df);  // dS^T, rounded to T

      // dV += P^T dO and dK += dS^T q
      hopper::fence_regs(acc_v);
      hopper::fence_regs(acc_k);
      hopper::wgmma_fence();
      ay<F16, D, 64>(acc_v, pf, da, Cfg::kAtom);
      ay<F16, D, 64>(acc_k, df, qa, Cfg::kAtom);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc_v);
      hopper::fence_regs(acc_k);
      hopper::mbar_arrive(&empty[s]);
    }
    store_rows<T, D>(acc_v, dv + kvo, kv_ss, r_lo + row, col0, at.S, at.D);
    store_rows<T, D>(acc_k, dk + kvo, kv_ss, r_lo + row, col0, at.S, at.D);
  }
}

// dQ of kBM query rows of head (b, h): grid (ceil(S / kBM), B * Hq), the
// last tiles (the longest causal rows) first.  One thread of the producer
// warpgroup loads q and dO once, then the K and V tiles of the kBK keys the
// mask leaves into a ring of kQStages.  Warpgroup w takes rows 64 w .. 64 w
// + 63: S = q K^T and dP = dO V^T (one commit), dS on the fragments, dQ +=
// dS K (K read N-major).
template <typename T, bool F16, int D>
__global__ void __launch_bounds__(WgCfg<D>::kQThreads, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq, int Hq, int Hkv,
                       long long q_sb, long long q_sh, long long q_ss, Att at) {
  using Cfg = WgCfg<D>;
  constexpr int BM = Cfg::kBM, BK = Cfg::kBK, NS = Cfg::kQStages;
  constexpr int kConsumers = 128 * Cfg::kQWGs;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* sq = smem;
  uint8_t* sdo = sq + Cfg::kQBytes;
  uint8_t* stage0 = sdo + Cfg::kQBytes;  // stage s: K, then V
  uint64_t* qbar = reinterpret_cast<uint64_t*>(stage0 + 2 * NS * Cfg::kKvBytes);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + NS;

  const int nq = (at.S + BM - 1) / BM;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BM;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq, hk = h / (Hq / Hkv);
  int lo, hi;
  k_tiles(at, q0, BM, BK, lo, hi);
  const int nkt = hi - lo;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(qbar, 1);
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // producer: one thread issues every load
    if constexpr (Cfg::kQWGs == 2) hopper::regs_release<Cfg::kProducerRegs>();
    if (warp == kConsumers / 32 && lane == 0) {
      hopper::mbar_expect_tx(qbar, 2 * Cfg::kQBytes);
#pragma unroll
      for (int a = 0; a < Cfg::kAtoms; ++a) {
        hopper::tma_load_4d(sq + a * Cfg::kQAtom, &qmap, qbar, 64 * a, q0, h, b);
        hopper::tma_load_4d(sdo + a * Cfg::kQAtom, &domap, qbar, 64 * a, q0, h, b);
      }
      for (int i = 0; i < nkt; ++i) {
        const int s = i % NS;
        hopper::mbar_wait(&empty[s], ((i / NS) & 1) ^ 1);
        uint8_t* kt = stage0 + s * 2 * Cfg::kKvBytes;
        const int k0 = (lo + i) * BK;
        hopper::mbar_expect_tx(&full[s], 2 * Cfg::kKvBytes);
#pragma unroll
        for (int a = 0; a < Cfg::kAtoms; ++a) {
          hopper::tma_load_4d(kt + a * Cfg::kKvAtom, &kmap, &full[s], 64 * a, k0, hk, b);
          hopper::tma_load_4d(kt + Cfg::kKvBytes + a * Cfg::kKvAtom, &vmap, &full[s], 64 * a, k0,
                              hk, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows r_lo .. r_lo + 63; this thread
  // rows row0 and row0 + 8 of them
  if constexpr (Cfg::kQWGs == 2) hopper::regs_take<Cfg::kConsumerRegs>();
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);  // uniform, as the compiler sees it
  const int r_lo = q0 + 64 * wg;
  const int row0 = r_lo + 16 * (warp % 4) + lane / 4, col0 = 2 * (lane % 4);
  float lse2[2], dlt[2];  // rows past S: lse2 = +inf, so their p is 0
  const size_t ro = (size_t)(b * Hq + h) * at.S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < at.S ? lse[ro + row] * kLog2e : INFINITY;
    dlt[r] = row < at.S ? delta[ro + row] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint32_t qa = hopper::smem_u32(sq) + wg * (64 * 128);
  const uint32_t da = hopper::smem_u32(sdo) + wg * (64 * 128);
  hopper::mbar_wait(qbar, 0);

  // Turns at the tensor cores with two warpgroups, as in dkv: turn i
  // issues dQ += dS K of tile i - 1 and S, dP of tile i, then waits once
  uint32_t af[BK / 16][4];  // dS of the previous tile, in T
  float sc[BK / 2], dp[BK / 2];
  constexpr bool kTurns = Cfg::kQWGs == 2;
  const int my_turn = 1 + wg, their_turn = 2 - wg;
  if (kTurns && wg == 1) hopper::named_arrive(1, kConsumers);
  for (int i = 0; i <= nkt; ++i) {  // the last turn only adds tile nkt - 1
    const int s = i % NS, sp_ = (i + NS - 1) % NS;
    const int k0 = (lo + i) * BK;
    const uint32_t kt = hopper::smem_u32(stage0 + s * 2 * Cfg::kKvBytes), vt = kt + Cfg::kKvBytes;
    const uint32_t kp = hopper::smem_u32(stage0 + sp_ * 2 * Cfg::kKvBytes);
    if (i < nkt) hopper::mbar_wait(&full[s], (i / NS) & 1);

    if (kTurns) hopper::named_sync(my_turn, kConsumers);
    hopper::fence_regs(acc);
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
    if (i > 0) ay<F16, D, BK>(acc, af, kp, Cfg::kKvAtom);  // dQ += dS K, the previous tile
    if (i < nkt) {  // S = q K^T and dP = dO V^T
      xyt<F16, D, BK>(sc, qa, Cfg::kQAtom, kt, Cfg::kKvAtom);
      xyt<F16, D, BK>(dp, da, Cfg::kQAtom, vt, Cfg::kKvAtom);
    }
    hopper::wgmma_commit();
    if (kTurns && (i < nkt || wg == 0)) hopper::named_arrive(their_turn, kConsumers);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    if (i > 0) hopper::mbar_arrive(&empty[sp_]);  // done with the previous tile
    if (i == nkt) break;

    // dS into dp, then the mask on tiles that cross S, the diagonal or the
    // window's edge
    auto pass = [&](auto cap_c) {
      constexpr bool kCap = decltype(cap_c)::value;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * r + c;
            float p, g;
            p_g<kCap>(at, sc[e], lse2[r], p, g);
            dp[e] = g * (dp[e] - dlt[r]) * at.scale;
          }
    };
    if (at.cap) pass(std::true_type()); else pass(std::false_type());
    if (needs_mask(at, r_lo, 64, k0, BK)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (!seen(at, row0 + 8 * r, k0 + 8 * j + col0 + c)) dp[4 * j + 2 * r + c] = 0.f;
    }
    to_frags<T, BK>(dp, af);  // dS, rounded to T
  }
  store_rows<T, D>(acc, dq + b * q_sb + h * q_sh, q_ss, row0, col0, at.S, at.D);
}

template <typename T, bool F16, int D>
int launch_wgmma(const Args& a, const Att& at, cudaStream_t st) {
  using Cfg = WgCfg<D>;
  // 4-D maps over (d, S, H, B) by byte strides, boxes of 64 columns (those
  // past d arrive as zeros) and `rows` rows; a head axis of extent 1 gets
  // the next axis' extent as its stride
  auto make = [&](CUtensorMap* map, const void* ptr, int H, long long sb, long long sh,
                  long long ss, uint32_t rows) {
    if (H == 1) sh = ss * at.S;
    const uint64_t dims[4] = {(uint64_t)at.D, (uint64_t)at.S, (uint64_t)H, (uint64_t)a.B};
    const uint64_t strides[3] = {(uint64_t)ss * 2, (uint64_t)sh * 2, (uint64_t)sb * 2};
    const uint32_t box[4] = {64, rows, 1, 1};
    return hopper::make_tensor_map(map, F16, 4, ptr, dims, strides, box);
  };
  CUtensorMap qmap, domap, kmap, vmap;
  cudaError_t e = cudaSuccess;
  if (a.need_dkv) {
    e = make(&kmap, a.k, a.Hkv, a.kv_sb, a.kv_sh, a.kv_ss, Cfg::kBN);
    if (e == cudaSuccess) e = make(&vmap, a.v, a.Hkv, a.kv_sb, a.kv_sh, a.kv_ss, Cfg::kBN);
    if (e == cudaSuccess) e = make(&qmap, a.q, a.Hq, a.q_sb, a.q_sh, a.q_ss, 64);
    if (e == cudaSuccess) e = make(&domap, a.dout, a.Hq, a.q_sb, a.q_sh, a.q_ss, 64);
    auto kern = flash_bwd_dkv_wgmma<T, F16, D>;
    if (e == cudaSuccess) e = hopper::allow_smem(kern, Cfg::kKvSmem);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3((at.S + Cfg::kBN - 1) / Cfg::kBN, a.B * a.Hkv), Cfg::kKvThreads, Cfg::kKvSmem,
           st>>>(
        qmap, kmap, vmap, domap, (const float*)a.lse, a.delta, (T*)a.dk, (T*)a.dv, a.Hq, a.Hkv,
        a.kv_sb, a.kv_sh, a.kv_ss, at);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (a.need_dq) {
    e = make(&kmap, a.k, a.Hkv, a.kv_sb, a.kv_sh, a.kv_ss, Cfg::kBK);
    if (e == cudaSuccess) e = make(&vmap, a.v, a.Hkv, a.kv_sb, a.kv_sh, a.kv_ss, Cfg::kBK);
    if (e == cudaSuccess) e = make(&qmap, a.q, a.Hq, a.q_sb, a.q_sh, a.q_ss, Cfg::kBM);
    if (e == cudaSuccess) e = make(&domap, a.dout, a.Hq, a.q_sb, a.q_sh, a.q_ss, Cfg::kBM);
    auto kern = flash_bwd_dq_wgmma<T, F16, D>;
    if (e == cudaSuccess) e = hopper::allow_smem(kern, Cfg::kQSmem);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3((at.S + Cfg::kBM - 1) / Cfg::kBM, a.B * a.Hq), Cfg::kQThreads, Cfg::kQSmem,
           st>>>(qmap, kmap, vmap, domap, (const float*)a.lse, a.delta, (T*)a.dq, a.Hq, a.Hkv,
                 a.q_sb, a.q_sh, a.q_ss, at);
    e = cudaGetLastError();
  }
  return (int)e;
}

template <typename T, bool F16>
int launch_wgmma_d(const Args& a, const Att& at, cudaStream_t st) {
  if (at.D == 64) return launch_wgmma<T, F16, 64>(a, at, st);
  if (at.D == 96 || at.D == 112 || at.D == 128) return launch_wgmma<T, F16, 128>(a, at, st);
  if (at.D == 256) return launch_wgmma<T, F16, 256>(a, at, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

int flash_bwd::run_wgmma(const Args& a, const Att& at, int dtype, cudaStream_t st) {
  switch (dtype) {
    case 1:
      return launch_wgmma_d<__nv_bfloat16, false>(a, at, st);
    case 2:
      return launch_wgmma_d<__half, true>(a, at, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
