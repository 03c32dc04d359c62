// Flash attention's backward, the "mma" route (bf16 / fp16 at head dims 64,
// 96, 112, 128 and 256): the dkv and dq kernels on warp-level mma.sync.
// The function, its bound and the design are described in
// flash_attention_bwd.cu; the shared parts are in flash_attention_bwd.cuh.
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

template <int DP>
struct MmaCfg {
  static constexpr int kBT = 64;                  // rows of every tile
  static constexpr int kSplit = DP == 256 ? 2 : 1;  // warp sets over the output columns
  static constexpr int kThreads = 128 * kSplit;
  static constexpr int kCols = DP / kSplit;       // output columns of a warp
  static constexpr int kNP = 4 / kSplit;          // pairs of 8-column score tiles a warp
  static constexpr int kRow = (DP + 8) * 2;       // bytes of a padded tile row
  static constexpr int kTile = kBT * kRow;
  // two fixed tiles, then two stages of two tiles and 2 x 64 row floats
  static constexpr int kStage = 2 * kTile + 2 * kBT * 4;
  // with two warp sets, each computes half of the 64 x 64 scores and they
  // trade P and dS through two 16-bit tiles
  static constexpr int kXRow = (kBT + 8) * 2;
  static constexpr int kX = kBT * kXRow;
  static constexpr size_t kSmem =
      2 * (size_t)kTile + 2 * (size_t)kStage + (kSplit == 2 ? 2 * (size_t)kX : 0);
};

// Start the cp.async copies of rows [r0, r0 + 64) of a (B, S, H, D) tensor
// at `base` into a padded tile: 16-byte pieces, zeros past S and past d.
template <typename T, int DP>
__device__ __forceinline__ void mma_stage(const T* __restrict__ base, long long ss, int r0,
                                          int S, int d, uint8_t* dst) {
  using Cfg = MmaCfg<DP>;
  constexpr int kPieces = DP / 8;
  for (int i = threadIdx.x; i < Cfg::kBT * kPieces; i += Cfg::kThreads) {
    const int r = i / kPieces, c8 = i % kPieces;
    const bool ok = r0 + r < S && 8 * c8 < d;
    hopper::cp_async16(dst + r * Cfg::kRow + 16 * c8,
                       ok ? base + (size_t)(r0 + r) * ss + 8 * c8 : base, ok);
  }
}

// acc (16 x 16 NP: 2 NP tiles of 16 x 8) = X[r0 .. r0 + 15] Y[n0 .. n0 + 16
// NP - 1]^T over the first `d` (a multiple of 16, rounded up) columns of
// two padded tiles.
template <bool F16, int DP, int NP>
__device__ __forceinline__ void mma_xyt(float (&acc)[2 * NP][4], uint32_t xs, uint32_t ys,
                                        int r0, int n0, int d, int lane) {
  using Cfg = MmaCfg<DP>;
#pragma unroll
  for (int j = 0; j < 2 * NP; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    if (16 * kk >= d) break;
    uint32_t a[4];
    hopper::ldsm_x4(a, hopper::frag_a_addr(xs, Cfg::kRow, r0, 16 * kk, lane));
#pragma unroll
    for (int n2 = 0; n2 < NP; ++n2) {
      uint32_t b[4];
      hopper::ldsm_x4(b, hopper::frag_b_addr(ys, Cfg::kRow, n0 + 16 * n2, 16 * kk, lane));
      hopper::mma16816<F16>(acc[2 * n2], a, b[0], b[1]);
      hopper::mma16816<F16>(acc[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x kCols: columns c0 .. of this warp) += A (16 x 64, four k16
// fragments in registers) Y[0 .. 63][c0 ..] with Y a padded tile stored
// k-major; columns at or past d skipped.
template <bool F16, int DP>
__device__ __forceinline__ void mma_ay(float (&acc)[MmaCfg<DP>::kCols / 8][4],
                                       const uint32_t (&a)[4][4], uint32_t ys, int c0, int d,
                                       int lane) {
  using Cfg = MmaCfg<DP>;
#pragma unroll
  for (int n2 = 0; n2 < Cfg::kCols / 16; ++n2) {
    if (c0 + 16 * n2 >= d) break;
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      uint32_t b[4];
      hopper::ldsm_x4_t(b, hopper::frag_bt_addr(ys, Cfg::kRow, c0 + 16 * n2, 16 * kq, lane));
      hopper::mma16816<F16>(acc[2 * n2], a[kq], b[0], b[1]);
      hopper::mma16816<F16>(acc[2 * n2 + 1], a[kq], b[2], b[3]);
    }
  }
}

// Columns n0 .. n0 + 31 of rows r0 .. r0 + 15 of a 64 x 64 16-bit tile
// (rows kXRow bytes apart) from a 16 x 32 accumulator, in T.
template <typename T, int DP>
__device__ __forceinline__ void put_half(const float (&v)[4][4], uint8_t* tile, int r0, int n0,
                                         int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(tile + (r0 + lane / 4 + 8 * i) * MmaCfg<DP>::kXRow +
                                   2 * (n0 + 8 * j + 2 * (lane % 4))) =
          pack2(v[j][2 * i], v[j][2 * i + 1], (T*)nullptr);
}

// The A fragments of rows r0 .. r0 + 15 (all 64 columns) of such a tile.
template <int DP>
__device__ __forceinline__ void get_frags(uint32_t tile, int r0, uint32_t (&a)[4][4],
                                          int lane) {
#pragma unroll
  for (int kq = 0; kq < 4; ++kq)
    hopper::ldsm_x4(a[kq], hopper::frag_a_addr(tile, MmaCfg<DP>::kXRow, r0, 16 * kq, lane));
}

// The A fragments (16 x 64 as four k16 fragments) of a 16 x 64 accumulator.
template <typename T>
__device__ __forceinline__ void to_frags(const float (&acc)[8][4], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kq = 0; kq < 4; ++kq) {
    a[kq][0] = pack2(acc[2 * kq][0], acc[2 * kq][1], (T*)nullptr);
    a[kq][1] = pack2(acc[2 * kq][2], acc[2 * kq][3], (T*)nullptr);
    a[kq][2] = pack2(acc[2 * kq + 1][0], acc[2 * kq + 1][1], (T*)nullptr);
    a[kq][3] = pack2(acc[2 * kq + 1][2], acc[2 * kq + 1][3], (T*)nullptr);
  }
}

// Write a 16 x kCols accumulator (rows r0 + lane / 4 (+ 8), columns c0 ..)
// to a (S, D) slice at `base` with row stride ss: rows below S, columns
// below d.
template <typename T, int DP>
__device__ __forceinline__ void mma_store(const float (&acc)[MmaCfg<DP>::kCols / 8][4],
                                          T* base, long long ss, int r0, int c0, int S, int d,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + lane / 4 + 8 * i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < MmaCfg<DP>::kCols / 8; ++j) {
      const int c = c0 + 8 * j + 2 * (lane % 4);
      if (c < d) store2(base + (size_t)r * ss + c, acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

// dK and dV of 64 keys of kv head (b, hk): grid (ceil(S / 64), B * Hkv).
// Warp w takes keys 16 (w % 4) .. + 15 and output columns (w / 4) kCols ..;
// with two warp sets (D = 256) set h computes the scores of query columns
// 32 h .. 32 h + 31 and the sets trade P and dS in shared memory.
template <typename T, bool F16, int DP>
__global__ void __launch_bounds__(MmaCfg<DP>::kThreads, 1)
    flash_bwd_dkv_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int Hq, int Hkv, long long q_sb, long long q_sh, long long q_ss,
                      long long kv_sb, long long kv_sh, long long kv_ss, Att at) {
  using Cfg = MmaCfg<DP>;
  constexpr int BT = Cfg::kBT;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ks = smem_raw;
  uint8_t* vs = ks + Cfg::kTile;
  auto stage = [&](int s) { return vs + Cfg::kTile + s * Cfg::kStage; };  // q, dO, lse2, Delta
  uint8_t* xp = stage(2);  // the traded P^T and dS^T (two warp sets)
  uint8_t* xd = xp + Cfg::kX;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * (warp % 4), c0 = (warp / 4) * Cfg::kCols;
  const int n0 = Cfg::kSplit == 2 ? 32 * (warp / 4) : 0;  // this warp's score columns
  const int k0 = blockIdx.x * BT;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv, rep = Hq / Hkv;
  const size_t kvo = (size_t)b * kv_sb + (size_t)hk * kv_sh;
  int lo, hi;
  q_tiles(at, k0, BT, BT, lo, hi);
  const int nqt = hi - lo, items = rep * nqt;  // (head of the group, query tile)

  auto load = [&](int it) {
    const int h = hk * rep + it / nqt, q0 = (lo + it % nqt) * BT;
    uint8_t* st = stage(it & 1);
    const size_t qo = (size_t)b * q_sb + (size_t)h * q_sh;
    mma_stage<T, DP>(q + qo, q_ss, q0, at.S, at.D, st);
    mma_stage<T, DP>(dout + qo, q_ss, q0, at.S, at.D, st + Cfg::kTile);
    float* rows = reinterpret_cast<float*>(st + 2 * Cfg::kTile);
    const size_t ro = (size_t)(b * Hq + h) * at.S;
    for (int t = threadIdx.x; t < BT; t += Cfg::kThreads) {
      const int s = q0 + t;
      rows[t] = s < at.S ? lse[ro + s] * kLog2e : 0.f;
      rows[BT + t] = s < at.S ? delta[ro + s] : 0.f;
    }
  };
  mma_stage<T, DP>(k + kvo, kv_ss, k0, at.S, at.D, ks);
  mma_stage<T, DP>(v + kvo, kv_ss, k0, at.S, at.D, vs);
  if (items > 0) load(0);
  hopper::cp_async_commit();

  float acc_k[Cfg::kCols / 8][4], acc_v[Cfg::kCols / 8][4];
#pragma unroll
  for (int j = 0; j < Cfg::kCols / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;
  const uint32_t ka = hopper::smem_u32(ks), va = hopper::smem_u32(vs);

  for (int it = 0; it < items; ++it) {
    if (it + 1 < items) load(it + 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();  // tile it is in
    const int q0 = (lo + it % nqt) * BT;
    uint8_t* st = stage(it & 1);
    const uint32_t qa = hopper::smem_u32(st), da = qa + Cfg::kTile;
    const float* lse2 = reinterpret_cast<const float*>(st + 2 * Cfg::kTile);
    const float* dlt = lse2 + BT;

    // S^T = K q^T and dP^T = V dO^T: rows are keys, columns query rows
    constexpr int NP = Cfg::kNP;
    float sc[2 * NP][4], dp[2 * NP][4];
    mma_xyt<F16, DP, NP>(sc, ka, qa, r0, n0, at.D, lane);
    mma_xyt<F16, DP, NP>(dp, va, da, r0, n0, at.D, lane);
    const bool mask = needs_mask(at, q0, BT, k0, BT);
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = n0 + 8 * j + 2 * (lane % 4) + (e & 1);  // query row in the tile
        const int n = k0 + r0 + lane / 4 + 8 * (e >> 1);      // key
        float p = 0.f, ds = 0.f;
        if (!mask || seen(at, q0 + m, n)) p_ds(at, sc[j][e], dp[j][e], lse2[m], dlt[m], p, ds);
        sc[j][e] = p;
        dp[j][e] = ds;
      }
    uint32_t pa[4][4], dsa[4][4];
    if constexpr (Cfg::kSplit == 1) {
      to_frags<T>(sc, pa);
      to_frags<T>(dp, dsa);
    } else {
      put_half<T, DP>(sc, xp, r0, n0, lane);
      put_half<T, DP>(dp, xd, r0, n0, lane);
      __syncthreads();  // both halves of P^T and dS^T are in
      get_frags<DP>(hopper::smem_u32(xp), r0, pa, lane);
      get_frags<DP>(hopper::smem_u32(xd), r0, dsa, lane);
    }
    mma_ay<F16, DP>(acc_v, pa, da, c0, at.D, lane);   // dV += P^T dO
    mma_ay<F16, DP>(acc_k, dsa, qa, c0, at.D, lane);  // dK += dS^T q
    __syncthreads();  // done with stage it & 1 before tile it + 2 is copied there
  }
  hopper::cp_async_wait<0>();
  mma_store<T, DP>(acc_k, dk + kvo, kv_ss, k0 + r0, c0, at.S, at.D, lane);
  mma_store<T, DP>(acc_v, dv + kvo, kv_ss, k0 + r0, c0, at.S, at.D, lane);
}

// dQ of 64 query rows of head (b, h): grid (ceil(S / 64), B * Hq), the last
// tiles first.  Warp w takes rows 16 (w % 4) .. + 15 and output columns
// (w / 4) kCols ..; with two warp sets (D = 256) set h computes the scores
// of keys 32 h .. 32 h + 31 and the sets trade dS in shared memory.
template <typename T, bool F16, int DP>
__global__ void __launch_bounds__(MmaCfg<DP>::kThreads, 1)
    flash_bwd_dq_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq, int Hq, int Hkv,
                     long long q_sb, long long q_sh, long long q_ss, long long kv_sb,
                     long long kv_sh, long long kv_ss, Att at) {
  using Cfg = MmaCfg<DP>;
  constexpr int BT = Cfg::kBT;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* qs = smem_raw;
  uint8_t* dos = qs + Cfg::kTile;
  auto stage = [&](int s) { return dos + Cfg::kTile + s * Cfg::kStage; };  // K, V
  uint8_t* xd = stage(2);  // the traded dS (two warp sets)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * (warp % 4), c0 = (warp / 4) * Cfg::kCols;
  const int n0 = Cfg::kSplit == 2 ? 32 * (warp / 4) : 0;  // this warp's score columns
  const int nq = (at.S + BT - 1) / BT;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BT;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq, hk = h / (Hq / Hkv);
  const size_t qo = (size_t)b * q_sb + (size_t)h * q_sh;
  const size_t kvo = (size_t)b * kv_sb + (size_t)hk * kv_sh;
  int lo, hi;
  k_tiles(at, q0, BT, BT, lo, hi);
  const int items = hi - lo;

  auto load = [&](int it) {
    uint8_t* st = stage(it & 1);
    mma_stage<T, DP>(k + kvo, kv_ss, (lo + it) * BT, at.S, at.D, st);
    mma_stage<T, DP>(v + kvo, kv_ss, (lo + it) * BT, at.S, at.D, st + Cfg::kTile);
  };
  mma_stage<T, DP>(q + qo, q_ss, q0, at.S, at.D, qs);
  mma_stage<T, DP>(dout + qo, q_ss, q0, at.S, at.D, dos);
  if (items > 0) load(0);
  hopper::cp_async_commit();
  // this thread's rows q0 + r0 + lane / 4 (+ 8)
  float lse2[2], dlt[2];
  const size_t ro = (size_t)(b * Hq + h) * at.S;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = q0 + r0 + lane / 4 + 8 * i;
    lse2[i] = s < at.S ? lse[ro + s] * kLog2e : 0.f;
    dlt[i] = s < at.S ? delta[ro + s] : 0.f;
  }

  float acc[Cfg::kCols / 8][4];
#pragma unroll
  for (int j = 0; j < Cfg::kCols / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const uint32_t qa = hopper::smem_u32(qs), da = hopper::smem_u32(dos);

  for (int it = 0; it < items; ++it) {
    if (it + 1 < items) load(it + 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();  // tile it is in
    const int k0 = (lo + it) * BT;
    const uint32_t ka = hopper::smem_u32(stage(it & 1)), va = ka + Cfg::kTile;

    constexpr int NP = Cfg::kNP;
    float sc[2 * NP][4], dp[2 * NP][4];
    mma_xyt<F16, DP, NP>(sc, qa, ka, r0, n0, at.D, lane);  // S = q K^T
    mma_xyt<F16, DP, NP>(dp, da, va, r0, n0, at.D, lane);  // dP = dO V^T
    const bool mask = needs_mask(at, q0, BT, k0, BT);
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int m = q0 + r0 + lane / 4 + 8 * i;                 // query row
        const int n = k0 + n0 + 8 * j + 2 * (lane % 4) + (e & 1);  // key
        float p = 0.f, ds = 0.f;
        if (!mask || seen(at, m, n)) p_ds(at, sc[j][e], dp[j][e], lse2[i], dlt[i], p, ds);
        dp[j][e] = ds;
      }
    uint32_t dsa[4][4];
    if constexpr (Cfg::kSplit == 1) {
      to_frags<T>(dp, dsa);
    } else {
      put_half<T, DP>(dp, xd, r0, n0, lane);
      __syncthreads();  // both halves of dS are in
      get_frags<DP>(hopper::smem_u32(xd), r0, dsa, lane);
    }
    mma_ay<F16, DP>(acc, dsa, ka, c0, at.D, lane);  // dQ += dS K
    __syncthreads();  // done with stage it & 1 before tile it + 2 is copied there
  }
  hopper::cp_async_wait<0>();
  mma_store<T, DP>(acc, dq + qo, q_ss, q0 + r0, c0, at.S, at.D, lane);
}

template <typename T, bool F16, int DP>
int launch_mma(const Args& a, const Att& at, cudaStream_t st) {
  using Cfg = MmaCfg<DP>;
  auto kkv = flash_bwd_dkv_mma<T, F16, DP>;
  auto kq = flash_bwd_dq_mma<T, F16, DP>;
  cudaError_t e = hopper::allow_smem(kkv, Cfg::kSmem);
  if (e == cudaSuccess) e = hopper::allow_smem(kq, Cfg::kSmem);
  if (e != cudaSuccess) return (int)e;
  const int nt = (at.S + Cfg::kBT - 1) / Cfg::kBT;
  if (a.need_dkv) {
    kkv<<<dim3(nt, a.B * a.Hkv), Cfg::kThreads, Cfg::kSmem, st>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, (const float*)a.lse,
        a.delta, (T*)a.dk, (T*)a.dv, a.Hq, a.Hkv, a.q_sb, a.q_sh, a.q_ss, a.kv_sb, a.kv_sh,
        a.kv_ss, at);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (a.need_dq) {
    kq<<<dim3(nt, a.B * a.Hq), Cfg::kThreads, Cfg::kSmem, st>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, (const float*)a.lse,
        a.delta, (T*)a.dq, a.Hq, a.Hkv, a.q_sb, a.q_sh, a.q_ss, a.kv_sb, a.kv_sh, a.kv_ss, at);
    e = cudaGetLastError();
  }
  return (int)e;
}

template <typename T, bool F16>
int launch_mma_d(const Args& a, const Att& at, cudaStream_t st) {
  if (at.D == 64) return launch_mma<T, F16, 64>(a, at, st);
  if (at.D == 96 || at.D == 112 || at.D == 128) return launch_mma<T, F16, 128>(a, at, st);
  if (at.D == 256) return launch_mma<T, F16, 256>(a, at, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

int flash_bwd::run_mma(const Args& a, const Att& at, int dtype, cudaStream_t st) {
  switch (dtype) {
    case 1:
      return launch_mma_d<__nv_bfloat16, false>(a, at, st);
    case 2:
      return launch_mma_d<__half, true>(a, at, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
