// The parts of the SSD chunk's "wgmma" route that its forward (ssd_scan.cu)
// and its backward (ssd_scan_bwd.cu) share: 64-row tiles of bf16 in the
// 128-byte-swizzled layout of hopper.cuh, fp32 and fp16 values split three
// ways into them (hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi -
// mid)), the order of the six leading part products, the cp.async staging
// of the next tile, and the accumulation of a product one 16-deep slice at
// a time in fp32 (`slices`).  See ssd_scan.cu's "wgmma" route for why.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace ssd_wgmma {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

constexpr int kTcThreads = 128;         // one warpgroup a block
constexpr int kTcRows = 64;             // rows l of a strip, rows s of a block
constexpr int kTcAtom = kTcRows * 128;  // bytes of one 64-column atom

// the part products summed for two split operands, q = 0 .. 5: part
// pair_a(q) of A times part pair_b(q) of B, i.e. (hi, hi), (hi, mid),
// (mid, hi), (mid, mid), (hi, lo), (lo, hi); constant once unrolled
__host__ __device__ constexpr int pair_a(int q) { return q == 2 || q == 3 ? 1 : q == 5 ? 2 : 0; }
__host__ __device__ constexpr int pair_b(int q) { return q == 1 || q == 3 ? 1 : q == 4 ? 2 : 0; }
// the order the part products are issued in: smallest first, hi * hi last
__host__ __device__ constexpr int pair_order(int i) {
  return i == 0 ? 4 : i == 1 ? 5 : i == 2 ? 3 : i == 3 ? 1 : i == 4 ? 2 : 0;
}

template <typename T>
struct TcIn {
  static constexpr int kParts = std::is_same<T, __nv_bfloat16>::value ? 1 : 3;  // bf16 tiles
  static constexpr int kBufs = kParts == 1 ? 2 : 1;  // tile buffers of the streamed blocks
};

// Shared-memory bytes of one 64 x WT bf16 tile.
template <int WT>
__host__ __device__ constexpr int tile_bytes() { return WT / 64 * kTcAtom; }

// Row stride of the staging area of a 64 x WT block of T: 16 bytes of
// padding, so that rows two apart do not share a bank.
template <typename T, int WT>
__host__ __device__ constexpr int stage_row() { return WT * (int)sizeof(T) + 16; }
template <typename T, int WT>
__host__ __device__ constexpr int stage_bytes() {
  return TcIn<T>::kParts == 1 ? 0 : kTcRows * stage_row<T, WT>();
}

// The byte offset of 16-byte chunk c8 of row r in a swizzled tile.
__device__ __forceinline__ uint32_t swz(int r, int c8) {
  return (c8 / 8) * kTcAtom + r * 128 + (((c8 % 8) ^ (r & 7)) << 4);
}

using hopper::split3;  // (a, b) -> packed bf16 hi, mid, lo pairs

// Split 8 values into the three tiles at `dst` (tile_bytes apart), chunk
// offset `off`.
template <typename T, int WT>
__device__ __forceinline__ void put8(const float (&f)[8], uint8_t* dst, uint32_t off) {
  uint4 h, m, l;
  split3(f[0], f[1], h.x, m.x, l.x);
  split3(f[2], f[3], h.y, m.y, l.y);
  split3(f[4], f[5], h.z, m.z, l.z);
  split3(f[6], f[7], h.w, m.w, l.w);
  *reinterpret_cast<uint4*>(dst + off) = h;
  *reinterpret_cast<uint4*>(dst + tile_bytes<WT>() + off) = m;
  *reinterpret_cast<uint4*>(dst + 2 * tile_bytes<WT>() + off) = l;
}

// 8 values of T at p (16-byte aligned, global or shared) as floats.
template <typename T>
__device__ __forceinline__ void get8(const T* p, float (&f)[8]) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] = to_f32(e[k]);
  }
}

// Rows r0 .. r0 + 63 of the (rows, W) row-major tensor `src` (W a multiple
// of 16; 16-byte-aligned rows) as a 64 x WT block, rows past `rows` and
// columns past W zero.  load_tile writes the tile(s) at `dst` at once (the
// C strip); stage_tile starts cp.async copies of it: into the swizzled tile
// at `dst` for bf16, into the staging area at `dst` for the other types,
// which convert_tile then splits into the tiles.  Consecutive threads take
// consecutive 16-byte pieces of a row, so the copies coalesce.
template <typename T, int WT, int NTHR>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int r0, int rows, int W,
                                          uint8_t* dst, int tid) {
  constexpr int kRowChunks = WT / 8;
  constexpr int kPer = kTcRows * kRowChunks / NTHR;
#pragma unroll 4
  for (int i = 0; i < kPer; ++i) {
    const int ch = i * NTHR + tid;
    const int r = ch / kRowChunks, c8 = ch % kRowChunks;
    const bool ok = r0 + r < rows && c8 * 8 < W;
    if constexpr (TcIn<T>::kParts == 1) {
      uint4 h = make_uint4(0, 0, 0, 0);
      if (ok) h = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * W + c8 * 8));
      *reinterpret_cast<uint4*>(dst + swz(r, c8)) = h;
    } else {
      float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (ok) get8(src + (size_t)(r0 + r) * W + c8 * 8, f);
      put8<T, WT>(f, dst, swz(r, c8));
    }
  }
}

template <typename T, int WT, int NTHR>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src, int r0, int rows, int W,
                                           uint8_t* dst) {
  constexpr int kPiece = 16 / (int)sizeof(T);  // values a 16-byte piece
  constexpr int kRowPieces = WT / kPiece;
  constexpr int kPer = kTcRows * kRowPieces / NTHR;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int pc = i * NTHR + threadIdx.x;
    const int r = pc / kRowPieces, e0 = (pc % kRowPieces) * kPiece;
    const bool ok = r0 + r < rows && e0 < W;
    const T* g = ok ? src + (size_t)(r0 + r) * W + e0 : src;
    const uint32_t off =
        TcIn<T>::kParts == 1 ? swz(r, e0 / 8) : r * stage_row<T, WT>() + e0 * (int)sizeof(T);
    hopper::cp_async16(dst + off, g, ok);
  }
}

template <typename T, int WT, int NTHR>
__device__ __forceinline__ void convert_tile(const uint8_t* stage, uint8_t* dst) {
  constexpr int kRowChunks = WT / 8;
  constexpr int kPer = kTcRows * kRowChunks / NTHR;
#pragma unroll 4
  for (int i = 0; i < kPer; ++i) {
    const int ch = i * NTHR + threadIdx.x;
    const int r = ch / kRowChunks, c8 = ch % kRowChunks;
    float f[8];
    get8(reinterpret_cast<const T*>(stage + r * stage_row<T, WT>() + c8 * 8 * (int)sizeof(T)), f);
    put8<T, WT>(f, dst, swz(r, c8));
  }
}

// Run the K slices 0 .. KS - 1 of a product into the accumulator d, where
// issue(acc, kk, add) issues slice kk's wgmma into acc (add: keep acc's
// sum).  The tensor cores sum a slice alone, and it is added to d here in
// fp32, round to nearest: their own sum truncates, and over a whole
// product of cancelling terms that lost up to 7e-4 per row against the
// 1e-4 budget (card measurement, PERF.md).  With two partial accumulators
// (pa for even kk, pb for odd) a slice is added while the next one runs;
// a 64 x 128 accumulator (R = 64) gets one, as two would spill.  `fresh`
// says that d starts empty.
template <int KS, int R, typename Issue>
__device__ __forceinline__ void slices(float (&d)[R], Issue&& issue, bool fresh) {
  constexpr bool kTwo = R <= 32;
  float pa[R], pb[R];  // pb is unused (and dropped) where !kTwo
#pragma unroll
  for (int kk = 0; kk <= KS; ++kk) {
    float(&cur)[R] = kTwo && kk % 2 ? pb : pa;
    float(&prev)[R] = kTwo && kk % 2 == 0 ? pb : pa;
    if (kk < KS) {
      hopper::wgmma_fence();
      issue(cur, kk, false);
      hopper::wgmma_commit();
      if (!kTwo) hopper::wgmma_wait<0>();
    }
    const int done = kTwo ? kk - 1 : kk;  // the slice whose sum is added now
    if (done >= 0 && done < KS) {
      if (kTwo) {
        if (kk < KS) {
          hopper::wgmma_wait<1>();
        } else {
          hopper::wgmma_wait<0>();
        }
      }
      float(&part)[R] = kTwo ? prev : cur;
      hopper::fence_regs(part);
#pragma unroll
      for (int i = 0; i < R; ++i)
        d[i] = (fresh && done == 0) ? part[i] : __fadd_rn(d[i], part[i]);
    }
  }
}

}  // namespace ssd_wgmma
