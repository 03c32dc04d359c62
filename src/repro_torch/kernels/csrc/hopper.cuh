// The Hopper (sm_90a) parts shared by the tensor-core kernels (gmm.cu,
// flash_attention.cu, flash_attention_bwd_wgmma.cu, ssd_scan.cu and
// ssd_scan_bwd.cu; mahalanobis.cu and int8_matmul.cu use its mbarriers and
// cp.async): TMA tensor maps made on the host,
// mbarriers, TMA tile loads into 128-byte-swizzled shared memory and TMA
// tile stores out of it, wgmma shared-memory descriptors, cp.async and the
// async-proxy fence for tiles that threads write, wgmma fence / commit /
// wait, named barriers, register rebalancing between warpgroups
// (setmaxnreg), and the wgmma.mma_async
// instructions (m64nNk16, bf16 or fp16 in, fp32 accumulate) for N = 64, 128
// and 256 (and 32 with A from shared memory, for ssd_scan_bwd.cu), with A
// from shared memory (K- or M-major) or from registers; and the three-way
// bf16 split of fp32 operands (ssd_scan.cu, ssd_scan_bwd.cu).
//
// Shared-memory tiles.  Every operand tile is loaded by TMA (or written by
// threads in the same layout, ssd_scan.cu) with
// CU_TENSOR_MAP_SWIZZLE_128B, whose box is at most 128 bytes (64 16-bit
// values) wide: a tile wider than that is stored as consecutive "atoms", each
// 64 values wide and `rows` rows long (rows * 128 bytes).  Row r of an atom
// starts at r * 128 bytes and its 16-byte chunks are permuted by r % 8, so
// every atom starts on a 1024-byte boundary.  wgmma reads such a tile through
// a descriptor with the same 128-byte swizzle:
//   * K-major (the contiguous axis is the reduction axis; A but gmm's x^T,
//     B of Q K^T and of gmm's g w^T): SBO = 1024 (from one 8-row group to the next), LBO unused;
//     the k-th 16-value slice of an atom starts k * 32 bytes in.
//   * MN-major (the contiguous axis is M or N; B of x @ w and of P V, A of
//     gmm's x^T g): LBO = the atom size (from one 64-column atom to the next
//     along M or N), SBO = 1024 (from 8 rows of K to the next 8); the k-th
//     16-row slice starts k * 2048 bytes in.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// host: TMA tensor maps
// ---------------------------------------------------------------------------

// Encode a tiled TMA map over a 16-bit tensor of `rank` dimensions
// (innermost first): `dims` in elements, `strides` in bytes for dimensions
// 1.. (each a multiple of 16), `box` the tile in elements (box[0] * 2 <= 128
// bytes).  128-byte swizzle; out-of-range elements read as zero.  The
// driver's cuTensorMapEncodeTiled is reached through the runtime's entry
// point query, so the library links without -lcuda.
inline cudaError_t make_tensor_map(CUtensorMap* map, bool f16, int rank, const void* ptr,
                                   const uint64_t* dims, const uint64_t* strides,
                                   const uint32_t* box) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  // the encoder needs a current context, which a thread that has made no
  // runtime call yet lacks (autograd's device thread, when a backward's
  // first launch is a kernel of this library): make the device's primary
  // context current
  int dev = 0;
  cudaError_t ctx = cudaGetDevice(&dev);
  if (ctx == cudaSuccess) ctx = cudaSetDevice(dev);
  if (ctx != cudaSuccess) return ctx;
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      (cuuint32_t)rank, const_cast<void*>(ptr), (const cuuint64_t*)dims,
      (const cuuint64_t*)strides, (const cuuint32_t*)box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Allow a kernel `bytes` of dynamic shared memory (needed above 48 KB).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---------------------------------------------------------------------------
// device: shared memory and mbarriers
// ---------------------------------------------------------------------------

// The shared-state-space address of a generic pointer into shared memory.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Round a dynamic shared-memory base up to 1024 bytes, as the 128-byte
// swizzle needs (the kernels ask for 1024 bytes more than they use).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// Initialise an mbarrier whose phase completes after `count` arrivals (and
// the bytes announced with expect_tx).  One thread; then mbar_fence_init
// and __syncthreads before any use.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive once and announce `bytes` that TMA copies will deliver to this
// phase; the phase completes when both the arrivals and the bytes are in.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Arrive once (a consumer releasing a stage).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A fresh barrier
// is in phase 0, so waiting on parity 1 returns at once (a producer's first
// pass over the empty stages).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// device: TMA tile loads (global -> shared, completion on an mbarrier)
// ---------------------------------------------------------------------------

// Copy the box of `map` at element coordinates (c0, c1, c2), innermost
// first, into shared memory at `dst` (1024-byte aligned); its bytes count
// towards `bar`'s current phase.  Out-of-range elements arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The same for a 4-D map, coordinates (c0, c1, c2, c3).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// device: TMA tile stores (shared -> global, completion by bulk group)
// ---------------------------------------------------------------------------

// Copy the box at shared `src` (1024-byte aligned, laid out as the map's
// swizzle lays out a load) to the map's tensor at element coordinates (c0,
// c1, c2), innermost first.  Elements outside the tensor are not written,
// so the box masks a ragged edge.  Before it: every thread that wrote
// `src` runs fence_proxy_async, then a barrier; after it, bulk_commit.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
          (uint64_t)map),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Close this thread's bulk stores issued since the last commit into a group.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's bulk groups still read shared
// memory (their sources may then be overwritten).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// Wait until at most N of this thread's bulk groups are still incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// device: cp.async (16 or 4 bytes a thread, global -> shared, no registers)
// ---------------------------------------------------------------------------

// Copy 16 bytes from `src` to shared `dst` asynchronously; with ok false
// the 16 bytes are zeros and nothing is read (src must still be mapped).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
// The same for 4 bytes (cp.async.ca: the 16-byte .cg form has no 4-byte size).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until this thread's copies are done (then a barrier for the others').
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// ---------------------------------------------------------------------------
// device: wgmma descriptors and synchronisation
// ---------------------------------------------------------------------------

// The wgmma descriptor of a 128-byte-swizzled tile starting at shared
// address `addr`: leading and stride byte offsets `lbo`, `sbo` (see the top
// of this file), layout type 1 (128-byte swizzle), base offset 0 (atoms are
// 1024-byte aligned).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

// Make this thread's ordinary shared-memory writes (st.shared) visible to
// the async proxy, which wgmma reads shared memory through; then a barrier
// before the wgmma (tiles written by threads, not by TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Order this warpgroup's earlier register and shared-memory writes before
// the wgmma that follow (needed before a wgmma reads registers written since
// the last one: accumulators, register A fragments).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

// Close the wgmma issued since the last commit into one group.
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Wait until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Named barrier `id` (1..15; 0 is __syncthreads) for `count` threads:
// wait until `count` threads have arrived or synced on it, counting this
// one (named_sync), or arrive without waiting (named_arrive).  Whole warps.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Give back registers: this warpgroup keeps R a thread (a producer that
// only issues TMA loads).  All four warps execute it.
template <int R>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

// Take registers from those given back: this warpgroup gets R a thread
// (consumers that hold wgmma accumulators).  All four warps execute it.
template <int R>
__device__ __forceinline__ void regs_take() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

// Keep the compiler from moving reads or writes of accumulator registers
// across a wgmma boundary (no instruction is emitted).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---------------------------------------------------------------------------
// device: wgmma.mma_async, m64nNk16, fp32 accumulators d[N / 2] per thread.
// Thread t of the warpgroup (warp w = t / 32, lane l) holds rows
// 16 w + l / 4 + 8 i (i = 0, 1) and columns 8 j + 2 (l % 4) + c (c = 0, 1)
// of the 64 x N tile in d[4 j + 2 i + c].  A register A fragment (64 x 16)
// has the same layout: a[m] packs the 16-bit values of d[2 m] and
// d[2 m + 1] of a 64 x 16 accumulator, the first in the low half.
// ---------------------------------------------------------------------------

#define HP_ACC8(i)                                                                   \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), \
      "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define HP_ACC16 HP_ACC8(0), HP_ACC8(8)
#define HP_ACC32_AT(i) HP_ACC8(i), HP_ACC8((i) + 8), HP_ACC8((i) + 16), HP_ACC8((i) + 24)
#define HP_ACC32 HP_ACC32_AT(0)
#define HP_ACC64 HP_ACC32_AT(0), HP_ACC32_AT(32)
#define HP_ACC128 HP_ACC32_AT(0), HP_ACC32_AT(32), HP_ACC32_AT(64), HP_ACC32_AT(96)

#define HP_WGMMA_SS_N32(TY)                                                        \
  asm volatile(                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                                 \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." #TY "." #TY " "                  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}," \
      " %16, %17, p, 1, 1, %19, %20;\n}\n"                                          \
      : HP_ACC16                                                                   \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
#define HP_WGMMA_SS_N64(TY)                                                        \
  asm volatile(                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                 \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." #TY "." #TY " "                  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11," \
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23," \
      " %24, %25, %26, %27, %28, %29, %30, %31}," \
      " %32, %33, p, 1, 1, %35, %36;\n}\n"                                          \
      : HP_ACC32                                                                   \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
#define HP_WGMMA_RS_N64(TY)                                                        \
  asm volatile(                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                 \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." #TY "." #TY " "                  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11," \
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23," \
      " %24, %25, %26, %27, %28, %29, %30, %31}," \
      " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"                     \
      : HP_ACC32                                                                   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB))

#define HP_WGMMA_SS_N128(TY)                                                        \
  asm volatile(                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                 \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." #TY "." #TY " "                  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11," \
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23," \
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35," \
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59," \
      " %60, %61, %62, %63}," \
      " %64, %65, p, 1, 1, %67, %68;\n}\n"                                          \
      : HP_ACC64                                                                   \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
#define HP_WGMMA_RS_N128(TY)                                                        \
  asm volatile(                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                 \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." #TY "." #TY " "                  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11," \
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23," \
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35," \
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59," \
      " %60, %61, %62, %63}," \
      " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"                     \
      : HP_ACC64                                                                   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB))

#define HP_WGMMA_SS_N256(TY)                                                        \
  asm volatile(                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                                 \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." #TY "." #TY " "                  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11," \
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23," \
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35," \
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59," \
      " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71," \
      " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83," \
      " %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95," \
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107," \
      " %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119," \
      " %120, %121, %122, %123, %124, %125, %126, %127}," \
      " %128, %129, p, 1, 1, %131, %132;\n}\n"                                      \
      : HP_ACC128                                                                   \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
#define HP_WGMMA_RS_N256(TY)                                                        \
  asm volatile(                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                                 \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." #TY "." #TY " "                  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11," \
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23," \
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35," \
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59," \
      " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71," \
      " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83," \
      " %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95," \
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107," \
      " %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119," \
      " %120, %121, %122, %123, %124, %125, %126, %127}," \
      " {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"                     \
      : HP_ACC128                                                                   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB))

// D (64 x N) += A (64 x 16 in shared memory, descriptor da; K-major if
// TA = 0, M-major if TA = 1) * B (16 x N in shared memory, descriptor db;
// K-major if TB = 0, N-major if TB = 1).  scale_d = 0 overwrites D instead.
// The transposed layouts (TA or TB = 1) exist for 16-bit operands only.
template <int N, bool F16, int TB, int TA = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128 || N == 256, "wgmma N");
  if constexpr (N == 32) {
    if constexpr (F16) HP_WGMMA_SS_N32(f16); else HP_WGMMA_SS_N32(bf16);
  } else if constexpr (N == 64) {
    if constexpr (F16) HP_WGMMA_SS_N64(f16); else HP_WGMMA_SS_N64(bf16);
  } else if constexpr (N == 128) {
    if constexpr (F16) HP_WGMMA_SS_N128(f16); else HP_WGMMA_SS_N128(bf16);
  } else {
    if constexpr (F16) HP_WGMMA_SS_N256(f16); else HP_WGMMA_SS_N256(bf16);
  }
}

// D (64 x N) += A (64 x 16 in registers, a[4]) * B (16 x N in shared
// memory, descriptor db; N-major if TB = 1).
template <int N, bool F16, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 128 || N == 256, "wgmma N");
  if constexpr (N == 64) {
    if constexpr (F16) HP_WGMMA_RS_N64(f16); else HP_WGMMA_RS_N64(bf16);
  } else if constexpr (N == 128) {
    if constexpr (F16) HP_WGMMA_RS_N128(f16); else HP_WGMMA_RS_N128(bf16);
  } else {
    if constexpr (F16) HP_WGMMA_RS_N256(f16); else HP_WGMMA_RS_N256(bf16);
  }
}

// ---------------------------------------------------------------------------
// device: the three-way bf16 split of fp32 operands
// ---------------------------------------------------------------------------

// fp32 operands on bf16 tensor cores (ssd_scan.cu, ssd_scan_bwd.cu):
// (a, b) -> three packed bf16 pairs, hi = bf16(v), mid = bf16(v - hi), lo =
// bf16(v - hi - mid); each difference is exact in fp32.
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  a = __fsub_rn(a, hf.x);
  b = __fsub_rn(b, hf.y);
  __nv_bfloat162 m = __floats2bfloat162_rn(a, b);
  const float2 mf = __bfloat1622float2(m);
  __nv_bfloat162 l = __floats2bfloat162_rn(__fsub_rn(a, mf.x), __fsub_rn(b, mf.y));
  hi = *reinterpret_cast<uint32_t*>(&h);
  mid = *reinterpret_cast<uint32_t*>(&m);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

}  // namespace hopper
