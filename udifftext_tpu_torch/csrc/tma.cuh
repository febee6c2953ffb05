// The Tensor Memory Accelerator (TMA) and `mbarrier`s on Hopper (sm_90a), for
// a producer/consumer ring in shared memory (ln_gemm.cu's route "mma"):
//
//   - host: `encode_tile_map` builds a `CUtensorMap` for a row-major bf16
//     matrix (rows, cols) moved in boxes of 64 columns (128 bytes: one row of
//     flash_mma.cuh's swizzled tiles) × box_rows rows, with the 128-byte
//     swizzle, so a box lands in shared memory in the layout `wgmma` reads
//     (or of 32 columns with the 64-byte swizzle); elements past the
//     matrix's edge load as zeros and are not stored. libcuda's encode
//     function is fetched through the runtime
//     (`cudaGetDriverEntryPoint[ByVersion]`), so nothing links against it.
//     A map travels to the kernel by value as a `const __grid_constant__
//     CUtensorMap` parameter.
//   - device: `mbarrier` init / arrive / arrive with an expected byte count /
//     a wait on a phase's parity, the 2-D TMA load that completes its bytes
//     on a barrier, and the 2-D TMA store from shared memory in bulk groups.
//
// Phases: a barrier starts in phase 0; a wait on parity p returns once the
// phase of that parity has completed. A consumer's k-th use of a ring stage
// waits on the stage's full barrier with parity k & 1; a producer's k-th
// refill waits on its empty barrier with parity (k & 1) ^ 1, which a fresh
// barrier passes at once.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace udt {
namespace tma {

// ---- host ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, or null where the runtime cannot find it.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A map of the row-major bf16 matrix at `base` (rows × cols, row pitch cols)
// in boxes of box_cols (64 or 32: 128 or 64 bytes) × box_rows, with the
// swizzle of the box's row width (128 or 64 bytes), zero fill past the edges
// on loads and clipping there on stores. TMA's rules, checked here: a
// 16-byte aligned base, a row pitch that is a multiple of 16 bytes,
// 1 <= box_rows <= 256. Returns cudaErrorInvalidValue on a violation or a
// refused encode.
inline cudaError_t encode_tile_map(CUtensorMap* map, const void* base, long long rows, int cols,
                                   int box_rows, int box_cols = 64) {
  if (reinterpret_cast<uintptr_t>(base) % 16 || (cols * 2) % 16 || cols <= 0 || rows <= 0 ||
      box_rows < 1 || box_rows > 256 || (box_cols != 64 && box_cols != 32))
    return cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                          strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- device ----

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Makes the barriers' initialization visible before any thread uses them
// (followed by a __syncthreads()).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// One arrival, and `bytes` more to be completed by asynchronous copies.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Waits until the barrier's phase of parity `parity` has completed. The spin
// stays inside the asm, so the code around it is straight-line to the compiler.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The box at (column c0, row r0) of the map's matrix into shared memory at
// dst (1024-byte aligned for the swizzle), its bytes completed on `bar`.
__device__ __forceinline__ void load_2d(uint32_t dst, const CUtensorMap* map, int c0, int r0,
                                        uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(bar)
      : "memory");
}

// The box at shared address src (written by this CTA's threads, each of
// which has made its writes visible to the async proxy with
// `fence.proxy.async.shared::cta` before a barrier) to (column c0, row r0)
// of the map's matrix, clipped at its edges; one bulk group a commit.
__device__ __forceinline__ void store_2d(const CUtensorMap* map, uint32_t src, int c0, int r0) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(r0), "r"(src)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until this thread's bulk stores have read their shared-memory source (the
// buffer may be written again), or, with READ false, have completed.
template <bool READ>
__device__ __forceinline__ void bulk_wait_all() {
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace tma
}  // namespace udt
