// Building blocks of the tensor-core kernels (flash_attention.cu,
// flash_attention_bwd.cu, flash_variants.cu, the "mma" routes of geglu.cu,
// cross_attention.cu and ln_gemm.cu; groupnorm.cu takes its `cp.async`
// helpers) on Hopper (sm_90a), for
// bf16 tiles of 64 columns:
//
//   - tiles in shared memory: rows of 64 bf16 = 128 bytes, the 16-byte chunk
//     index XORed with (row mod 8). That is the 128-byte swizzle `wgmma`
//     reads, for a K-major operand (rows are M or N, the 64 columns the
//     reduction) and for an MN-major one (rows are the reduction, the 64
//     columns N) alike, so a K or V tile is stored once and serves both
//     products that read it, with no transpose in memory;
//   - `cp.async` copies of 16 bytes that fill such tiles from (token, 64)
//     slices read through a row stride, with commit/wait groups for a ring;
//   - `wgmma.mma_async` m64n64k16 with fp32 accumulation: A and B both from
//     shared memory (`wgmma_ss`), or A from registers and B MN-major from
//     shared memory (`wgmma_rs`), and 64×64×64 tile products built of four;
//     for the one-kernel t_attn branch also A from registers and B K-major
//     (`wgmma_rs_k`: q·kᵀ with q left in registers);
//     for the flash-variant probe also both operands MN-major
//     (`wgmma_ss_mn`) and m64n128k16 in either layout (`wgmma_ss_n128`);
//     for the LayerNorm→projection kernel (ln_gemm.cu) m64n160k16 with both
//     operands K-major (`wgmma_ss_n160`);
//   - the accumulator's register layout: within a warpgroup, warp w owns rows
//     16w .. 16w+15; a thread holds rows r = lane/4 and r + 8 and, for each
//     j < 8, columns 8j + 2·(lane mod 4) + {0, 1}: d[4j], d[4j+1] in row r,
//     d[4j+2], d[4j+3] in row r + 8. Sixteen columns of it, rounded to bf16,
//     are the A fragment of the next product (`pack_a_fragments`), which is
//     what keeps p and ds out of shared memory;
//   - an epilogue that rounds a 64×64 accumulator to bf16 through a swizzled
//     tile and writes rows with 16-byte stores.
//
// A tile's base address must be a multiple of 1024 bytes (8 rows: one period
// of the swizzle); `align_smem` rounds the dynamic shared memory up to it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace udt {
namespace mma {

constexpr int kTile = 64;                       // rows and columns of a tile
constexpr int kRowBytes = kTile * 2;            // 128
constexpr int kTileBytes = kTile * kRowBytes;   // 8192
constexpr int kWarpgroup = 128;                 // threads
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary of the dynamic shared memory.
__device__ __forceinline__ unsigned char* align_smem(unsigned char* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a swizzled tile.
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  return row * kRowBytes + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's shared-memory writes (cp.async included, once waited
// for) before reads of the tensor cores' asynchronous proxy (`wgmma`).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// A barrier over `threads` threads with its own id (0 is __syncthreads's).
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ROWS rows of 64 bf16 from `src` (row stride in elements) into the swizzled
// tile(s) at `dst`, by all `kThreads` threads of the block; rows at or
// beyond `rows_valid` are left as they are. Consecutive 64-row tiles of a
// taller block lie 8192 bytes apart, which the row arithmetic gives by itself.
template <int ROWS, int kThreads>
__device__ __forceinline__ void load_rows_async(uint32_t dst, const __nv_bfloat16* src,
                                                long long row_stride, int rows_valid) {
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * 8; idx += kThreads) {
    const int row = idx >> 3, chunk = idx & 7;
    if (row < rows_valid)
      cp_async16(dst + swizzled(row, chunk), src + row * row_stride + chunk * 8);
  }
}

// The 64-bit matrix descriptor of a swizzled tile (or of a 16-row or
// 16-column slice of it, by adding to the address field): address / 16 in
// bits 0-13, leading byte offset / 16 in bits 16-29 (unused by one 64-wide
// swizzled tile: 1), stride byte offset / 16 in bits 32-45 (8 rows = 1024
// bytes), layout type in bits 62-63 (1: 128-byte swizzle).
__device__ __forceinline__ uint64_t tile_descriptor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving uses of an accumulator across this point.
template <int R>
__device__ __forceinline__ void fence_accumulator(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64×64 fp32, a warpgroup's) = A·Bᵀ (+ d if scale_d): A 64×16 and B 64×16,
// both K-major slices of swizzled tiles.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d = A·B (+ d if scale_d): A 64×16 from registers (four bf16 pairs a
// thread, the accumulator's layout), B 16×64 MN-major: sixteen rows of a
// swizzled tile whose rows are the reduction index.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// d = A·Bᵀ (+ d if accumulate) over 64 columns: A and B swizzled 64×64 tiles
// at shared addresses a and b, both read along their rows. Starts four
// wgmma; the caller fences before and commits after.
__device__ __forceinline__ void tile_product_ss(float (&d)[32], uint32_t a, uint32_t b,
                                                bool accumulate) {
  const uint64_t da = tile_descriptor(a), db = tile_descriptor(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)  // 16 columns = 32 bytes further along the rows
    wgmma_ss(d, da + 2 * kk, db + 2 * kk, (accumulate || kk > 0) ? 1 : 0);
}

// d += A·B over 64 rows of B: A from the fragments `a` (pack_a_fragments), B
// the swizzled 64×64 tile at b read down its columns.
__device__ __forceinline__ void tile_product_rs(float (&d)[32], const uint32_t (&a)[16],
                                                uint32_t b) {
  const uint64_t db = tile_descriptor(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)  // 16 rows = 2048 bytes further down
    wgmma_rs(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], db + 128 * kk, 1);
}

// d = A·Bᵀ (+ d if scale_d): A 64×16 from registers (the layout of
// `wgmma_rs`), B 64×16 K-major (a 16-column slice of a swizzled tile whose
// rows are N), the transpose immediate of B clear.
__device__ __forceinline__ void wgmma_rs_k(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// d = A·Bᵀ over 64 columns: A from the fragments `a` (pack_a_fragments), B
// the swizzled 64×64 tile at b read along its rows. Overwrites d.
__device__ __forceinline__ void tile_product_rs_k(float (&d)[32], const uint32_t (&a)[16],
                                                  uint32_t b) {
  const uint64_t db = tile_descriptor(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)  // 16 columns = 32 bytes further along the rows
    wgmma_rs_k(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], db + 2 * kk,
               kk > 0 ? 1 : 0);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A 64×64 accumulator rounded to bf16 as the A operand of the next product:
// fragment kk holds columns 16kk .. 16kk+15.
__device__ __forceinline__ void pack_a_fragments(const float (&s)[32], uint32_t (&a)[16]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);  // row r,     columns +0..7
    a[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);  // row r + 8
    a[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);  // row r,     columns +8..15
    a[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);  // row r + 8
  }
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A quad (the four lanes that share two accumulator rows) reduced.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A warpgroup's 64×64 accumulator, its rows r and r + 8 scaled by s0 and s1,
// rounded once to bf16 and written to `dst` (row stride in elements; rows at
// or beyond `rows_valid` skipped). It goes through the swizzled tile at
// `stage`, which must be the warpgroup's own and no longer read by a
// product, so that a row leaves as eight 16-byte stores of neighbouring
// threads. `wg_thread` is the thread's index in its warpgroup, `barrier` an
// id no other warpgroup uses.
__device__ __forceinline__ void store_accumulator(const float (&d)[32], float s0, float s1,
                                                  unsigned char* stage, __nv_bfloat16* dst,
                                                  long long row_stride, int rows_valid,
                                                  int wg_thread, int barrier) {
  const int lane = wg_thread & 31;
  const int r = (wg_thread >> 5) * 16 + (lane >> 2);
  named_barrier(barrier, kWarpgroup);  // every warp is past its last product
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t col = (lane & 3) * 4;
    *reinterpret_cast<uint32_t*>(stage + swizzled(r, j) + col) =
        pack_bf16(d[4 * j] * s0, d[4 * j + 1] * s0);
    *reinterpret_cast<uint32_t*>(stage + swizzled(r + 8, j) + col) =
        pack_bf16(d[4 * j + 2] * s1, d[4 * j + 3] * s1);
  }
  named_barrier(barrier, kWarpgroup);
#pragma unroll
  for (int idx = wg_thread; idx < kTile * 8; idx += kWarpgroup) {
    const int row = idx >> 3, chunk = idx & 7;
    if (row < rows_valid)
      *reinterpret_cast<uint4*>(dst + row * row_stride + chunk * 8) =
          *reinterpret_cast<const uint4*>(stage + swizzled(row, chunk));
  }
}

// ---- the forms of the flash-variant probe (flash_variants.cu) ----

// The descriptor of an MN-major operand that spans two or more swizzled
// tiles along M or N: `tile_descriptor` with the leading byte offset set to
// `lbo_bytes`, the distance from one 64-column tile to the next.
__device__ __forceinline__ uint64_t tile_descriptor_mn(uint32_t addr, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFFu) << 16) | (64ull << 32) | (1ull << 62);
}

// d (64×64) = A·B (+ d if scale_d) with A and B both MN-major (the two
// transpose immediates set): A 64×16 is sixteen rows of a swizzled tile whose
// rows are the reduction index and whose 64 columns are M, B sixteen rows of
// one whose columns are N. Reads a (key × d) V tile as Vᵀ.
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                            int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// m64n128k16: d (64×128 fp32, 64 registers; a thread holds columns
// 8j + 2·(lane mod 4) + {0, 1} for j < 16, in the layout above) = A·B
// (+ d if scale_d). TRANS 0: A and B K-major, as `wgmma_ss`; TRANS 1: both
// MN-major, as `wgmma_ss_mn`, B then two tiles apart by the descriptor's
// leading byte offset (`tile_descriptor_mn`).
template <int TRANS>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS));
}

// ---- the wide form of ln_gemm.cu's route "mma" ----

// m64n160k16: d (64×160 fp32, 80 registers a thread; columns 8j + 2·(lane
// mod 4) + {0, 1} for j < 20, in the layout above) = A·Bᵀ (+ d if scale_d):
// A 64×16 and B 160×16, both K-major slices of swizzled tiles (B's 160 rows
// lie 128 bytes apart, eight of them one 1024-byte swizzle period, which
// `tile_descriptor`'s stride byte offset already says).
__device__ __forceinline__ void wgmma_ss_n160(float (&d)[80], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79}, "
      "%80, %81, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

}  // namespace mma
}  // namespace udt
