// Fused LayerNorm → projection(s) for Hopper (sm_90a):
//   o_i = LN(x)·W_iᵀ,  i < n_w ∈ {1, 3},  LN with fp32 centered statistics,
// x (M, C), W_i (F, C) in PyTorch's Linear layout, o_i (M, F) compact.
//
// Replaces: udifftext_tpu/ops/ln_gemm.py `_ln_gemm_fwd_impl` / `_ln_gemm_kernel`
// (one output, wide F: n_w = 1) and `_ln_gemm3_fwd_impl` / `_ln_gemm3_kernel`
// (q, k, v as three compact arrays: n_w = 3), the Pallas TPU kernels behind
// `ln_gemm` and `ln_gemm3`.
//
// What it computes, at the TPU kernels' rounding points: per-row mean and
// centered variance in fp32, y = (x − mean)·rsqrt(var + eps)·scale + bias
// rounded to x's dtype, the products accumulated in fp32, one rounding at
// the store. The normalized activation never reaches device memory.
//
// What bounds it on the H100: x is read once and n_w·F/C times as many bytes
// are written, against 2·M·C·n_w·F flops; at the UNet's widths (C = 320,
// 640) the two bounds are within a factor of 1.3 of each other, bytes
// first.
//
// Two kernels, chosen by the wrapper (ops/ln_gemm.py `ln_gemm_plan`):
//
// "mma" (ln_gemm_mma_kernel<N, RG>): bf16 with C % 64 == 0 (C = 320, 640,
// 1280 among them), on flash_mma.cuh's 128-byte-swizzled 64-column tiles.
//   Grid: (row tile, column group). A block owns 64·RG rows (RG = 1 or 2
//   consumer warpgroups, 64 rows each) and one group of output columns: a
//   run of `group_tiles` N-wide column tiles over the n_w·⌈F/N⌉ tiles of the
//   one or three weights, in order. A tile never straddles two weights: the
//   last tile of a weight whose F is not a multiple of N reads zeros past
//   row F (TMA's fill) and its store is clipped at column F. Column groups
//   of one row tile are adjacent in launch order, so a re-read x comes from
//   L2. N = 160 where it divides F (the UNet's F = 320, 640, 1280 and 3·C),
//   64 elsewhere and where 160-wide tiles cannot fill the card.
//   Roles: RG consumer warpgroups and one producer warp (its lane 0). The
//   producer loads the block's x rows by TMA into swizzled tiles (one
//   barrier for all of them), then streams the weight tiles: each ring stage
//   is one (N rows of W_i) × (64 columns of C) box, loaded by
//   `cp.async.bulk.tensor` with the 128-byte swizzle, so the output columns
//   are the K-major B operand `wgmma` reads as it landed. The ring has
//   2-4 stages, each with a full barrier (the producer's arrival with the
//   stage's byte count; TMA completes the bytes) and an empty one (an
//   arrival of each consumer warpgroup once its products that read the
//   stage have retired). No __syncthreads() after the barriers' set-up.
//   Consumers: wait for the x rows, normalize them in place with
//   `udt::layer_norm_rows`'s arithmetic and summation order, rounded to bf16
//   (four threads a row, 16-byte shared-memory accesses: see
//   `layer_norm_16_rows`), then per column tile and per 64-column K chunk
//   wait on the stage's full barrier and issue four m64nNk16 products
//   (N = 160: `wgmma_ss_n160`, 80 fp32 registers a thread; N = 64:
//   `wgmma_ss`) on the normalized rows and the stage, keeping the previous
//   step's group in flight: once it retires its stage is released. Every
//   loop around a product has the same trip count in every thread and no
//   product sits behind a condition (ptxas serializes the pipeline
//   otherwise).
//   Epilogue: the fp32 accumulator rounded once to bf16 into the warpgroup's
//   swizzled staging tile, then stored by TMA (`cp.async.bulk.tensor`
//   shared → global, clipped at F) into the compact output of its weight.
//   The store drains while the next tile's products run; the warpgroup waits
//   for it to have read the staging only before writing the next tile there.
//   Shared memory: the block's x rows (64·RG·C bf16), the ring (stages ·
//   N·128 bytes) and the staging (RG · 64·N bf16): at C = 1280 64 rows take
//   160 KB, so that width runs RG = 1 with a shallower ring.
//   The tensor maps (x, weights, outputs) are encoded on the host in the C
//   entry point (tma.cuh; 0.09 µs each on the card's host) and passed as one
//   `__grid_constant__` parameter.
//   What bounds it (PERF.md row 5): a block's x load and LayerNorm overlap
//   nothing but other SMs' work (one block an SM); a tile's products then
//   take 1.3× (two warpgroups) to 1.7× (one) their tensor-core time.
//   Halving the weight stream changed nothing, so it is not L2-bound.

// "wmma" / "fma" (ln_gemm_kernel<T>, the first-cut kernel): the other bf16
// widths (C % 16 == 0) and fp32. A block owns 64 rows (16 in fp32): it copies
// them into shared memory with 16-byte loads, normalizes them in place (a
// warp per row, shuffle reductions; C need not be a power of two), then walks
// the output columns of all n_w weights as one run of 16-wide column tiles
// (tile.cuh), weight fragments read from global memory (L2) as they are used.
// Shared memory holds 64·(C + 8) bf16 values, so C <= 1536.
//
// The TPU kernel's sequential F-chunk grid axis, with the normalized block
// kept in scratch from chunk 0 on, is the column loop inside a block here;
// its need to keep all three weights resident, and so its refusal of
// C = 1280, has no counterpart.

#include <type_traits>

#include "flash_mma.cuh"
#include "tile.cuh"
#include "tma.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <typename T>
struct Tile {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int kRows = kBf16 ? 64 : 16;
  static constexpr int kPad = kBf16 ? 8 : 4;  // elements: 16 bytes either way
};

template <typename T>
size_t smem_bytes(int C) {
  return (size_t)Tile<T>::kRows * (C + Tile<T>::kPad) * sizeof(T) +
         (Tile<T>::kBf16 ? udt::kStageFloats * sizeof(float) : 0);
}

template <typename T>
__global__ void __launch_bounds__(udt::kTileThreads)
ln_gemm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, const T* __restrict__ w0,
               const T* __restrict__ w1, const T* __restrict__ w2, T* __restrict__ o0,
               T* __restrict__ o1, T* __restrict__ o2, int n_w, int C, int F, float eps) {
  constexpr int BM = Tile<T>::kRows;
  extern __shared__ __align__(128) unsigned char smem_ln[];
  const int ld = C + Tile<T>::kPad;
  T* xs = reinterpret_cast<T*>(smem_ln);                     // [BM][ld]
  float* stage = reinterpret_cast<float*>(xs + (size_t)BM * ld);  // bf16 only
  const long long m0 = (long long)blockIdx.x * BM;

  udt::load_rows(xs, ld, x + m0 * C, BM, C);
  __syncthreads();
  udt::layer_norm_rows(xs, ld, BM, C, scale, bias, eps);
  __syncthreads();
  udt::block_gemm<Tile<T>::kBf16 ? BM / 16 : BM>(
      xs, ld, w0, w1, w2, n_w, F, C, stage, [&](int wi, int r, int c, float v) {
        T* o = wi == 0 ? o0 : wi == 1 ? o1 : o2;
        udt::store_from_f32(o + (m0 + r) * F + c, v);
      });
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, const float* bias, const void* w0,
                   const void* w1, const void* w2, void* o0, void* o1, void* o2, int n_w, int M,
                   int C, int F, float eps, cudaStream_t s) {
  const size_t smem = smem_bytes<T>(C);
  cudaError_t err = cudaFuncSetAttribute(ln_gemm_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ln_gemm_kernel<T><<<M / Tile<T>::kRows, udt::kTileThreads, smem, s>>>(
      static_cast<const T*>(x), scale, bias, static_cast<const T*>(w0),
      static_cast<const T*>(w1), static_cast<const T*>(w2), static_cast<T*>(o0),
      static_cast<T*>(o1), static_cast<T*>(o2), n_w, C, F, eps);
  return cudaGetLastError();
}


// ---- route "mma" ----

namespace mm = udt::mma;

constexpr int kMaxStages = 4;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may opt in to (227 KB)

// Dynamic shared memory of route "mma" (ops/ln_gemm.py `mma_smem_bytes`): 1 KB
// of alignment slack, the x rows (rg·ct 64×64 tiles), the ring (stages of
// n rows of 128 bytes), the staging (a 64×n tile a warpgroup) and 128 bytes
// of barriers.
constexpr size_t mma_smem_bytes(int rg, int ct, int n, int stages) {
  return 1024 + (size_t)rg * ct * mm::kTileBytes + (size_t)stages * n * mm::kRowBytes +
         (size_t)rg * n * mm::kRowBytes + 128;
}

// The kernel's tensor maps (tma.cuh), one grid-constant parameter: x in
// 64×64 boxes, the weights in 64-column × N-row boxes, the outputs in 64×64
// boxes (128-byte swizzle) and, for the last 32 columns of a 160-wide tile,
// 32-column × 64-row boxes (64-byte swizzle).
struct Maps {
  CUtensorMap x, w[3], o[3], o_half[3];
};

// Four m64nNk16 products over one 64-column K chunk (the 16-column slices lie
// 32 bytes apart along the swizzled rows); the first overwrites d unless
// `accumulate`.
__device__ __forceinline__ void chunk_product(float (&d)[32], uint64_t da, uint64_t db,
                                              bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mm::wgmma_ss(d, da + 2 * kk, db + 2 * kk, (accumulate || kk) ? 1 : 0);
}
__device__ __forceinline__ void chunk_product(float (&d)[80], uint64_t da, uint64_t db,
                                              bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mm::wgmma_ss_n160(d, da + 2 * kk, db + 2 * kk, (accumulate || kk) ? 1 : 0);
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void unpack8(uint4 v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// The shuffle tree of `udt::warp_sum` (partners lane ^ 16, 8, 4, 2, 1) over
// 32 virtual lanes v = 8q + e held as a[e] by the four threads q of a row
// (lane ^ 2 and lane ^ 1 are the thread's partners for v ^ 16 and v ^ 8; the
// last three steps pair its own values). Every step adds own + partner, as
// warp_sum does, so the sum is bit for bit warp_sum's.
__device__ __forceinline__ float row_tree_sum(float (&a)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) a[e] += __shfl_xor_sync(0xffffffffu, a[e], 2);
#pragma unroll
  for (int e = 0; e < 8; ++e) a[e] += __shfl_xor_sync(0xffffffffu, a[e], 1);
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) {
    float b[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) b[e] = a[e] + a[e ^ off];
#pragma unroll
    for (int e = 0; e < 8; ++e) a[e] = b[e];
  }
  return a[0];
}

// In-place LayerNorm of the 16 rows r0 .. r0+15 of a warpgroup's swizzled
// row block (at shared address `tiles`), by one warp, with
// `udt::layer_norm_rows`'s arithmetic and order of summation: there lane l
// sums columns l, l + 32, l + 64, ... in turn, then a shuffle tree. Here
// four threads q share a row, each with eight chains e, and chain (q, e) is
// that lane l = 8q + e: its columns 64t + 32h + 8q + e come, in the same
// order, from one 16-byte chunk a (t, h) (chunk q + 4h of tile t), so the
// shared-memory traffic moves 16 bytes an access. A thread owns two rows,
// ra and ra + 8; a quarter-warp's rows lie 4 apart (ra = r0 + lane / 8 +
// 4·((lane / 4) mod 2)), which keeps its chunks on distinct banks.
__device__ __forceinline__ void layer_norm_16_rows(uint32_t tiles, int r0, int C,
                                                   const float* __restrict__ scale,
                                                   const float* __restrict__ bias, float eps) {
  const int lane = threadIdx.x & 31, q = lane & 3, CT = C / 64;
  const int ra = r0 + (lane >> 3) + 4 * ((lane >> 2) & 1);
  uint32_t off[2][2];  // [row ra, ra + 8][h]: this thread's chunk within a tile
  float sum[2][8], sq[2][8], mean[2], inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
    for (int h = 0; h < 2; ++h) off[rr][h] = mm::swizzled(ra + 8 * rr, q + 4 * h);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum[rr][e] = sq[rr][e] = 0.f;
  }
  for (int t = 0; t < CT; ++t) {
    const uint32_t tile = tiles + t * mm::kTileBytes;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float f[8];
        unpack8(lds128(tile + off[rr][h]), f);
#pragma unroll
        for (int e = 0; e < 8; ++e) sum[rr][e] += f[e];
      }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) mean[rr] = row_tree_sum(sum[rr]) / (float)C;
  for (int t = 0; t < CT; ++t) {
    const uint32_t tile = tiles + t * mm::kTileBytes;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float f[8];
        unpack8(lds128(tile + off[rr][h]), f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = f[e] - mean[rr];
          sq[rr][e] = fmaf(d, d, sq[rr][e]);
        }
      }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) inv[rr] = rsqrtf(row_tree_sum(sq[rr]) / (float)C + eps);
  for (int t = 0; t < CT; ++t) {
    const uint32_t tile = tiles + t * mm::kTileBytes;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 64 * t + 32 * h + 8 * q;
      const float4 s0 = *reinterpret_cast<const float4*>(scale + c);
      const float4 s1 = *reinterpret_cast<const float4*>(scale + c + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bias + c);
      const float4 b1 = *reinterpret_cast<const float4*>(bias + c + 4);
      const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float bi[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float f[8];
        unpack8(lds128(tile + off[rr][h]), f);
        uint4 o;
        o.x = mm::pack_bf16((f[0] - mean[rr]) * inv[rr] * sc[0] + bi[0],
                            (f[1] - mean[rr]) * inv[rr] * sc[1] + bi[1]);
        o.y = mm::pack_bf16((f[2] - mean[rr]) * inv[rr] * sc[2] + bi[2],
                            (f[3] - mean[rr]) * inv[rr] * sc[3] + bi[3]);
        o.z = mm::pack_bf16((f[4] - mean[rr]) * inv[rr] * sc[4] + bi[4],
                            (f[5] - mean[rr]) * inv[rr] * sc[5] + bi[5]);
        o.w = mm::pack_bf16((f[6] - mean[rr]) * inv[rr] * sc[6] + bi[6],
                            (f[7] - mean[rr]) * inv[rr] * sc[7] + bi[7]);
        sts128(tile + off[rr][h], o);
      }
    }
  }
}

// A warpgroup's 64×N accumulator rounded to bf16 into its staging tile and
// stored by TMA to columns col0 .. col0+N−1 of rows row0 .. row0+63 of output
// `wi` (clipped at F). The staging holds 64-column pieces as swizzled 64×64
// tiles and, at N = 160, the last 32 columns as a 64-row × 64-byte piece with
// the 64-byte swizzle (chunk ^ ((row / 2) mod 4)); both layouts keep the
// accumulator's writes (eight rows × 16 bytes a warp) on distinct banks. The
// store drains while the next tile's products run; only before the staging
// is written again does the issuing thread wait until it has been read.
template <int N>
__device__ __forceinline__ void store_tile(const float (&d)[N / 2], uint32_t stage,
                                          const Maps& maps, int wi, int row0, int col0,
                                          int wg_thread, int barrier) {
  const int lane = wg_thread & 31;
  const int r = (wg_thread >> 5) * 16 + (lane >> 2);
  if (wg_thread == 0) udt::tma::bulk_wait_all<true>();  // the previous tile's store has read it
  mm::named_barrier(barrier, mm::kWarpgroup);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = (lane & 3) * 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      const uint32_t v = mm::pack_bf16(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      if (j < 16)
        sts32(stage + (j >> 3) * mm::kTileBytes + mm::swizzled(row, j & 7) + col, v);
      else  // the 64-byte-swizzled piece of columns 128 .. 159
        sts32(stage + 2 * mm::kTileBytes + row * 64 + ((((j - 16) ^ (row >> 1)) & 3) << 4) + col, v);
    }
  }
  mm::fence_proxy_async();  // this thread's writes before the TMA engine's reads
  mm::named_barrier(barrier, mm::kWarpgroup);
  if (wg_thread == 0) {
#pragma unroll
    for (int p = 0; p < N / 64; ++p)
      udt::tma::store_2d(&maps.o[wi], stage + p * mm::kTileBytes, col0 + 64 * p, row0);
    if (N % 64) udt::tma::store_2d(&maps.o_half[wi], stage + 2 * mm::kTileBytes, col0 + 128, row0);
    udt::tma::bulk_commit();
  }
}

template <int N, int RG>
__global__ void __launch_bounds__(RG * mm::kWarpgroup + 32, 1)
ln_gemm_mma_kernel(const __grid_constant__ Maps maps, const float* __restrict__ scale,
                   const float* __restrict__ bias, int C, int tiles_per_w, int total_tiles,
                   int group_tiles, int groups, int stages, float eps) {
  constexpr int kConsumers = RG * mm::kWarpgroup;
  constexpr int kStageBytes = N * mm::kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = mm::align_smem(smem_raw);
  const int CT = C / 64;
  const uint32_t x_tiles = mm::smem_u32(smem);
  const uint32_t ring = x_tiles + RG * CT * mm::kTileBytes;
  const uint32_t staging = ring + stages * kStageBytes;
  // barriers: full[s] at bars + 8s, empty[s] at bars + 8·(kMaxStages + s), the x rows' last
  const uint32_t bars = staging + RG * kStageBytes;
  const uint32_t x_bar = bars + 16 * kMaxStages;
  const int tid = threadIdx.x;
  const int row_tile = blockIdx.x / groups;
  const int tile0 = (blockIdx.x - row_tile * groups) * group_tiles;
  const int n_tiles = min(group_tiles, total_tiles - tile0);
  const int m0 = row_tile * 64 * RG;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      udt::tma::mbar_init(bars + 8 * s, 1);
      udt::tma::mbar_init(bars + 8 * (kMaxStages + s), RG);
    }
    udt::tma::mbar_init(x_bar, 1);
    udt::tma::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp; its lane 0 issues every copy
    if (tid == kConsumers) {
      udt::tma::mbar_arrive_expect_tx(x_bar, RG * CT * mm::kTileBytes);
      for (int r = 0; r < RG; ++r)
        for (int t = 0; t < CT; ++t)
          udt::tma::load_2d(x_tiles + (r * CT + t) * mm::kTileBytes, &maps.x, t * 64, m0 + r * 64,
                            x_bar);
      int s = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_tiles; ++i) {
        const int tile = tile0 + i, wi = tile / tiles_per_w;
        const int col0 = (tile - wi * tiles_per_w) * N;
        for (int kc = 0; kc < CT; ++kc) {
          udt::tma::mbar_wait(bars + 8 * (kMaxStages + s), phase ^ 1);
          udt::tma::mbar_arrive_expect_tx(bars + 8 * s, kStageBytes);
          udt::tma::load_2d(ring + s * kStageBytes, &maps.w[wi], kc * 64, col0, bars + 8 * s);
          if (++s == stages) s = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumer warpgroups
  const int wg = tid / mm::kWarpgroup, wg_thread = tid % mm::kWarpgroup;
  const uint32_t x_wg = x_tiles + wg * CT * mm::kTileBytes;
  udt::tma::mbar_wait(x_bar, 0);
  layer_norm_16_rows(x_wg, (wg_thread >> 5) * 16, C, scale, bias, eps);
  mm::fence_proxy_async();  // the normalized rows before the tensor cores' reads
  mm::named_barrier(1 + wg, mm::kWarpgroup);

  const uint32_t stage_wg = staging + wg * kStageBytes;
  const int row0 = m0 + wg * 64;
  float acc[N / 2];
  int s = 0, prev = 0;
  uint32_t phase = 0;
#pragma unroll 1
  for (int i = 0; i < n_tiles; ++i) {
    const int tile = tile0 + i, wi = tile / tiles_per_w;
    const int col0 = (tile - wi * tiles_per_w) * N;
#pragma unroll 1
    for (int kc = 0; kc < CT; ++kc) {
      udt::tma::mbar_wait(bars + 8 * s, phase);
      mm::wgmma_fence();
      chunk_product(acc, mm::tile_descriptor(x_wg + kc * mm::kTileBytes),
                    mm::tile_descriptor(ring + s * kStageBytes), kc > 0);
      mm::wgmma_commit();
      mm::wgmma_wait<1>();  // the previous step's products have read their stage
      if (kc > 0 && wg_thread == 0) udt::tma::mbar_arrive(bars + 8 * (kMaxStages + prev));
      prev = s;
      if (++s == stages) s = 0, phase ^= 1;
    }
    mm::wgmma_wait<0>();
    if (wg_thread == 0) udt::tma::mbar_arrive(bars + 8 * (kMaxStages + prev));
    mm::fence_accumulator(acc);
    store_tile<N>(acc, stage_wg, maps, wi, row0, col0, wg_thread, 1 + wg);
  }
  if (wg_thread == 0) udt::tma::bulk_wait_all<false>();  // the stores are done before the exit
}

template <int N, int RG>
cudaError_t launch_mma(const void* x, const float* scale, const float* bias, const void* w0,
                       const void* w1, const void* w2, void* o0, void* o1, void* o2, int n_w,
                       int M, int C, int F, int group_tiles, int stages, float eps,
                       cudaStream_t s) {
  const int tiles_per_w = (F + N - 1) / N, total = n_w * tiles_per_w;
  const size_t smem = mma_smem_bytes(RG, C / 64, N, stages);
  if (M % (64 * RG) || C % 64 || group_tiles < 1 || stages < 2 || stages > kMaxStages ||
      smem > (size_t)kSmemMax)
    return cudaErrorInvalidValue;
  Maps maps;
  cudaError_t err = udt::tma::encode_tile_map(&maps.x, x, M, C, 64);
  const void* ws[3] = {w0, w1, w2};
  const void* os[3] = {o0, o1, o2};
  for (int i = 0; i < n_w && err == cudaSuccess; ++i) {
    err = udt::tma::encode_tile_map(&maps.w[i], ws[i], F, C, N);
    if (err == cudaSuccess) err = udt::tma::encode_tile_map(&maps.o[i], os[i], M, F, 64);
    if (err == cudaSuccess && N % 64)
      err = udt::tma::encode_tile_map(&maps.o_half[i], os[i], M, F, 64, 32);
  }
  if (err != cudaSuccess) return err;
  static bool smem_set = false;  // the opt-in is made once an instantiation
  if (!smem_set) {
    err = cudaFuncSetAttribute(ln_gemm_mma_kernel<N, RG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int groups = (total + group_tiles - 1) / group_tiles;
  const long long blocks = (long long)(M / (64 * RG)) * groups;
  ln_gemm_mma_kernel<N, RG><<<(unsigned)blocks, RG * mm::kWarpgroup + 32, smem, s>>>(
      maps, scale, bias, C, tiles_per_w, total, group_tiles, groups, stages, eps);
  return cudaGetLastError();
}

}  // namespace

// Routes "wmma" (bf16) and "fma" (fp32).
// x (M, C), scale/bias (C,) fp32, w0..w2 (F, C), o0..o2 (M, F): contiguous,
// 16-byte aligned, x, w and o of one dtype; n_w in {1, 3} (w1, w2, o1, o2
// unused when 1). M % 64 == 0, C % 16 == 0, F % 16 == 0, C <= 1536.
// Returns cudaGetLastError() after the launch (or the first failing call).
extern "C" int udt_ln_gemm(const void* x, const void* scale, const void* bias, const void* w0,
                           const void* w1, const void* w2, void* o0, void* o1, void* o2, int n_w,
                           int M, int C, int F, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((n_w != 1 && n_w != 3) || M <= 0 || M % 64 || C <= 0 || C % 16 || F <= 0 || F % 16 ||
      C > 1536)
    return cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == udt::kBFloat16)
    return launch<bf16>(x, sc, bi, w0, w1, w2, o0, o1, o2, n_w, M, C, F, eps, s);
  if (dtype == udt::kFloat32)
    return launch<float>(x, sc, bi, w0, w1, w2, o0, o1, o2, n_w, M, C, F, eps, s);
  return cudaErrorInvalidValue;
}

// Route "mma". As udt_ln_gemm, bf16 only, with C % 64 == 0, `rows` 64 or 128
// a block (M % rows == 0), `n` 64 or 160 output columns a tile, `group_tiles`
// column tiles a block and a ring of `stages` (2-4) within 227 KB of shared
// memory (mma_smem_bytes). TMA's rules: 16-byte aligned bases, row pitches of
// a multiple of 16 bytes (C·2 here).
// Returns cudaGetLastError() after the launch (or the first failing call;
// cudaErrorInvalidValue for what it does not take or a refused tensor map).
extern "C" int udt_ln_gemm_mma(const void* x, const void* scale, const void* bias,
                               const void* w0, const void* w1, const void* w2, void* o0, void* o1,
                               void* o2, int n_w, int M, int C, int F, float eps, int rows, int n,
                               int group_tiles, int stages, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((n_w != 1 && n_w != 3) || M <= 0 || C <= 0 || C > 1536 || F <= 0 || F % 16)
    return cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
#define UDT_LN_GEMM_MMA(N_, RG_)                                                                \
  if (n == N_ && rows == 64 * RG_)                                                              \
    return launch_mma<N_, RG_>(x, sc, bi, w0, w1, w2, o0, o1, o2, n_w, M, C, F, group_tiles,   \
                               stages, eps, s);
  UDT_LN_GEMM_MMA(160, 1)
  UDT_LN_GEMM_MMA(160, 2)
  UDT_LN_GEMM_MMA(64, 1)
  UDT_LN_GEMM_MMA(64, 2)
#undef UDT_LN_GEMM_MMA
  return cudaErrorInvalidValue;
}
