// Building blocks shared by the LayerNorm-fused kernels (ln_gemm.cu,
// cross_attention.cu, geglu.cu): an in-place LayerNorm of a row tile held in
// shared memory, and the product of that tile with weights in PyTorch's
// Linear layout (F, K), read from global memory (they stay in L2: every
// block walks the same few hundred KB).
//
//   bf16: warp-level wmma tiles (16×16×16, fp32 accumulate). The eight warps
//         of a block split the output's column tiles; a warp holds RT row
//         tiles × 2 column tiles of accumulators and hands each finished
//         tile to the caller's epilogue through a 1 KB fp32 stage.
//   fp32: FMAs; a thread owns one output column and all BM rows.
//
// Blocks using these helpers run kTileThreads threads.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace udt {

constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kStageFloats = kTileWarps * 256;  // one 16×16 fp32 tile per warp

// Copies `rows` rows of C elements (C·sizeof(T) a multiple of 16, both sides
// 16-byte aligned) from global x (row pitch C) into shared xs (row pitch ld).
template <typename T>
__device__ __forceinline__ void load_rows(T* xs, int ld, const T* __restrict__ x, int rows, int C) {
  const int chunks = C * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < rows * chunks; i += kTileThreads) {
    const int r = i / chunks, c = i - r * chunks;
    reinterpret_cast<uint4*>(xs + (size_t)r * ld)[c] =
        reinterpret_cast<const uint4*>(x + (size_t)r * C)[c];
  }
}

// In-place LayerNorm of `rows` rows of length C in shared memory (row pitch
// ld): fp32 mean and centered variance, y = (x − mean)·rsqrt(var + eps)·scale
// + bias, rounded to T. One warp per row; no barrier before or after.
template <typename T>
__device__ __forceinline__ void layer_norm_rows(T* xs, int ld, int rows, int C,
                                                const float* __restrict__ scale,
                                                const float* __restrict__ bias, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kTileWarps) {
    T* row = xs + (size_t)r * ld;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += load_f32(row + c);
    const float mean = warp_sum(s) / (float)C;
    float ss = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = load_f32(row + c) - mean;
      ss = fmaf(d, d, ss);
    }
    const float inv = rsqrtf(warp_sum(ss) / (float)C + eps);
    for (int c = lane; c < C; c += 32)
      store_from_f32(row + c, (load_f32(row + c) - mean) * inv * scale[c] + bias[c]);
  }
}

// out(r, f) = Σ_k a(r, k)·w(f, k) for the 16·RT rows of `a` (shared memory,
// row pitch lda, a multiple of 8) and the n_w·F output columns of up to three
// weights w0, w1, w2, each (F, K) row-major in global memory; F and K are
// multiples of 16. epi(weight index, row, column, value) receives every
// output element once. `stage` is kStageFloats of shared memory.
template <int RT, typename Epi>
__device__ __forceinline__ void block_gemm(const __nv_bfloat16* a, int lda,
                                           const __nv_bfloat16* w0, const __nv_bfloat16* w1,
                                           const __nv_bfloat16* w2, int n_w, int F, int K,
                                           float* stage, Epi epi) {
  namespace wmma = nvcuda::wmma;
  constexpr int CT = 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles_per_w = F / 16, tiles = n_w * tiles_per_w;
  float* st = stage + warp * 256;
  for (int g = warp * CT; g < tiles; g += kTileWarps * CT) {
    const __nv_bfloat16* wt[CT];
    int wi[CT], col[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int t = g + j;
      wt[j] = nullptr;
      wi[j] = col[j] = 0;
      if (t < tiles) {
        wi[j] = t / tiles_per_w;
        col[j] = (t - wi[j] * tiles_per_w) * 16;
        wt[j] = (wi[j] == 0 ? w0 : wi[j] == 1 ? w1 : w2) + (size_t)col[j] * K;
      }
    }
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT][CT];
#pragma unroll
    for (int t = 0; t < RT; ++t)
#pragma unroll
      for (int j = 0; j < CT; ++j) wmma::fill_fragment(acc[t][j], 0.f);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bw[CT];
#pragma unroll
      for (int j = 0; j < CT; ++j)
        if (wt[j]) wmma::load_matrix_sync(bw[j], wt[j] + k, K);
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> ax;
        wmma::load_matrix_sync(ax, a + (size_t)t * 16 * lda + k, lda);
#pragma unroll
        for (int j = 0; j < CT; ++j)
          if (wt[j]) wmma::mma_sync(acc[t][j], ax, bw[j], acc[t][j]);
      }
    }
#pragma unroll
    for (int t = 0; t < RT; ++t)
#pragma unroll
      for (int j = 0; j < CT; ++j)
        if (wt[j]) {
          wmma::store_matrix_sync(st, acc[t][j], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) epi(wi[j], t * 16 + e / 16, col[j] + e % 16, st[e]);
          __syncwarp();
        }
  }
}

// The fp32 form: BM rows of `a` (row pitch lda, a multiple of 4), K a
// multiple of 4. `stage` is unused.
template <int BM, typename Epi>
__device__ __forceinline__ void block_gemm(const float* a, int lda, const float* w0,
                                           const float* w1, const float* w2, int n_w, int F,
                                           int K, float* /*stage*/, Epi epi) {
  for (int f = threadIdx.x; f < n_w * F; f += kTileThreads) {
    const int wi = f / F, col = f - wi * F;
    const float* wr = (wi == 0 ? w0 : wi == 1 ? w1 : w2) + (size_t)col * K;
    float acc[BM];
#pragma unroll
    for (int r = 0; r < BM; ++r) acc[r] = 0.f;
    for (int k = 0; k < K; k += 4) {
      const float4 wv = *reinterpret_cast<const float4*>(wr + k);
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float4 av = *reinterpret_cast<const float4*>(a + (size_t)r * lda + k);
        acc[r] = fmaf(av.x, wv.x, acc[r]);
        acc[r] = fmaf(av.y, wv.y, acc[r]);
        acc[r] = fmaf(av.z, wv.z, acc[r]);
        acc[r] = fmaf(av.w, wv.w, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < BM; ++r) epi(wi, r, col, acc[r]);
  }
}

}  // namespace udt
