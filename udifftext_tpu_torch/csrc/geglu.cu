// Fused GEGLU feed-forward for Hopper (sm_90a):
//   out = (h ⊙ gelu(g))·W2ᵀ + b2,   [h, g] = x·W1ᵀ + b1
// with W1 (2I, C) and W2 (C, I) in PyTorch's Linear layout.
//
// Replaces: udifftext_tpu/ops/geglu.py `_geglu_fwd_impl` / `_geglu_kernel`
// (the Pallas TPU kernel behind `geglu_ff`) and, with a LayerNorm prologue on
// the x rows, `_geglu_ln_fwd_impl` / `_geglu_ln_kernel` (behind
// `geglu_ff_ln`): out = GEGLU(LN(x)), LN with fp32 centered statistics,
// rounded to the input dtype.
//
// What it computes, at the TPU kernel's rounding points: h and g in fp32
// (fp32 accumulation plus the bias), act = h·gelu(g) with the exact erf
// gelu (`erff`; the TPU kernel used a polynomial only because Pallas had
// no erf), act rounded to the input dtype, act·W2ᵀ accumulated in fp32
// across the hidden dimension, b2 added in fp32, one rounding at the store.
// The 8×-wide hidden [h, g] never reaches device memory.
//
// What bounds it on the H100: 2·M·3·C·I flops against M·C·2 bytes of x and
// out plus 3·C·I weights, so at the UNet's shapes it is compute-bound, on
// the tensor cores for bf16.
//
// Design. The TPU kernel kept a (block_n, C) fp32 accumulator in ~10 MB of
// VMEM; that does not fit a block here (C = 1280 × 64 rows is 320 KB).
// Tiling the output columns instead would recompute h and g once per
// column tile. So a block owns 16·MT rows and ALL C output columns, with
// MT chosen by the wrapper so that MT·C ≈ 1280 (MT = 4/2/1 at C =
// 320/640/1280): the fp32 output accumulator then fits in registers.
//
// bf16 (geglu_wmma_kernel): warp-level wmma bf16 tiles (16×16×16, fp32
// accumulate). x rows sit in shared memory; the hidden dimension is walked
// in chunks of 64 units: the eight warps form the chunk's [h, g] (one
// 16-unit tile each, all MT row tiles), the block gates them into a bf16
// act tile in shared memory, and every warp adds act·W2ᵀ to its share of
// the MT·C/16 output tiles held in registers. Weight tiles are read from
// global memory (L2) directly. When the row blocks alone would leave SMs
// idle (ds4 at B=2: 32 blocks), the hidden dimension is split over
// `splits` blocks; each writes an fp32 partial (splits, M, C) and
// geglu_reduce_kernel sums the partials in a fixed order, adds b2 and
// rounds — deterministic, no atomics.
//
// fp32 (geglu_simt_kernel): the same structure with fp32 FMAs, 16 rows per
// block, no split.
//
// LayerNorm prologue (ln_scale != nullptr): each block normalizes its own
// rows in shared memory before the hidden loop (tile.cuh), so the normalized
// activation never reaches device memory. With the hidden dimension split
// across blocks every split normalizes its rows again; the TPU kernel did it
// once per x block only because its grid runs in order.

#include <math.h>
#include <mma.h>

#include "tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
static_assert(kThreads == udt::kTileThreads, "layer_norm_rows walks rows with kTileWarps warps");
// The LayerNorm prologue's parameters; scale == nullptr means none.
struct LnArgs {
  const float* scale;
  const float* bias;
  float eps;
};
constexpr float kInvSqrt2 = 0.70710678118654752f;

__device__ __forceinline__ float gelu_erf(float g) { return 0.5f * g * (1.f + erff(g * kInvSqrt2)); }

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kKC = 64;            // hidden units per chunk
constexpr int kLDH = 2 * kKC + 4;  // fp32 [h, g] tile row pitch
constexpr int kLDA = kKC + 8;      // bf16 act tile row pitch

size_t wmma_smem_bytes(int mt, int C) {
  const size_t bm = 16 * mt;
  return bm * (C + 8) * sizeof(bf16) + bm * kLDH * sizeof(float) + bm * kLDA * sizeof(bf16);
}

template <int MT, int FRAGS>
__global__ void __launch_bounds__(kThreads)
geglu_wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                  const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                  float* __restrict__ partial, int M, int C, int I, int units_per_split,
                  const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                  float eps) {
  constexpr int BM = 16 * MT;
  extern __shared__ __align__(128) unsigned char smem_w[];
  const int ldx = C + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem_w);               // [BM][C + 8]
  float* hg = reinterpret_cast<float*>(xs + BM * ldx);       // [BM][kLDH]
  bf16* act = reinterpret_cast<bf16*>(hg + BM * kLDH);       // [BM][kLDA]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int j_begin = split * units_per_split, j_end = j_begin + units_per_split;
  const int n_tiles = C / 16;
  const int out_tiles = MT * n_tiles;

  for (int i = tid; i < BM * C; i += kThreads) {
    const int r = i / C, c = i - r * C;
    xs[r * ldx + c] = (m0 + r < M) ? x[(long long)(m0 + r) * C + c] : __float2bfloat16_rn(0.f);
  }
  if (ln_scale != nullptr) {
    __syncthreads();
    udt::layer_norm_rows(xs, ldx, BM, C, ln_scale, ln_bias, eps);
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FRAGS];
#pragma unroll
  for (int f = 0; f < FRAGS; ++f) wmma::fill_fragment(acc[f], 0.f);
  __syncthreads();

  for (int j0 = j_begin; j0 < j_end; j0 += kKC) {
    // [h, g] of the chunk: warp w < 4 forms h units j0+16w.., warp w >= 4
    // the matching g units I+j0+16(w-4)..
    {
      const int wrow = warp < 4 ? j0 + 16 * warp : I + j0 + 16 * (warp - 4);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c1[MT];
#pragma unroll
      for (int t = 0; t < MT; ++t) wmma::fill_fragment(c1[t], 0.f);
      for (int k = 0; k < C; k += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
        wmma::load_matrix_sync(bw, w1 + (long long)wrow * C + k, C);
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ax;
          wmma::load_matrix_sync(ax, xs + t * 16 * ldx + k, ldx);
          wmma::mma_sync(c1[t], ax, bw, c1[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < MT; ++t)
        wmma::store_matrix_sync(hg + t * 16 * kLDH + warp * 16, c1[t], kLDH, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < BM * kKC; i += kThreads) {
      const int r = i / kKC, kk = i - r * kKC;
      const float hv = hg[r * kLDH + kk] + __bfloat162float(b1[j0 + kk]);
      const float gv = hg[r * kLDH + kKC + kk] + __bfloat162float(b1[I + j0 + kk]);
      act[r * kLDA + kk] = __float2bfloat16_rn(hv * gelu_erf(gv));
    }
    __syncthreads();
    // out tiles t = warp + 8·f: (row tile t / n_tiles, column tile t % n_tiles)
#pragma unroll
    for (int f = 0; f < FRAGS; ++f) {
      const int t = warp + kWarps * f;
      if (t < out_tiles) {
        const int mt = t / n_tiles, nt = t - mt * n_tiles;
#pragma unroll
        for (int kk = 0; kk < kKC; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> aa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
          wmma::load_matrix_sync(aa, act + mt * 16 * kLDA + kk, kLDA);
          wmma::load_matrix_sync(bw, w2 + (long long)nt * 16 * I + j0 + kk, I);
          wmma::mma_sync(acc[f], aa, bw, acc[f]);
        }
      }
    }
    __syncthreads();  // hg and act are rewritten by the next chunk
  }

  // this split's partial sums, staged per warp through shared memory
  float* stage = hg + warp * 256;
  float* dst = partial + (long long)split * M * C;
#pragma unroll
  for (int f = 0; f < FRAGS; ++f) {
    const int t = warp + kWarps * f;
    if (t < out_tiles) {
      const int mt = t / n_tiles, nt = t - mt * n_tiles;
      wmma::store_matrix_sync(stage, acc[f], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = m0 + mt * 16 + e / 16;
        if (row < M) dst[(long long)row * C + nt * 16 + e % 16] = stage[e];
      }
      __syncwarp();
    }
  }
}

__global__ void geglu_reduce_kernel(const float* __restrict__ partial, const bf16* __restrict__ b2,
                                    bf16* __restrict__ out, int M, int C, int splits) {
  const long long n = (long long)M * C;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += partial[k * n + i];
    out[i] = __float2bfloat16_rn(s + __bfloat162float(b2[i % C]));
  }
}

template <int MT, int FRAGS>
cudaError_t launch_wmma(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, void* out, float* partial, int M, int C, int I,
                        int splits, LnArgs ln, cudaStream_t s) {
  const size_t smem = wmma_smem_bytes(MT, C);
  cudaError_t err = cudaFuncSetAttribute(geglu_wmma_kernel<MT, FRAGS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + 16 * MT - 1) / (16 * MT), splits);
  geglu_wmma_kernel<MT, FRAGS><<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), partial, M, C, I, I / splits, ln.scale, ln.bias, ln.eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)M * C;
  const int blocks = (int)((n + kThreads - 1) / kThreads < 4096 ? (n + kThreads - 1) / kThreads : 4096);
  geglu_reduce_kernel<<<blocks, kThreads, 0, s>>>(partial, static_cast<const bf16*>(b2),
                                                  static_cast<bf16*>(out), M, C, splits);
  return cudaGetLastError();
}

template <int MT>
cudaError_t dispatch_wmma(const void* x, const void* w1, const void* b1, const void* w2,
                          const void* b2, void* out, float* partial, int M, int C, int I,
                          int splits, LnArgs ln, cudaStream_t s) {
  const int per_warp = (MT * (C / 16) + kWarps - 1) / kWarps;  // output tiles per warp
  if (per_warp <= 4) return launch_wmma<MT, 4>(x, w1, b1, w2, b2, out, partial, M, C, I, splits, ln, s);
  if (per_warp <= 8) return launch_wmma<MT, 8>(x, w1, b1, w2, b2, out, partial, M, C, I, splits, ln, s);
  if (per_warp <= 12) return launch_wmma<MT, 12>(x, w1, b1, w2, b2, out, partial, M, C, I, splits, ln, s);
  if (per_warp <= 16) return launch_wmma<MT, 16>(x, w1, b1, w2, b2, out, partial, M, C, I, splits, ln, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// fp32: FMAs
// ---------------------------------------------------------------------------

constexpr int kBM = 16;   // rows per block
constexpr int kSC = 32;   // hidden units per chunk

template <int NC>
__global__ void __launch_bounds__(kThreads)
geglu_simt_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, float* __restrict__ out, int M, int C, int I,
                  const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                  float eps) {
  extern __shared__ float smem_f[];
  float* xs = smem_f;                 // [kBM][C]
  float* hg = xs + kBM * C;           // [kBM][2·kSC]: h in [0, kSC), g in [kSC, 2·kSC)
  float* act = hg + kBM * 2 * kSC;    // [kBM][kSC]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * kBM;

  for (int i = tid; i < kBM * C; i += kThreads) {
    const int r = i / C, c = i - r * C;
    xs[i] = (m0 + r < M) ? x[(long long)(m0 + r) * C + c] : 0.f;
  }
  if (ln_scale != nullptr) {
    __syncthreads();
    udt::layer_norm_rows(xs, C, kBM, C, ln_scale, ln_bias, eps);
  }
  float acc[kBM][NC];
#pragma unroll
  for (int r = 0; r < kBM; ++r)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[r][n] = 0.f;
  __syncthreads();

  for (int j0 = 0; j0 < I; j0 += kSC) {
    // lanes split C, then a warp sum: row jj < kSC of hg is W1 row j0+jj
    // (h half), row jj >= kSC is W1 row I+j0+jj-kSC (g half)
    for (int jj = warp; jj < 2 * kSC; jj += kWarps) {
      const int j = jj < kSC ? j0 + jj : I + j0 + jj - kSC;
      const float* wr = w1 + (long long)j * C;
      float s[kBM];
#pragma unroll
      for (int r = 0; r < kBM; ++r) s[r] = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float w = wr[c];
#pragma unroll
        for (int r = 0; r < kBM; ++r) s[r] = fmaf(xs[r * C + c], w, s[r]);
      }
      const float bias = b1[j];
#pragma unroll
      for (int r = 0; r < kBM; ++r) {
        const float t = udt::warp_sum(s[r]);
        if (lane == r) hg[r * 2 * kSC + jj] = t + bias;
      }
    }
    __syncthreads();
    for (int i = tid; i < kBM * kSC; i += kThreads) {
      const int r = i / kSC, kk = i - r * kSC;
      act[i] = hg[r * 2 * kSC + kk] * gelu_erf(hg[r * 2 * kSC + kSC + kk]);
    }
    __syncthreads();
    for (int kk = 0; kk < kSC; ++kk) {
      float a[kBM];
#pragma unroll
      for (int r = 0; r < kBM; ++r) a[r] = act[r * kSC + kk];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int c = tid + n * kThreads;
        if (c < C) {
          const float w = w2[(long long)c * I + j0 + kk];
#pragma unroll
          for (int r = 0; r < kBM; ++r) acc[r][n] = fmaf(a[r], w, acc[r][n]);
        }
      }
    }
    __syncthreads();  // hg and act are rewritten by the next chunk
  }

#pragma unroll
  for (int n = 0; n < NC; ++n) {
    const int c = tid + n * kThreads;
    if (c < C) {
#pragma unroll
      for (int r = 0; r < kBM; ++r)
        if (m0 + r < M) out[(long long)(m0 + r) * C + c] = acc[r][n] + b2[c];
    }
  }
}

template <int NC>
cudaError_t launch_simt(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, void* out, int M, int C, int I, LnArgs ln,
                        cudaStream_t s) {
  const size_t smem = sizeof(float) * ((size_t)kBM * C + kBM * 3 * kSC);
  cudaError_t err = cudaFuncSetAttribute(geglu_simt_kernel<NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  geglu_simt_kernel<NC><<<(M + kBM - 1) / kBM, kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<float*>(out), M,
      C, I, ln.scale, ln.bias, ln.eps);
  return cudaGetLastError();
}

cudaError_t dispatch_simt(const void* x, const void* w1, const void* b1, const void* w2,
                          const void* b2, void* out, int M, int C, int I, LnArgs ln,
                          cudaStream_t s) {
  switch ((C + kThreads - 1) / kThreads) {
    case 1: return launch_simt<1>(x, w1, b1, w2, b2, out, M, C, I, ln, s);
    case 2: return launch_simt<2>(x, w1, b1, w2, b2, out, M, C, I, ln, s);
    case 3: return launch_simt<3>(x, w1, b1, w2, b2, out, M, C, I, ln, s);
    case 4: return launch_simt<4>(x, w1, b1, w2, b2, out, M, C, I, ln, s);
    case 5: return launch_simt<5>(x, w1, b1, w2, b2, out, M, C, I, ln, s);
    case 6: return launch_simt<6>(x, w1, b1, w2, b2, out, M, C, I, ln, s);
    case 7: return launch_simt<7>(x, w1, b1, w2, b2, out, M, C, I, ln, s);
    case 8: return launch_simt<8>(x, w1, b1, w2, b2, out, M, C, I, ln, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, C), w1 (2I, C), b1 (2I,), w2 (C, I), b2 (C,), out (M, C): contiguous,
// one dtype; ln_scale, ln_bias (C,) fp32 for the LayerNorm prologue (eps its
// epsilon), or both null for none.
//   bf16: C % 16 == 0, row_tiles (MT) in {1, 2, 4}, I % (64·splits) == 0,
//         MT·C/16 <= 128 output tiles; `partial` is fp32 scratch of
//         splits·M·C elements; pointers 32-byte aligned.
//   fp32: C <= 2048, I % 32 == 0; `partial`, row_tiles and splits unused.
// Returns cudaGetLastError() after the launches (or the first failing call).
extern "C" int udt_geglu_ff(const void* x, const void* ln_scale, const void* ln_bias,
                            const void* w1, const void* b1, const void* w2, const void* b2,
                            void* out, void* partial, int M, int C, int I, int row_tiles,
                            int splits, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || C <= 0 || I <= 0 || (ln_scale == nullptr) != (ln_bias == nullptr))
    return cudaErrorInvalidValue;
  const LnArgs ln{static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias), eps};
  if (dtype == udt::kBFloat16) {
    if (C % 16 != 0 || splits < 1 || I % (kKC * splits) != 0) return cudaErrorInvalidValue;
    float* p = static_cast<float*>(partial);
    switch (row_tiles) {
      case 1: return dispatch_wmma<1>(x, w1, b1, w2, b2, out, p, M, C, I, splits, ln, s);
      case 2: return dispatch_wmma<2>(x, w1, b1, w2, b2, out, p, M, C, I, splits, ln, s);
      case 4: return dispatch_wmma<4>(x, w1, b1, w2, b2, out, p, M, C, I, splits, ln, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == udt::kFloat32) {
    if (C > 8 * kThreads || I % kSC != 0) return cudaErrorInvalidValue;
    return dispatch_simt(x, w1, b1, w2, b2, out, M, C, I, ln, s);
  }
  return cudaErrorInvalidValue;
}
