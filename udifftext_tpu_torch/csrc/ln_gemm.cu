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
// Design. A block owns 64 rows (16 in fp32): it copies them into shared
// memory with 16-byte loads, normalizes them in place (a warp per row,
// shuffle reductions; C need not be a power of two), then walks the output
// columns of all n_w weights as one run of 16-wide column tiles (tile.cuh).
// The TPU kernel's sequential F-chunk grid axis, with the normalized block
// kept in scratch from chunk 0 on, is that loop inside the block; its need to
// keep all three weights resident, and so its refusal of C = 1280, has no
// counterpart: weight tiles are read from global memory (L2) as they are
// used. Shared memory holds 64·(C + 8) bf16 values, so C <= 1536.

#include <type_traits>

#include "tile.cuh"

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

}  // namespace

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
