// The whole textual cross-attention branch in one kernel, for Hopper (sm_90a):
//   out = x + (softmax(LN(x)·Wqᵀ·kᵀ/√d)·v)·Woᵀ + bo
// with hoisted k, v (B, L, H·64) of a short context (1 < L <= 64), Wq
// (H·64, C) and Wo (C, H·64) in PyTorch's Linear layout.
//
// Replaces: udifftext_tpu/ops/cross_attention.py `_fwd_impl` / `_kernel` (the
// Pallas TPU kernel behind `fused_cross_attention`).
//
// What it computes, at the TPU kernel's rounding points: LayerNorm with fp32
// centered statistics rounded to x's dtype; q = xn·Wqᵀ accumulated in fp32,
// rounded; per head the logits q_h·k_hᵀ·scale, the max-subtracted softmax and
// p·v_h in fp32, with p rounded to x's dtype before the product; the head
// outputs rounded; the output projection accumulated in fp32 with bo and the
// fp32 x added before the single rounding at the store.
//
// What bounds it on the H100: x is read once and out written once (2·M·C
// elements; the weights and the 12-token k, v stay in L2) against
// 2·M·C·(2·C + 2·L) flops: about equal at C = 320, operations first from
// C = 640.
//
// Design. A block owns a tile of rows of one batch element (k and v are per
// batch element, so N % 64 == 0 keeps a tile from straddling two): 64 rows
// up to C = 384, 32 above, 16 in fp32. Two shared-memory buffers of
// rows × (C + 8) are reused through the stages, which is what lets C = 1280
// fit (2·32·1288·2 B = 165 KB):
//   A: x tile → LayerNorm in place                         (tile.cuh)
//   B: q = A·Wqᵀ                                            (tensor cores / FMAs)
//   A: per (row, head), one thread: q_h in registers, two passes over the L
//      keys read straight from global memory (every thread of a warp reads
//      the same key, so a load is one broadcast): pass 1 the running max and
//      sum, pass 2 p = exp(s − max)/sum rounded, p·v_h into 64 fp32
//      registers, rounded into A
//   out = A·Woᵀ + bo + x, x read again from global memory (L2).

#include <math.h>

#include <type_traits>

#include "tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kD = 64;  // head width

// Eight consecutive elements (16-byte aligned for bf16, 32 for fp32) widened to fp32.
__device__ __forceinline__ void load8(const bf16* p, float (&out)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&out)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}
__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ float round_to(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }

// Row padding of the shared-memory buffers, in elements: 16 bytes either way.
template <typename T>
struct Pad {
  static constexpr int value = std::is_same<T, bf16>::value ? 8 : 4;
};

template <typename T, int BM>
size_t smem_bytes(int width) {
  return 2 * (size_t)BM * (width + Pad<T>::value) * sizeof(T) +
         (std::is_same<T, bf16>::value ? udt::kStageFloats * sizeof(float) : 0);
}

// q_h·k_lᵀ for the 64-wide head slice at `kp`, q in registers.
template <typename T>
__device__ __forceinline__ float dot64(const float (&q)[kD], const T* kp) {
  float s = 0.f;
#pragma unroll
  for (int d0 = 0; d0 < kD; d0 += 8) {
    float kv[8];
    load8(kp + d0, kv);
#pragma unroll
    for (int i = 0; i < 8; ++i) s = fmaf(q[d0 + i], kv[i], s);
  }
  return s;
}

template <typename T, int BM>
__global__ void __launch_bounds__(udt::kTileThreads)
cross_attn_kernel(const T* __restrict__ x, const float* __restrict__ ln_scale,
                  const float* __restrict__ ln_bias, const T* __restrict__ wq,
                  const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ wo,
                  const T* __restrict__ bo, T* __restrict__ out, int N, int C, int inner, int L,
                  float eps, float scale) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  extern __shared__ __align__(128) unsigned char smem_ca[];
  const int ld = (C > inner ? C : inner) + Pad<T>::value;
  T* bufa = reinterpret_cast<T*>(smem_ca);            // [BM][ld]
  T* bufb = bufa + (size_t)BM * ld;                   // [BM][ld]
  float* stage = reinterpret_cast<float*>(bufb + (size_t)BM * ld);  // bf16 only
  const long long m0 = (long long)blockIdx.x * BM;
  const long long batch = m0 / N;
  const int heads = inner / kD;

  udt::load_rows(bufa, ld, x + m0 * C, BM, C);
  __syncthreads();
  udt::layer_norm_rows(bufa, ld, BM, C, ln_scale, ln_bias, eps);
  __syncthreads();
  udt::block_gemm<kBf16 ? BM / 16 : BM>(
      bufa, ld, wq, nullptr, nullptr, 1, inner, C, stage,
      [&](int, int r, int c, float val) { udt::store_from_f32(bufb + (size_t)r * ld + c, val); });
  __syncthreads();

  const T* kb = k + batch * L * inner;
  const T* vb = v + batch * L * inner;
  for (int p = threadIdx.x; p < BM * heads; p += udt::kTileThreads) {
    const int r = p % BM, h = p / BM;
    float q[kD];
#pragma unroll
    for (int d0 = 0; d0 < kD; d0 += 8) {
      float t[8];
      load8(bufb + (size_t)r * ld + h * kD + d0, t);
#pragma unroll
      for (int i = 0; i < 8; ++i) q[d0 + i] = t[i];
    }
    float mx = -INFINITY, sum = 0.f;
    for (int l = 0; l < L; ++l) {
      const float s = dot64(q, kb + (size_t)l * inner + h * kD) * scale;
      const float nm = fmaxf(mx, s);
      sum = sum * expf(mx - nm) + expf(s - nm);
      mx = nm;
    }
    const float inv = 1.f / sum;
    float acc[kD];
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[d] = 0.f;
    for (int l = 0; l < L; ++l) {
      const float s = dot64(q, kb + (size_t)l * inner + h * kD) * scale;
      const float pr = round_to(expf(s - mx) * inv, static_cast<const T*>(nullptr));
      const T* vp = vb + (size_t)l * inner + h * kD;
#pragma unroll
      for (int d0 = 0; d0 < kD; d0 += 8) {
        float vv[8];
        load8(vp + d0, vv);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[d0 + i] = fmaf(pr, vv[i], acc[d0 + i]);
      }
    }
#pragma unroll
    for (int d0 = 0; d0 < kD; d0 += 8) store8(bufa + (size_t)r * ld + h * kD + d0, acc + d0);
  }
  __syncthreads();

  udt::block_gemm<kBf16 ? BM / 16 : BM>(
      bufa, ld, wo, nullptr, nullptr, 1, C, inner, stage, [&](int, int r, int c, float val) {
        const long long i = (m0 + r) * C + c;
        udt::store_from_f32(out + i, val + udt::load_f32(bo + c) + udt::load_f32(x + i));
      });
}

template <typename T, int BM>
cudaError_t launch(const void* x, const float* ln_scale, const float* ln_bias, const void* wq,
                   const void* k, const void* v, const void* wo, const void* bo, void* out, int B,
                   int N, int C, int inner, int L, float eps, float scale, cudaStream_t s) {
  const size_t smem = smem_bytes<T, BM>(C > inner ? C : inner);
  cudaError_t err = cudaFuncSetAttribute(cross_attn_kernel<T, BM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * N / BM;
  cross_attn_kernel<T, BM><<<(unsigned)blocks, udt::kTileThreads, smem, s>>>(
      static_cast<const T*>(x), ln_scale, ln_bias, static_cast<const T*>(wq),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(wo),
      static_cast<const T*>(bo), static_cast<T*>(out), N, C, inner, L, eps, scale);
  return cudaGetLastError();
}

}  // namespace

// x, out (B, N, C); ln_scale, ln_bias (C,) fp32; wq (inner, C); k, v
// (B, L, inner); wo (C, inner); bo (C,): contiguous, 16-byte aligned, all but
// the LayerNorm parameters of one dtype. inner = heads·64; N % 64 == 0,
// C % 16 == 0, C and inner <= 1536, 1 < L <= 64.
// Returns cudaGetLastError() after the launch (or the first failing call).
extern "C" int udt_cross_attention(const void* x, const void* ln_scale, const void* ln_bias,
                                   const void* wq, const void* k, const void* v, const void* wo,
                                   const void* bo, void* out, int B, int N, int C, int inner,
                                   int L, float eps, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0 || N % 64 || C <= 0 || C % 16 || inner <= 0 || inner % kD || C > 1536 ||
      inner > 1536 || L < 2 || L > 64)
    return cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(ln_scale);
  const float* bi = static_cast<const float*>(ln_bias);
  const int width = C > inner ? C : inner;
  if (dtype == udt::kBFloat16) {
    if (width <= 384)
      return launch<bf16, 64>(x, sc, bi, wq, k, v, wo, bo, out, B, N, C, inner, L, eps, scale, s);
    return launch<bf16, 32>(x, sc, bi, wq, k, v, wo, bo, out, B, N, C, inner, L, eps, scale, s);
  }
  if (dtype == udt::kFloat32)
    return launch<float, 16>(x, sc, bi, wq, k, v, wo, bo, out, B, N, C, inner, L, eps, scale, s);
  return cudaErrorInvalidValue;
}
