// Flash-attention forward for Hopper (sm_90a): non-causal, unmasked
// softmax(q·kᵀ·scale)·v with fp32 statistics and accumulation.
//
// Replaces: udifftext_tpu/ops/flash_attention.py `_flash_fwd_impl` /
// `_flash_kernel` (the Pallas TPU kernel behind `flash_attention`).
//
// What it computes: for every (batch, head, query row) the exact softmax
// over all keys. It writes the output in the input dtype and, per row, the
// log-sum-exp `m + log(l)` in fp32 for a later backward. The TPU kernel
// saved the max-free denominator `l` of its clamped-exp softmax instead;
// an LSE is what an online-max kernel produces and what a backward that
// recomputes p = exp(s − lse) needs.
//
// What bounds it on the H100: at the UNet's shapes (N = 1024 or 4096,
// d = 64) attention is compute-bound (4·N·d flops per 2·d·bytes of q).
// This first version does the arithmetic with fp32 FMAs from shared
// memory (no tensor cores), so it runs far below the card's bf16
// tensor-core rate; wgmma/TMA tiles are later work.
//
// Design:
//   - one block per (64-row query tile, batch·head); a loop over 64-key
//     tiles staged in shared memory replaces the TPU's whole-K/V VMEM
//     blocks (block_q 1024 × block_k 512 do not fit 227 KB);
//   - online max: running max m, sum l and the output accumulator live
//     in fp32 (the accumulator in registers, 4 rows × d/16 columns per
//     thread), rescaled by exp(m_old − m_new) per key tile;
//   - (B, N, H, D) is read through its strides, so the caller needs no
//     transposes; the last dimension must be contiguous;
//   - the scale multiplies the fp32 logits, not q.
// Shared memory: (64·d + 64·(d+1) + 64·d + 64·65 + 3·64)·4 bytes, 66 KB at
// d = 64 and 116 KB at d = 128, so up to 3 blocks (d = 64) share an SM.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per shared-memory tile
constexpr int kThreads = 256;

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (kBQ * D + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Nq, int Nk,
                 long long sqb, long long sqn, long long sqh,
                 long long skb, long long skn, long long skh,
                 long long svb, long long svn, long long svh,
                 long long sob, long long son, long long soh, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                      // [kBQ][D]
  float* Ks = Qs + kBQ * D;              // [kBK][D + 1]  (padded: column reads)
  float* Vs = Ks + kBK * (D + 1);        // [kBK][D]
  float* Ps = Vs + kBK * D;              // [kBQ][kBK + 1]
  float* row_m = Ps + kBQ * (kBK + 1);   // running max
  float* row_l = row_m + kBQ;            // running sum
  float* row_a = row_l + kBQ;            // this tile's rescale factor

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;
  T* ob = o + b * sob + h * soh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    Qs[i] = udt::load_f32(qb + (long long)(q0 + r) * sqn + c);
  }
  if (tid < kBQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  // thread tile: rows ty*4 .. ty*4+3, columns tx + 16*j
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  constexpr int DC = D / 16;
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      Ks[r * (D + 1) + c] = udt::load_f32(kb + (long long)(k0 + r) * skn + c);
      Vs[i] = udt::load_f32(vb + (long long)(k0 + r) * svn + c);
    }
    __syncthreads();

    // S = Q·Kᵀ·scale for this tile
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * (kBK + 1) + tx + 16 * j] = s[i][j] * scale;
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w+7, a lane two of the 64 keys
    for (int rr = 0; rr < kBQ / (kThreads / 32); ++rr) {
      const int r = warp * (kBQ / (kThreads / 32)) + rr;
      float* pr = Ps + r * (kBK + 1);
      const float s0 = pr[lane], s1 = pr[lane + 32];
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, udt::warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      const float sum = udt::warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc·alpha + P·V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_a[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const float inv = 1.f / row_l[r];
#pragma unroll
    for (int j = 0; j < DC; ++j)
      udt::store_from_f32(ob + (long long)(q0 + r) * son + tx + 16 * j, acc[i][j] * inv);
  }
  if (tid < kBQ) lse[(long long)bh * Nq + q0 + tid] = row_m[tid] + logf(row_l[tid]);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int H, int Nq, int Nk, const long long* st, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Nq / kBQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, Nq, Nk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, N, H, D) with unit stride on D; `strides` holds the
// (batch, token, head) element strides of q, k, v, o in that order (12
// values). lse: (B, H, Nq) fp32, contiguous. Nq and Nk are multiples of 64.
// Returns cudaGetLastError() after the launch (or the first failing call).
extern "C" int udt_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int B, int H, int Nq, int Nk, int D,
                                       const long long* strides, float scale, int dtype,
                                       void* stream) {
  if (Nq % kBQ != 0 || Nk % kBK != 0 || (D != 64 && D != 128)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == udt::kBFloat16) {
    return D == 64 ? launch<__nv_bfloat16, 64>(q, k, v, o, l, B, H, Nq, Nk, strides, scale, s)
                   : launch<__nv_bfloat16, 128>(q, k, v, o, l, B, H, Nq, Nk, strides, scale, s);
  }
  if (dtype == udt::kFloat32) {
    return D == 64 ? launch<float, 64>(q, k, v, o, l, B, H, Nq, Nk, strides, scale, s)
                   : launch<float, 128>(q, k, v, o, l, B, H, Nq, Nk, strides, scale, s);
  }
  return cudaErrorInvalidValue;
}
