// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of the
// non-causal, unmasked softmax(q·kᵀ·scale)·v, recomputing p from the LSE
// the forward saved, with fp32 arithmetic and accumulation.
//
// Replaces: udifftext_tpu/ops/flash_attention.py `_flash_bwd_impl` /
// `_flash_bwd_kernel` (the Pallas TPU kernel behind the custom_vjp).
//
// What it computes, per (batch, head):
//   p     = exp(s·scale − lse),  s = q·kᵀ      (exact softmax from the LSE)
//   delta = rowsum(dO ⊙ O)
//   dv    = pᵀ·dO
//   ds    = p ⊙ (dO·vᵀ − delta)
//   dq    = ds·k·scale,  dk = dsᵀ·q·scale
// The TPU kernel rebuilt p from its max-free denominator `l` with logits
// clamped at ±75 and zeroed ds where the clamp bound; this kernel has no
// clamp. The two agree wherever |logits| < 75.
//
// What bounds it on the H100: like the forward it is compute-bound at the
// UNet's shapes (N = 1024 or 4096, d = 64): 7 products of 64×64×d per pair
// of 64-row tiles against the forward's 2. This first version does them
// with fp32 FMAs from shared memory (no tensor cores); wgmma/TMA tiles are
// later work.
//
// Design: the TPU kernel summed dq over its sequential grid axis in a VMEM
// scratch. CUDA blocks run in no order, so the work is split into two
// passes that each own their outputs (deterministic, no atomics), both
// recomputing p:
//   1. dq pass: one block per (64-row q tile, batch·head) walks the key
//      tiles. It also writes delta for its rows (dO and O are read once).
//   2. dk/dv pass: one block per (64-key tile, batch·head) walks the q
//      tiles, reading lse and the delta of pass 1.
// Tiles are staged in shared memory as fp32 with rows padded to d + 1
// (column reads without bank conflicts); a thread owns 4 rows × 4 columns
// of a 64×64 score tile and 4 rows × d/16 columns of its gradient rows.
// (B, N, H, D) is read through its strides; the last dimension must be
// contiguous. Shared memory: pass 1 (4·64·(d+1) + 64·65 + 128)·4 bytes
// (84 KB at d = 64, 149 KB at d = 128), pass 2 (4·64·(d+1) + 2·64·65 +
// 128)·4 bytes (100 KB at d = 64, 166 KB at d = 128).

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kB = 64;        // rows per tile, queries and keys alike
constexpr int kP = kB + 1;    // padded row length of the 64×64 score tiles
constexpr int kThreads = 256;

template <typename T>
struct BwdParams {
  const T* q;
  const T* k;
  const T* v;
  const T* o;
  const T* dout;
  const float* lse;  // (B·H, Nq)
  float* delta;      // (B·H, Nq), written by the dq pass
  T* dq;
  T* dk;
  T* dv;
  int H, Nq, Nk;
  // (batch, token, head) element strides of q, k, v, o, dout, dq, dk, dv
  long long st[8][3];
  float scale;
};

enum { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV };

template <typename T>
__device__ __forceinline__ long long head_offset(const BwdParams<T>& p, int which, int b, int h) {
  return b * p.st[which][0] + h * p.st[which][2];
}

// 64 rows × D of a (token, D) slice into shared memory, row stride D + 1.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    dst[r * (D + 1) + c] = udt::load_f32(src + (long long)r * row_stride + c);
  }
}

// acc[i][j] = Σ_d A[ty·4 + i][d] · B[tx + 16j][d] (both tiles row stride D + 1)
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* B, int ty, int tx,
                                         float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * kB * (D + 1) + kB * kP + 2 * kB);
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (4 * kB * (D + 1) + 2 * kB * kP + 2 * kB);
}

// Pass 1: dq (and delta) for one 64-row query tile.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdParams<T> p) {
  extern __shared__ float smem[];
  float* Qs = smem;                // [kB][D + 1]
  float* Gs = Qs + kB * (D + 1);   // dO
  float* Ks = Gs + kB * (D + 1);
  float* Vs = Ks + kB * (D + 1);
  float* Ss = Vs + kB * (D + 1);   // ds [q][key], row stride kP
  float* Ls = Ss + kB * kP;        // lse of the tile's rows
  float* Es = Ls + kB;             // delta of the tile's rows

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int q0 = blockIdx.x * kB;
  const T* qb = p.q + head_offset(p, kQ, b, h) + (long long)q0 * p.st[kQ][1];
  const T* ob = p.o + head_offset(p, kO, b, h) + (long long)q0 * p.st[kO][1];
  const T* gb = p.dout + head_offset(p, kDO, b, h) + (long long)q0 * p.st[kDO][1];
  const T* kb = p.k + head_offset(p, kK, b, h);
  const T* vb = p.v + head_offset(p, kV, b, h);

  load_tile<T, D>(Qs, qb, p.st[kQ][1]);
  load_tile<T, D>(Gs, gb, p.st[kDO][1]);
  // delta = rowsum(dO ⊙ O): warp w owns rows 8w .. 8w+7
  const int warp = tid / 32, lane = tid % 32;
  for (int rr = 0; rr < kB / (kThreads / 32); ++rr) {
    const int r = warp * (kB / (kThreads / 32)) + rr;
    float acc = 0.f;
    for (int c = lane; c < D; c += 32)
      acc = fmaf(udt::load_f32(gb + (long long)r * p.st[kDO][1] + c),
                 udt::load_f32(ob + (long long)r * p.st[kO][1] + c), acc);
    acc = udt::warp_sum(acc);
    if (lane == 0) {
      Es[r] = acc;
      p.delta[(long long)bh * p.Nq + q0 + r] = acc;
    }
  }
  if (tid < kB) Ls[tid] = p.lse[(long long)bh * p.Nq + q0 + tid];

  const int ty = tid / 16, tx = tid % 16;
  constexpr int DC = D / 16;
  float dq[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dq[i][j] = 0.f;

  for (int k0 = 0; k0 < p.Nk; k0 += kB) {
    __syncthreads();  // the previous key tile and ds are no longer read
    load_tile<T, D>(Ks, kb + (long long)k0 * p.st[kK][1], p.st[kK][1]);
    load_tile<T, D>(Vs, vb + (long long)k0 * p.st[kV][1], p.st[kV][1]);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<D>(Qs, Ks, ty, tx, s);
    tile_dot<D>(Gs, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = expf(s[i][j] * p.scale - Ls[r]);
        Ss[r * kP + tx + 16 * j] = pr * (dp[i][j] - Es[r]);
      }
    }
    __syncthreads();

    // dq += ds·k: rows ty·4 + i, columns tx + 16j
#pragma unroll 4
    for (int kk = 0; kk < kB; ++kk) {
      float sv[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = Ss[(ty * 4 + i) * kP + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) kv[j] = Ks[kk * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) dq[i][j] = fmaf(sv[i], kv[j], dq[i][j]);
    }
  }

  T* dqb = p.dq + head_offset(p, kDQ, b, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = (long long)(q0 + ty * 4 + i) * p.st[kDQ][1];
#pragma unroll
    for (int j = 0; j < DC; ++j) udt::store_from_f32(dqb + row + tx + 16 * j, dq[i][j] * p.scale);
  }
}

// Pass 2: dk and dv for one 64-key tile.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(BwdParams<T> p) {
  extern __shared__ float smem[];
  float* Ks = smem;                // [kB][D + 1]
  float* Vs = Ks + kB * (D + 1);
  float* Qs = Vs + kB * (D + 1);
  float* Gs = Qs + kB * (D + 1);   // dO
  float* Ps = Gs + kB * (D + 1);   // p [q][key], row stride kP
  float* Ss = Ps + kB * kP;        // ds [q][key]
  float* Ls = Ss + kB * kP;
  float* Es = Ls + kB;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int k0 = blockIdx.x * kB;
  const T* qb = p.q + head_offset(p, kQ, b, h);
  const T* gb = p.dout + head_offset(p, kDO, b, h);
  load_tile<T, D>(Ks, p.k + head_offset(p, kK, b, h) + (long long)k0 * p.st[kK][1], p.st[kK][1]);
  load_tile<T, D>(Vs, p.v + head_offset(p, kV, b, h) + (long long)k0 * p.st[kV][1], p.st[kV][1]);

  const int ty = tid / 16, tx = tid % 16;
  constexpr int DC = D / 16;
  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int q0 = 0; q0 < p.Nq; q0 += kB) {
    __syncthreads();  // the previous q tile, p and ds are no longer read
    load_tile<T, D>(Qs, qb + (long long)q0 * p.st[kQ][1], p.st[kQ][1]);
    load_tile<T, D>(Gs, gb + (long long)q0 * p.st[kDO][1], p.st[kDO][1]);
    if (tid < kB) {
      Ls[tid] = p.lse[(long long)bh * p.Nq + q0 + tid];
      Es[tid] = p.delta[(long long)bh * p.Nq + q0 + tid];
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<D>(Qs, Ks, ty, tx, s);   // rows: queries ty·4 + i; columns: keys tx + 16j
    tile_dot<D>(Gs, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = expf(s[i][j] * p.scale - Ls[r]);
        Ps[r * kP + tx + 16 * j] = pr;
        Ss[r * kP + tx + 16 * j] = pr * (dp[i][j] - Es[r]);
      }
    }
    __syncthreads();

    // dv += pᵀ·dO, dk += dsᵀ·q: key rows ty·4 + i, columns tx + 16j
#pragma unroll 4
    for (int qq = 0; qq < kB; ++qq) {
      float pv[4], sv[4], gv[DC], qv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[qq * kP + ty * 4 + i];
        sv[i] = Ss[qq * kP + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        gv[j] = Gs[qq * (D + 1) + tx + 16 * j];
        qv[j] = Qs[qq * (D + 1) + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          dv[i][j] = fmaf(pv[i], gv[j], dv[i][j]);
          dk[i][j] = fmaf(sv[i], qv[j], dk[i][j]);
        }
    }
  }

  T* dkb = p.dk + head_offset(p, kDK, b, h);
  T* dvb = p.dv + head_offset(p, kDV, b, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      udt::store_from_f32(dkb + (long long)r * p.st[kDK][1] + tx + 16 * j, dk[i][j] * p.scale);
      udt::store_from_f32(dvb + (long long)r * p.st[kDV][1] + tx + 16 * j, dv[i][j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_bwd(const BwdParams<T>& p, int B, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_smem_bytes<D>();
  constexpr size_t smem_dkdv = dkdv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkdv);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D><<<dim3(p.Nq / kB, B * p.H), kThreads, smem_dq, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // same stream: pass 2 reads the delta pass 1 wrote
  flash_bwd_dkdv_kernel<T, D><<<dim3(p.Nk / kB, B * p.H), kThreads, smem_dkdv, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, const void* o, const void* dout,
                const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int H, int Nq,
                int Nk, int D, const long long* strides, float scale, cudaStream_t stream) {
  BwdParams<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.o = static_cast<const T*>(o);
  p.dout = static_cast<const T*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<T*>(dq);
  p.dk = static_cast<T*>(dk);
  p.dv = static_cast<T*>(dv);
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  for (int t = 0; t < 8; ++t)
    for (int s = 0; s < 3; ++s) p.st[t][s] = strides[t * 3 + s];
  p.scale = scale;
  return D == 64 ? launch_bwd<T, 64>(p, B, stream) : launch_bwd<T, 128>(p, B, stream);
}

}  // namespace

// q, o, dout, dq: (B, Nq, H, D); k, v, dk, dv: (B, Nk, H, D), each with unit
// stride on D; `strides` holds the (batch, token, head) element strides of
// q, k, v, o, dout, dq, dk, dv in that order (24 values). lse: (B, H, Nq)
// fp32 contiguous, from the forward. delta: (B, H, Nq) fp32 scratch. Nq and
// Nk are multiples of 64. Returns cudaGetLastError() after the launches (or
// the first failing call).
extern "C" int udt_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                       const void* dout, const void* lse, void* delta, void* dq,
                                       void* dk, void* dv, int B, int H, int Nq, int Nk, int D,
                                       const long long* strides, float scale, int dtype,
                                       void* stream) {
  if (Nq % kB != 0 || Nk % kB != 0 || (D != 64 && D != 128)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == udt::kBFloat16)
    return run<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Nq, Nk, D, strides,
                              scale, s);
  if (dtype == udt::kFloat32)
    return run<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Nq, Nk, D, strides, scale,
                      s);
  return cudaErrorInvalidValue;
}
