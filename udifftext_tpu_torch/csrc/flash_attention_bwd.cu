// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of the
// non-causal, unmasked softmax(q·kᵀ·scale)·v, recomputing p from the LSE
// the forward saved, with fp32 accumulation.
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
// What bounds it on the H100: operations, as in the forward, at the UNet's
// shapes (N = 1024 or 4096, d = 64). The TPU kernel summed dq over its
// sequential grid axis in a VMEM scratch. CUDA blocks run in no order, so
// the work is split into two passes that each own their outputs
// (deterministic, no atomics: training stays bit-reproducible), both
// recomputing p. That makes seven N×N×d products where one pass would do
// five, and two exponentials per score.
//   1. dq pass: one block per (query rows, batch·head) walks the key tiles.
//      It also writes delta for its rows (dO and O are read once).
//   2. dk/dv pass: one block per (key rows, batch·head) walks the query
//      tiles, reading lse and the delta of pass 1.
// (B, N, H, D) is read through its strides.
//
// Two sets of kernels, chosen by the wrapper (ops/flash_attention.py
// `flash_kernel_route`), as in the forward (flash_attention.cu):
//
// "mma": bf16, d = 64. All seven products are `wgmma` m64n64k16 from
// 128-byte swizzled tiles (csrc/flash_mma.cuh); s, dP, p and ds live in
// accumulator registers only, p and ds are rounded to bf16 there and are
// the A operand of the product that follows. Blocks of 256 threads: two
// warpgroups of 64 rows; 64-row tiles come through a 4-stage `cp.async`
// ring with one `__syncthreads()` per tile.
//   - Pass 1, 128 query rows a block: Q and dO are loaded once; per key
//     tile S = Q·Kᵀ and dP = dO·Vᵀ (K-major operands), ds from the lse and
//     delta of the thread's two rows held in registers, dq += ds·K with the
//     K tile read MN-major where it lies. Shared memory 32 KB + 4 × 16 KB
//     + 0.5 KB = 97 KB.
//   - Pass 2, 128 key rows a block: K and V are loaded once and are the A
//     operands of the transposed tiles Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so that pᵀ
//     and dsᵀ come out with keys as rows: the A operand that dv += pᵀ·dO and
//     dk += dsᵀ·Q need, with dO and Q read MN-major from the ring. Nothing
//     is transposed through shared memory. lse and delta belong to a
//     fragment's columns here: the 2 × 64 floats of a query tile ride in
//     the ring beside it. Shared memory 32 KB + 4 × 16.5 KB = 98 KB.
//   Pass 1 holds three 64×64 fp32 fragments a thread and pass 2 four; both
//   take one block an SM (127 and 168 registers a thread, no spill, nvcc
//   12.8; two blocks an SM or a 3-stage ring made no difference beyond the
//   noise). Gradients leave through the block's own tiles as 16-byte stores,
//   rounded once.
//
// "fma": fp32, and bf16 with d = 128: fp32 FMAs from fp32 tiles in shared
// memory with rows padded to d + 1; a thread owns 4 rows × 4 columns of a
// 64×64 score tile, which crosses shared memory between the products.
// Shared memory: pass 1 (4·64·(d+1) + 64·65 + 128)·4 bytes (84 KB at d = 64,
// 149 KB at d = 128), pass 2 (4·64·(d+1) + 2·64·65 + 128)·4 bytes (100 KB,
// 166 KB).

#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "flash_mma.cuh"

namespace {

// ---- shared by both routes, then the fp32-FMA kernels ("fma") ----

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

// ---- the tensor-core kernels ("mma": bf16, d = 64) ----

constexpr int kMmaRows = 128;    // rows a block owns: two warpgroups
constexpr int kMmaThreads = 256;
constexpr int kMmaStages = 4;
using bf16 = __nv_bfloat16;

constexpr size_t dq_mma_smem_bytes() {
  return 1024 + 2 * kMmaRows * udt::mma::kRowBytes + kMmaStages * 2 * udt::mma::kTileBytes +
         kMmaRows * sizeof(float);
}

constexpr size_t dkdv_mma_smem_bytes() {
  return 1024 + 2 * kMmaRows * udt::mma::kRowBytes +
         kMmaStages * (2 * udt::mma::kTileBytes + 2 * udt::mma::kTile * sizeof(float));
}

// Σ of the eight products of two 16-byte groups of bf16.
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 xf = __bfloat1622float2(x[i]), yf = __bfloat1622float2(y[i]);
    acc = fmaf(xf.x, yf.x, acc);
    acc = fmaf(xf.y, yf.y, acc);
  }
  return acc;
}

// Pass 1: dq (and delta) for 128 query rows.
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_bwd_dq_mma_kernel(BwdParams<bf16> p, float scale_log2) {
  namespace m = udt::mma;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = m::align_smem(smem_raw);
  const uint32_t q_tile = m::smem_u32(smem);                       // [128][64]
  const uint32_t g_tile = q_tile + kMmaRows * m::kRowBytes;        // dO [128][64]
  const uint32_t ring = g_tile + kMmaRows * m::kRowBytes;          // stages × (K | V)
  float* delta_s = reinterpret_cast<float*>(smem + 2 * kMmaRows * m::kRowBytes +
                                            kMmaStages * 2 * m::kTileBytes);  // [128]

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid / m::kWarpgroup, wg_thread = tid % m::kWarpgroup;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int q0 = blockIdx.x * kMmaRows;
  const int rows_valid = min(kMmaRows, p.Nq - q0);
  const bf16* qb = p.q + head_offset(p, kQ, b, h) + (long long)q0 * p.st[kQ][1];
  const bf16* ob = p.o + head_offset(p, kO, b, h) + (long long)q0 * p.st[kO][1];
  const bf16* gb = p.dout + head_offset(p, kDO, b, h) + (long long)q0 * p.st[kDO][1];
  const bf16* kb = p.k + head_offset(p, kK, b, h);
  const bf16* vb = p.v + head_offset(p, kV, b, h);
  const int tiles = p.Nk / m::kTile;

  auto load_kv = [&](int tile) {
    const uint32_t stage = ring + (tile % kMmaStages) * 2 * m::kTileBytes;
    const long long row = (long long)tile * m::kTile;
    m::load_rows_async<m::kTile, kMmaThreads>(stage, kb + row * p.st[kK][1], p.st[kK][1],
                                              m::kTile);
    m::load_rows_async<m::kTile, kMmaThreads>(stage + m::kTileBytes, vb + row * p.st[kV][1],
                                              p.st[kV][1], m::kTile);
  };

  m::load_rows_async<kMmaRows, kMmaThreads>(q_tile, qb, p.st[kQ][1], rows_valid);
  m::load_rows_async<kMmaRows, kMmaThreads>(g_tile, gb, p.st[kDO][1], rows_valid);
#pragma unroll
  for (int t = 0; t < kMmaStages - 1; ++t) {
    if (t < tiles) load_kv(t);
    m::cp_async_commit();
  }

  // delta = rowsum(dO ⊙ O): two threads a row, 32 columns each
  {
    const int row = tid >> 1, half = tid & 1;
    float acc = 0.f;
    if (row < rows_valid) {
      const uint4* g4 = reinterpret_cast<const uint4*>(gb + row * p.st[kDO][1] + half * 32);
      const uint4* o4 = reinterpret_cast<const uint4*>(ob + row * p.st[kO][1] + half * 32);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc += dot8(g4[i], o4[i]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      delta_s[row] = acc;
      if (row < rows_valid) p.delta[(long long)bh * p.Nq + q0 + row] = acc;
    }
  }
  __syncthreads();
  const int r = wg * m::kTile + (wg_thread >> 5) * 16 + (lane >> 2);  // row in the block
  const float* lse_b = p.lse + (long long)bh * p.Nq + q0;
  const float lse0 = r < rows_valid ? lse_b[r] * m::kLog2e : 0.f;
  const float lse1 = r + 8 < rows_valid ? lse_b[r + 8] * m::kLog2e : 0.f;
  const float delta0 = delta_s[r], delta1 = delta_s[r + 8];

  float dq[32], s[32], dp[32];
  uint32_t a[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  const uint32_t q_wg = q_tile + wg * m::kTileBytes, g_wg = g_tile + wg * m::kTileBytes;

  for (int j = 0; j < tiles; ++j) {
    m::cp_async_wait<kMmaStages - 2>();  // this thread's copies of tile j have landed
    m::fence_proxy_async();
    __syncthreads();                     // everyone's have, and tile j − 1 is no longer read
    if (j + kMmaStages - 1 < tiles) load_kv(j + kMmaStages - 1);
    m::cp_async_commit();
    const uint32_t k_tile = ring + (j % kMmaStages) * 2 * m::kTileBytes;

    m::wgmma_fence();
    m::tile_product_ss(s, q_wg, k_tile, false);
    m::tile_product_ss(dp, g_wg, k_tile + m::kTileBytes, false);
    m::wgmma_commit();
    m::wgmma_wait<0>();
    m::fence_accumulator(s);
    m::fence_accumulator(dp);

#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      s[i] = m::exp2_approx(fmaf(s[i], scale_log2, -lse0)) * (dp[i] - delta0);
      s[i + 1] = m::exp2_approx(fmaf(s[i + 1], scale_log2, -lse0)) * (dp[i + 1] - delta0);
      s[i + 2] = m::exp2_approx(fmaf(s[i + 2], scale_log2, -lse1)) * (dp[i + 2] - delta1);
      s[i + 3] = m::exp2_approx(fmaf(s[i + 3], scale_log2, -lse1)) * (dp[i + 3] - delta1);
    }
    m::pack_a_fragments(s, a);

    m::fence_accumulator(dq);
    m::wgmma_fence();
    m::tile_product_rs(dq, a, k_tile);
    m::wgmma_commit();
    m::wgmma_wait<0>();
    m::fence_accumulator(dq);
  }

  m::store_accumulator(dq, p.scale, p.scale, smem + wg * m::kTileBytes,
                       p.dq + head_offset(p, kDQ, b, h) +
                           (long long)(q0 + wg * m::kTile) * p.st[kDQ][1],
                       p.st[kDQ][1], rows_valid - wg * m::kTile, wg_thread, 1 + wg);
}

// Pass 2: dk and dv for 128 key rows.
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_bwd_dkdv_mma_kernel(BwdParams<bf16> p, float scale_log2) {
  namespace m = udt::mma;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = m::align_smem(smem_raw);
  const uint32_t k_tile = m::smem_u32(smem);                       // [128][64]
  const uint32_t v_tile = k_tile + kMmaRows * m::kRowBytes;        // [128][64]
  const uint32_t ring = v_tile + kMmaRows * m::kRowBytes;          // stages × (Q | dO)
  constexpr int kAuxOffset = 2 * kMmaRows * m::kRowBytes + kMmaStages * 2 * m::kTileBytes;
  // stages × (lse | delta) of the ring's query tiles
  const float* aux_s = reinterpret_cast<const float*>(smem + kAuxOffset);
  const uint32_t aux = k_tile + kAuxOffset;

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid / m::kWarpgroup, wg_thread = tid % m::kWarpgroup;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int k0 = blockIdx.x * kMmaRows;
  const int rows_valid = min(kMmaRows, p.Nk - k0);
  const bf16* qb = p.q + head_offset(p, kQ, b, h);
  const bf16* gb = p.dout + head_offset(p, kDO, b, h);
  const float* lse_b = p.lse + (long long)bh * p.Nq;
  const float* delta_b = p.delta + (long long)bh * p.Nq;
  const int tiles = p.Nq / m::kTile;

  auto load_q = [&](int tile) {
    const int st = tile % kMmaStages;
    const uint32_t stage = ring + st * 2 * m::kTileBytes;
    const long long row = (long long)tile * m::kTile;
    m::load_rows_async<m::kTile, kMmaThreads>(stage, qb + row * p.st[kQ][1], p.st[kQ][1],
                                              m::kTile);
    m::load_rows_async<m::kTile, kMmaThreads>(stage + m::kTileBytes, gb + row * p.st[kDO][1],
                                              p.st[kDO][1], m::kTile);
    // lse by threads 0-15, delta by threads 16-31
    const uint32_t dst = aux + st * 2 * m::kTile * sizeof(float);
    if (tid < 16) m::cp_async16(dst + tid * 16, lse_b + row + tid * 4);
    else if (tid < 32) m::cp_async16(dst + tid * 16, delta_b + row + (tid - 16) * 4);
  };

  m::load_rows_async<kMmaRows, kMmaThreads>(
      k_tile, p.k + head_offset(p, kK, b, h) + (long long)k0 * p.st[kK][1], p.st[kK][1],
      rows_valid);
  m::load_rows_async<kMmaRows, kMmaThreads>(
      v_tile, p.v + head_offset(p, kV, b, h) + (long long)k0 * p.st[kV][1], p.st[kV][1],
      rows_valid);
#pragma unroll
  for (int t = 0; t < kMmaStages - 1; ++t) {
    if (t < tiles) load_q(t);
    m::cp_async_commit();
  }

  float dk[32], dv[32], s[32], dp[32];
  uint32_t ap[16], ads[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  const uint32_t k_wg = k_tile + wg * m::kTileBytes, v_wg = v_tile + wg * m::kTileBytes;

  for (int j = 0; j < tiles; ++j) {
    m::cp_async_wait<kMmaStages - 2>();  // this thread's copies of tile j have landed
    m::fence_proxy_async();
    __syncthreads();                     // everyone's have, and tile j − 1 is no longer read
    if (j + kMmaStages - 1 < tiles) load_q(j + kMmaStages - 1);
    m::cp_async_commit();
    const int st = j % kMmaStages;
    const uint32_t q_stage = ring + st * 2 * m::kTileBytes;
    const float* lse_s = aux_s + st * 2 * m::kTile;
    const float* delta_s = lse_s + m::kTile;

    // the transposed tiles: rows are this warpgroup's keys, columns the queries
    m::wgmma_fence();
    m::tile_product_ss(s, k_wg, q_stage, false);
    m::tile_product_ss(dp, v_wg, q_stage + m::kTileBytes, false);
    m::wgmma_commit();
    m::wgmma_wait<0>();
    m::fence_accumulator(s);
    m::fence_accumulator(dp);

#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = 8 * jj + 2 * (lane & 3);
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + col);
      const float la = l2.x * m::kLog2e, lb = l2.y * m::kLog2e;
      const int i = 4 * jj;
      s[i] = m::exp2_approx(fmaf(s[i], scale_log2, -la));
      s[i + 1] = m::exp2_approx(fmaf(s[i + 1], scale_log2, -lb));
      s[i + 2] = m::exp2_approx(fmaf(s[i + 2], scale_log2, -la));
      s[i + 3] = m::exp2_approx(fmaf(s[i + 3], scale_log2, -lb));
      dp[i] = s[i] * (dp[i] - dl.x);
      dp[i + 1] = s[i + 1] * (dp[i + 1] - dl.y);
      dp[i + 2] = s[i + 2] * (dp[i + 2] - dl.x);
      dp[i + 3] = s[i + 3] * (dp[i + 3] - dl.y);
    }
    m::pack_a_fragments(s, ap);
    m::pack_a_fragments(dp, ads);

    m::fence_accumulator(dv);
    m::fence_accumulator(dk);
    m::wgmma_fence();
    m::tile_product_rs(dv, ap, q_stage + m::kTileBytes);  // dv += pᵀ·dO
    m::tile_product_rs(dk, ads, q_stage);                 // dk += dsᵀ·Q
    m::wgmma_commit();
    m::wgmma_wait<0>();
    m::fence_accumulator(dv);
    m::fence_accumulator(dk);
  }

  const long long row0 = k0 + wg * m::kTile;
  const int valid = rows_valid - wg * m::kTile;
  m::store_accumulator(dk, p.scale, p.scale, smem + wg * m::kTileBytes,
                       p.dk + head_offset(p, kDK, b, h) + row0 * p.st[kDK][1], p.st[kDK][1],
                       valid, wg_thread, 1 + wg);
  m::store_accumulator(dv, 1.f, 1.f, smem + kMmaRows * m::kRowBytes + wg * m::kTileBytes,
                       p.dv + head_offset(p, kDV, b, h) + row0 * p.st[kDV][1], p.st[kDV][1],
                       valid, wg_thread, 1 + wg);
}

cudaError_t launch_bwd_mma(const BwdParams<bf16>& p, int B, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_mma_smem_bytes();
  constexpr size_t smem_dkdv = dkdv_mma_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkdv);
  if (err != cudaSuccess) return err;
  const float scale_log2 = p.scale * udt::mma::kLog2e;
  flash_bwd_dq_mma_kernel<<<dim3((p.Nq + kMmaRows - 1) / kMmaRows, B * p.H), kMmaThreads, smem_dq,
                            stream>>>(p, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // same stream: pass 2 reads the delta pass 1 wrote
  flash_bwd_dkdv_mma_kernel<<<dim3((p.Nk + kMmaRows - 1) / kMmaRows, B * p.H), kMmaThreads,
                              smem_dkdv, stream>>>(p, scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, const void* o, const void* dout,
                const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int H, int Nq,
                int Nk, int D, const long long* strides, float scale, int route,
                cudaStream_t stream) {
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
  if constexpr (std::is_same<T, bf16>::value) {
    if (route == 1) return D == 64 ? launch_bwd_mma(p, B, stream) : cudaErrorInvalidValue;
    return D == 128 ? launch_bwd<T, 128>(p, B, stream) : cudaErrorInvalidValue;
  } else {
    if (route != 0) return cudaErrorInvalidValue;
    return D == 64 ? launch_bwd<T, 64>(p, B, stream) : launch_bwd<T, 128>(p, B, stream);
  }
}

}  // namespace

// q, o, dout, dq: (B, Nq, H, D); k, v, dk, dv: (B, Nk, H, D), each with unit
// stride on D; `strides` holds the (batch, token, head) element strides of
// q, k, v, o, dout, dq, dk, dv in that order (24 values). lse: (B, H, Nq)
// fp32 contiguous, from the forward. delta: (B, H, Nq) fp32 scratch. Nq and
// Nk are multiples of 64. route 1 ("mma"): bf16 with D = 64, every tensor on
// a 16-byte boundary with strides that are multiples of 8 elements; route 0
// ("fma"): fp32, or bf16 with D = 128. Returns cudaGetLastError() after the
// launches (or the first failing call), cudaErrorInvalidValue for what the
// route does not take.
extern "C" int udt_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                       const void* dout, const void* lse, void* delta, void* dq,
                                       void* dk, void* dv, int B, int H, int Nq, int Nk, int D,
                                       const long long* strides, float scale, int dtype,
                                       int route, void* stream) {
  if (Nq % kB != 0 || Nk % kB != 0 || (D != 64 && D != 128)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == udt::kBFloat16)
    return run<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Nq, Nk, D, strides,
                              scale, route, s);
  if (dtype == udt::kFloat32)
    return run<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Nq, Nk, D, strides, scale,
                      route, s);
  return cudaErrorInvalidValue;
}
