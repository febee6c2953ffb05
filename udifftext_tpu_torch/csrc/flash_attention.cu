// Flash-attention forward for Hopper (sm_90a): non-causal, unmasked
// softmax(q·kᵀ·scale)·v with fp32 statistics and accumulation.
//
// Replaces: udifftext_tpu/ops/flash_attention.py `_flash_fwd_impl` /
// `_flash_kernel` (the Pallas TPU kernel behind `flash_attention`).
//
// What it computes: for every (batch, head, query row) the exact softmax
// over all keys, with a running max and no clamp. It writes the output in
// the input dtype and, per row, the log-sum-exp `m + log(l)` in fp32 and
// natural-log units for the backward, which recomputes p = exp(s − lse).
// (The TPU kernel saved the max-free denominator of its clamped-exp softmax
// instead.) (B, N, H, D) is read through its strides, so the caller needs
// no transposes; the scale multiplies the fp32 logits, not q.
//
// What bounds it on the H100: at the UNet's shapes (N = 1024 or 4096,
// d = 64) attention is bound by operations, 4·N·d flops per 2·d bytes of q.
// At d = 64 the exponentials weigh as much as the products: a 64×64 score
// tile is 2 × 128 tensor-core cycles of an SM and 4096 / 16 = 256 cycles of
// its special-function units, so about half the tensor-core peak is the
// most a kernel of this shape can reach.
//
// Two kernels, chosen by the wrapper (ops/flash_attention.py
// `flash_kernel_route`):
//
// "mma": bf16, d = 64, every shape the UNet runs. Route taken: `wgmma`
// (not `mma.sync`), because the score tile it leaves in registers is
// already the A operand of the second product and because V can be read
// MN-major from the tile as it was loaded.
//   - One block of 256 threads per (128 query rows, batch·head): two
//     warpgroups of 64 rows each, at every shape. (ds2 at B = 2 is 160
//     blocks for 264 resident ones: one wave either way, and a 64-row
//     block would take as long as a 128-row one.) Nq % 128 == 64 leaves
//     the last block's second warpgroup without rows to store.
//   - S = Q·Kᵀ: m64n64k16 ×4 with Q and the K tile K-major in 128-byte
//     swizzled shared memory; the fp32 accumulator is the score tile. The
//     running max and sum are taken on it: a thread's own 16 values of each
//     of its two rows, then two shuffles across its quad; the sum stays a
//     per-thread partial until the end. p = exp2(s·scale·log2e − m) is
//     rounded to bf16 in registers and is the A operand of O += P·V, with
//     the V tile as the MN-major B operand. s and p never touch shared
//     memory; the output accumulator (32 registers) is rescaled in place.
//   - K/V tiles of 64 keys arrive through a ring of kStages = 3 stages
//     filled by 16-byte `cp.async`: tile j + 2 is in flight while tile j is
//     multiplied. One `__syncthreads()` per tile: it publishes the tile
//     that landed and frees the stage the next copy overwrites.
//   - Epilogue: acc / l rounded once to bf16 through the warpgroup's own Q
//     tile, rows written with 16-byte stores; lse = (m + log2 l)·ln 2.
//   Shared memory: 16 KB of Q + 3 × (8 KB K + 8 KB V) = 64 KB (+ 1 KB to
//   align), two blocks an SM; 128 registers a thread, the cap of two blocks
//   an SM, with no spill (nvcc 12.8; the build log has the numbers).
//   Tried and not kept, each slower on an NVIDIA H100 80GB HBM3 at every
//   shape: issuing the next tile's S before this tile's softmax, or S of tile
//   j + 1 together with P·V of tile j (ptxas serializes both, warnings
//   C7513/C7514: registers that feed or leave a wgmma change while another is
//   in flight), and folding the scale into the exponent's multiply-add. The
//   overlap of softmax and products comes from the four warpgroups an SM holds.
//
// "fma": fp32 inputs (which have no bf16 tensor-core path and serve the
// accuracy tests) and bf16 with d = 128 (no caller in the UNet). fp32 FMAs
// from fp32 tiles: one block of 256 threads per (64 query rows,
// batch·head), 64-key tiles loaded synchronously, scores through shared
// memory. Shared memory (64·d + 64·(d+1) + 64·d + 64·65 + 3·64)·4 bytes:
// 66 KB at d = 64, 116 KB at d = 128.

#include <math.h>

#include "common.cuh"
#include "flash_mma.cuh"

namespace {

// ---- the fp32-FMA kernel ("fma": fp32, and bf16 with d = 128) ----

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

// ---- the tensor-core kernel ("mma": bf16, d = 64) ----

constexpr int kMmaBQ = 128;      // query rows per block: two warpgroups
constexpr int kMmaThreads = 256;
constexpr int kMmaStages = 3;
constexpr int kMmaBlocks = 2;    // blocks an SM: caps the kernel at 128 registers a thread

// One 64×64 score tile of a warpgroup, in place: s (raw q·k) becomes
// p = exp2(s·scale_log2 − m) with the running max m0, m1 (rows r, r + 8, in
// base-2 units of the scaled logits) brought up to date; l0, l1 (this
// thread's share of the running sums) are rescaled and extended; a0, a1 are
// the factors exp2(m_old − m_new) the output accumulator is due (0 on the
// first tile).
__device__ __forceinline__ void softmax_tile(float (&s)[32], float scale_log2, float& m0,
                                             float& m1, float& l0, float& l1, float& a0,
                                             float& a1) {
  namespace m = udt::mma;
  float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < 32; i += 4) {
    s[i] *= scale_log2;
    s[i + 1] *= scale_log2;
    s[i + 2] *= scale_log2;
    s[i + 3] *= scale_log2;
    x0 = fmaxf(x0, fmaxf(s[i], s[i + 1]));
    x1 = fmaxf(x1, fmaxf(s[i + 2], s[i + 3]));
  }
  const float n0 = fmaxf(m0, m::quad_max(x0)), n1 = fmaxf(m1, m::quad_max(x1));
  a0 = m::exp2_approx(m0 - n0);
  a1 = m::exp2_approx(m1 - n1);
  m0 = n0;
  m1 = n1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < 32; i += 4) {
    s[i] = m::exp2_approx(s[i] - n0);
    s[i + 1] = m::exp2_approx(s[i + 1] - n0);
    s[i + 2] = m::exp2_approx(s[i + 2] - n1);
    s[i + 3] = m::exp2_approx(s[i + 3] - n1);
    sum0 += s[i] + s[i + 1];
    sum1 += s[i + 2] + s[i + 3];
  }
  l0 = l0 * a0 + sum0;
  l1 = l1 * a1 + sum1;
}

__device__ __forceinline__ void rescale_rows(float (&acc)[32], float a0, float a1) {
#pragma unroll
  for (int i = 0; i < 32; i += 4) {
    acc[i] *= a0;
    acc[i + 1] *= a0;
    acc[i + 2] *= a1;
    acc[i + 3] *= a1;
  }
}

constexpr size_t flash_mma_smem_bytes() {
  return 1024 + kMmaBQ * udt::mma::kRowBytes + kMmaStages * 2 * udt::mma::kTileBytes;
}

__global__ void __launch_bounds__(kMmaThreads, kMmaBlocks)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int H, int Nq, int Nk,
                     long long sqb, long long sqn, long long sqh,
                     long long skb, long long skn, long long skh,
                     long long svb, long long svn, long long svh,
                     long long sob, long long son, long long soh, float scale_log2) {
  namespace m = udt::mma;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = m::align_smem(smem_raw);
  const uint32_t q_tile = m::smem_u32(smem);                     // [128][64] bf16
  const uint32_t ring = q_tile + kMmaBQ * m::kRowBytes;          // stages × (K | V)

  const int tid = threadIdx.x;
  const int wg = tid / m::kWarpgroup, wg_thread = tid % m::kWarpgroup;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kMmaBQ;
  const int rows_valid = min(kMmaBQ, Nq - q0);
  const __nv_bfloat16* qb = q + b * sqb + h * sqh + (long long)q0 * sqn;
  const __nv_bfloat16* kb = k + b * skb + h * skh;
  const __nv_bfloat16* vb = v + b * svb + h * svh;
  const int tiles = Nk / m::kTile;

  auto load_kv = [&](int tile) {
    const uint32_t stage = ring + (tile % kMmaStages) * 2 * m::kTileBytes;
    const long long row = (long long)tile * m::kTile;
    m::load_rows_async<m::kTile, kMmaThreads>(stage, kb + row * skn, skn, m::kTile);
    m::load_rows_async<m::kTile, kMmaThreads>(stage + m::kTileBytes, vb + row * svn, svn,
                                              m::kTile);
  };

  // prologue: Q and the first kStages − 1 tiles, one commit group per tile
  m::load_rows_async<kMmaBQ, kMmaThreads>(q_tile, qb, sqn, rows_valid);
#pragma unroll
  for (int t = 0; t < kMmaStages - 1; ++t) {
    if (t < tiles) load_kv(t);
    m::cp_async_commit();
  }

  float acc[32], s[32];
  uint32_t p[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r, r + 8 (base-2 units)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the running sums
  const uint32_t q_wg = q_tile + wg * m::kTileBytes;

  for (int j = 0; j < tiles; ++j) {
    m::cp_async_wait<kMmaStages - 2>();  // this thread's copies of tile j have landed
    m::fence_proxy_async();
    __syncthreads();                     // everyone's have, and tile j − 1 is no longer read
    if (j + kMmaStages - 1 < tiles) load_kv(j + kMmaStages - 1);
    m::cp_async_commit();
    const uint32_t k_tile = ring + (j % kMmaStages) * 2 * m::kTileBytes;

    m::wgmma_fence();
    m::tile_product_ss(s, q_wg, k_tile, false);
    m::wgmma_commit();
    m::wgmma_wait<0>();
    m::fence_accumulator(s);

    float a0, a1;
    softmax_tile(s, scale_log2, m0, m1, l0, l1, a0, a1);
    rescale_rows(acc, a0, a1);
    m::pack_a_fragments(s, p);

    m::fence_accumulator(acc);
    m::wgmma_fence();
    m::tile_product_rs(acc, p, k_tile + m::kTileBytes);
    m::wgmma_commit();
    m::wgmma_wait<0>();
    m::fence_accumulator(acc);
  }

  l0 = m::quad_sum(l0);
  l1 = m::quad_sum(l1);
  const int lane = tid & 31;
  const int r = wg * m::kTile + (wg_thread >> 5) * 16 + (lane >> 2);  // row in the block
  if ((lane & 3) == 0) {
    float* lse_b = lse + (long long)bh * Nq + q0;
    if (r < rows_valid) lse_b[r] = (m0 + log2f(l0)) * m::kLn2;
    if (r + 8 < rows_valid) lse_b[r + 8] = (m1 + log2f(l1)) * m::kLn2;
  }
  m::store_accumulator(acc, 1.f / l0, 1.f / l1, smem + wg * m::kTileBytes,
                       o + b * sob + h * soh + (long long)(q0 + wg * m::kTile) * son, son,
                       rows_valid - wg * m::kTile, wg_thread, 1 + wg);
}

cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int H, int Nq, int Nk, const long long* st, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = flash_mma_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  using T = __nv_bfloat16;
  dim3 grid((Nq + kMmaBQ - 1) / kMmaBQ, B * H);
  flash_fwd_mma_kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, Nq, Nk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale * udt::mma::kLog2e);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, N, H, D) with unit stride on D; `strides` holds the
// (batch, token, head) element strides of q, k, v, o in that order (12
// values). lse: (B, H, Nq) fp32, contiguous. Nq and Nk are multiples of 64.
// route 1 ("mma"): bf16 with D = 64, q, k, v on 16-byte boundaries with
// strides that are multiples of 8 elements; route 0 ("fma"): fp32, or bf16
// with D = 128. Returns cudaGetLastError() after the launch (or the first
// failing call), cudaErrorInvalidValue for what the route does not take.
extern "C" int udt_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int B, int H, int Nq, int Nk, int D,
                                       const long long* strides, float scale, int dtype,
                                       int route, void* stream) {
  if (Nq % kBQ != 0 || Nk % kBK != 0 || (D != 64 && D != 128)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (route == 1) {
    if (dtype != udt::kBFloat16 || D != 64) return cudaErrorInvalidValue;
    return launch_mma(q, k, v, o, l, B, H, Nq, Nk, strides, scale, s);
  }
  if (route != 0) return cudaErrorInvalidValue;
  if (dtype == udt::kBFloat16 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, l, B, H, Nq, Nk, strides, scale, s);
  if (dtype == udt::kFloat32) {
    return D == 64 ? launch<float, 64>(q, k, v, o, l, B, H, Nq, Nk, strides, scale, s)
                   : launch<float, 128>(q, k, v, o, l, B, H, Nq, Nk, strides, scale, s);
  }
  return cudaErrorInvalidValue;
}
