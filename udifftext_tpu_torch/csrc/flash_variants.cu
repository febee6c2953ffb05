// Flash-attention forward variants for Hopper (sm_90a), for a layout probe:
// attention of q·kᵀ·scale over v on (B·H, N, 64) contiguous tensors, four
// schedules that answer which flash-forward layout is fastest on this card.
//
// Replaces: scripts/flash_variants.py `run_variant` → `_kernel_v2` :37 (v2;
// with `clamp_exp`, v4) and `_kernel_v3` :76 (v3), and `v1_fn` :162, which
// runs the shipped TPU forward `udifftext_tpu/ops/flash_attention.py`
// `_flash_kernel` at caller-chosen block sizes (v1).
//
//   v1 = rows layout, clamp 75: `_flash_kernel`'s function. p =
//        exp(clip(s·scale, ±75)), out = Σp·v / Σp, and log Σp (the log of the
//        TPU kernel's saved `l`). It equals softmax and its log-sum-exp while
//        no logit leaves ±75.
//   v2 = transposed layout, online max: exact softmax.
//   v3 = rows layout, clamp 60; v4 = transposed layout, clamp 60.
//   The clamped forms keep no running max: 60 (75) + ln 4096 < 88.7, so
//   neither Σp nor the fp32 accumulators overflow for N up to 4096.
//
// What bounds it on the H100: operations. 4·N²·64 flops a head against
// 4·N·64 elements moved: 0.6948 ms at B·H = 160, N = 4096 (989 TFLOP/s bf16),
// with the exponentials as heavy as the products at d = 64 (a 64×64 score
// tile is 2 × 128 tensor-core cycles of an SM and 256 cycles of its
// special-function units), so about half the tensor-core peak is the most a
// kernel of this shape reaches.
//
// bf16: `flash_variant_mma_kernel<BQ, BK, TR, CLAMP>`, `wgmma` throughout.
//   - K and V tiles of BK keys arrive through a ring of 3 stages filled by
//     16-byte `cp.async` into 128-byte-swizzled shared memory (flash_mma.cuh);
//     one `__syncthreads()` a step publishes the tile that landed and frees
//     the stage the next copy overwrites.
//   - Rows layout (TR false; v1, v3), the shipped forward's structure
//     (flash_attention.cu "mma"): one warpgroup per 64 query rows (BQ = 64 or
//     128). S = Q·Kᵀ (m64nBKk16, BK = 64 or 128) stays in registers; p =
//     exp2(clamp(s·scale·log2e, ±C·log2e)) is rounded there into the A
//     fragments of O += P·V, which reads V MN-major from the tile as it
//     landed. No row max, no alpha, no rescale of the accumulator; the sum
//     is a per-thread partial until the epilogue. The online-max form of this
//     layout is the shipped forward, which the probe times beside these.
//   - Transposed layout (TR true; v2, v4): one warpgroup per 64 keys of a
//     step (BK = 64 or 128), every warpgroup over all BQ queries. sᵀ = K·Qᵀ
//     is m64nBQk16, so the query axis is the wide N (the Hopper counterpart
//     of the TPU's "result lanes = bq"); accᵀ (64 d × BQ) += Vᵀ·Pᵀ is
//     m64nBQk16 with both operands MN-major (V as it landed). pᵀ is the B
//     operand there, so it cannot stay in registers: it crosses shared memory
//     once a step as one swizzled MN-major tile per 64 queries, the cost this
//     layout pays on Hopper. A query is a column spread over the four warps:
//     v4 keeps per-thread partial column sums and reduces them once at the
//     end; v2 needs the column max of every step across the warps (shuffles
//     over the 8 lanes of a column, then shared memory and a warpgroup
//     barrier) and rescales accᵀ by column. The warpgroups of a block keep
//     their own max, sum and accᵀ, combined in the epilogue, where accᵀ is
//     transposed once through an fp32 tile and leaves in 16-byte row stores.
//   - ptxas: every `wgmma` group is waited for before its registers are
//     touched (C7513/C7514 otherwise, as in flash_attention.cu).
//   Shared memory: Q BQ × 128 B, the ring 3 × 2 × BK × 128 B, and for the
//   transposed layout pᵀ (BQ × 128 B a warpgroup) and the column exchange.
// fp32: `flash_variant_fma_kernel`, FMAs from fp32 tiles with the logits
// through shared memory, for the accuracy check (the JAX probe runs bf16
// only); tiles (64, 64).

#include <math.h>

#include "common.cuh"
#include "flash_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace m = udt::mma;

constexpr int kD = 64;  // head width

// ---- fp32: the FMA kernel ----

constexpr int kFmaThreads = 256;

// Shared-memory plan of one fp32 instantiation, in floats.
template <int BQ, int BK, bool TR>
struct FmaPlan {
  static constexpr int kLdIn = kD + 4;                    // q, k, v rows
  static constexpr int kParts = kFmaThreads / BQ;         // threads sharing a query (TR)
  static constexpr int kSRows = TR ? BK : BQ;
  static constexpr int kSCols = TR ? BQ : BK;
  // TR: lanes read (key = i·parts + part, query) with 32/parts queries a
  // warp, so a pitch of 32/parts mod 32 spreads them over all banks.
  static constexpr int kLdS = kSCols + (TR ? 32 / kParts : 4);
  static constexpr int kLdO = kD + 4;                     // output tile, aliases s
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + BQ * kLdIn;
  static constexpr int kV = kK + BK * kLdIn;
  static constexpr int kS = kV + BK * kLdIn;
  static constexpr int kSFloats = kSRows * kLdS > BQ * kLdO ? kSRows * kLdS : BQ * kLdO;
  static constexpr int kA = kS + kSFloats;                // alpha per query
  static constexpr int kStat = kA + BQ;                   // row max, row sum
  static constexpr size_t kBytes = sizeof(float) * (kStat + 2 * BQ);
  static_assert(kFmaThreads % BQ == 0 && BK % 32 == 0 && BK % kParts == 0, "tile sizes");
};

// `rows` rows of kD floats from global (row pitch kD) to shared (pitch ld).
__device__ __forceinline__ void load_rows_f32(float* dst, int ld, const float* __restrict__ src,
                                              int rows) {
  for (int i = threadIdx.x; i < rows * kD / 4; i += kFmaThreads) {
    const int r = i / (kD / 4), c = i - r * (kD / 4);
    *reinterpret_cast<float4*>(dst + r * ld + 4 * c) =
        *reinterpret_cast<const float4*>(src + (size_t)r * kD + 4 * c);
  }
}

template <int BQ, int BK, bool TR, bool CLAMP>
__global__ void __launch_bounds__(kFmaThreads)
flash_variant_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int Nq, int Nk, float scale, float clamp) {
  using P = FmaPlan<BQ, BK, TR>;
  constexpr int LDI = P::kLdIn, LDS = P::kLdS, LDO = P::kLdO;
  extern __shared__ __align__(16) float smem_fv[];
  float* Qs = smem_fv + P::kQ;  // [BQ][LDI]
  float* Ks = smem_fv + P::kK;  // [BK][LDI]
  float* Vs = smem_fv + P::kV;  // [BK][LDI]
  float* Ss = smem_fv + P::kS;  // s, then p in place: [BQ][LDS], TR: [BK][LDS]
  float* At = smem_fv + P::kA;
  float* row_m = smem_fv + P::kStat;
  float* row_l = row_m + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const float* kb = k + (size_t)bh * Nk * kD;
  const float* vb = v + (size_t)bh * Nk * kD;

  load_rows_f32(Qs, LDI, q + ((size_t)bh * Nq + q0) * kD, BQ);
  if (tid < BQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }
  // a thread owns output (row tid/64 + 4j, column tid%64), j < BQ/4
  constexpr int FJ = BQ / 4;
  const int f_r0 = tid / kD, f_d = tid % kD;
  // TR softmax: a thread owns query column tid/parts and keys i·parts + part
  constexpr int PARTS = P::kParts;
  const int t_q = tid / PARTS, t_part = tid % PARTS;
  float col_m = -INFINITY, col_l = 0.f;
  float acc[FJ];
#pragma unroll
  for (int j = 0; j < FJ; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += BK) {
    __syncthreads();  // the previous tile's k, v, p and alpha are no longer read
    load_rows_f32(Ks, LDI, kb + (size_t)k0 * kD, BK);
    load_rows_f32(Vs, LDI, vb + (size_t)k0 * kD, BK);
    __syncthreads();

    // logits: s (BQ × BK), or sᵀ (BK × BQ); consecutive threads take
    // consecutive elements of a row of it
    for (int i = tid; i < BQ * BK; i += kFmaThreads) {
      const int r = TR ? i % BQ : i / BK, c = TR ? i / BQ : i % BK;
      const float4* qa4 = reinterpret_cast<const float4*>(Qs + r * LDI);
      const float4* ka4 = reinterpret_cast<const float4*>(Ks + c * LDI);
      float s = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < kD / 4; ++d4) {
        const float4 a = qa4[d4], b = ka4[d4];
        s = fmaf(a.x, b.x, s);
        s = fmaf(a.y, b.y, s);
        s = fmaf(a.z, b.z, s);
        s = fmaf(a.w, b.w, s);
      }
      Ss[TR ? c * LDS + r : r * LDS + c] = s * scale;
    }
    __syncthreads();

    // p in place of s, alpha, running statistics
    if constexpr (!TR) {
      constexpr int RPW = BQ / (kFmaThreads / 32), KPL = BK / 32;  // rows a warp, keys a lane
      for (int rr = 0; rr < RPW; ++rr) {
        const int r = warp * RPW + rr;
        float* sr = Ss + r * LDS;
        float sv[KPL];
#pragma unroll
        for (int j = 0; j < KPL; ++j) sv[j] = sr[lane + 32 * j];
        float sum = 0.f;
        float m_new = 0.f;
        if constexpr (!CLAMP) {
          float mx = sv[0];
#pragma unroll
          for (int j = 1; j < KPL; ++j) mx = fmaxf(mx, sv[j]);
          m_new = fmaxf(row_m[r], udt::warp_max(mx));
        }
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          sv[j] = CLAMP ? expf(fminf(fmaxf(sv[j], -clamp), clamp)) : expf(sv[j] - m_new);
          sum += sv[j];
          sr[lane + 32 * j] = sv[j];
        }
        sum = udt::warp_sum(sum);
        if (lane == 0) {
          if constexpr (CLAMP) {
            row_l[r] += sum;
          } else {
            const float alpha = expf(row_m[r] - m_new);  // 0 on the first tile
            At[r] = alpha;
            row_l[r] = row_l[r] * alpha + sum;
            row_m[r] = m_new;
          }
        }
      }
    } else {
      // a thread walks down its query column over keys i·PARTS + part; the
      // PARTS threads of a column are neighbouring lanes
      constexpr int KPT = BK / PARTS;
      float m_new = 0.f;
      if constexpr (!CLAMP) {
        float mx = -INFINITY;
#pragma unroll 8
        for (int i = 0; i < KPT; ++i) mx = fmaxf(mx, Ss[(i * PARTS + t_part) * LDS + t_q]);
#pragma unroll
        for (int off = PARTS / 2; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        m_new = fmaxf(col_m, mx);
      }
      float sum = 0.f;
#pragma unroll 8
      for (int i = 0; i < KPT; ++i) {
        float* sp = Ss + (i * PARTS + t_part) * LDS + t_q;
        const float p = CLAMP ? expf(fminf(fmaxf(*sp, -clamp), clamp)) : expf(*sp - m_new);
        sum += p;
        *sp = p;
      }
#pragma unroll
      for (int off = PARTS / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if constexpr (CLAMP) {
        col_l += sum;
      } else {
        const float alpha = expf(col_m - m_new);  // 0 on the first tile
        if (t_part == 0) At[t_q] = alpha;
        col_l = col_l * alpha + sum;
        col_m = m_new;
      }
    }
    __syncthreads();

    // acc = acc·alpha + p·v
    if constexpr (!CLAMP) {
#pragma unroll
      for (int j = 0; j < FJ; ++j) acc[j] *= At[f_r0 + 4 * j];
    }
    for (int kk = 0; kk < BK; ++kk) {
      const float vv = Vs[kk * LDI + f_d];
#pragma unroll
      for (int j = 0; j < FJ; ++j) {
        const int r = f_r0 + 4 * j;
        acc[j] = fmaf(TR ? Ss[kk * LDS + r] : Ss[r * LDS + kk], vv, acc[j]);
      }
    }
  }

  // out = acc / l through a (BQ × d) tile that aliases s
  __syncthreads();
  float* Os = Ss;
#pragma unroll
  for (int j = 0; j < FJ; ++j) Os[(f_r0 + 4 * j) * LDO + f_d] = acc[j];
  if constexpr (TR) {
    if (t_part == 0) {
      row_l[t_q] = col_l;
      row_m[t_q] = col_m;
    }
  }
  __syncthreads();
  float* ob = o + ((size_t)bh * Nq + q0) * kD;
  for (int i = tid; i < BQ * kD; i += kFmaThreads) ob[i] = Os[(i / kD) * LDO + i % kD] / row_l[i / kD];
  if (lse != nullptr && tid < BQ)
    lse[(size_t)bh * Nq + q0 + tid] = CLAMP ? logf(row_l[tid]) : row_m[tid] + logf(row_l[tid]);
}

// ---- bf16: the wgmma kernel ----

constexpr int kStages = 3;

// Shared-memory plan and launch shape of one bf16 instantiation; byte
// offsets from the 1024-byte-aligned base.
template <int BQ, int BK, bool TR>
struct MmaPlan {
  static constexpr int kWarpgroups = (TR ? BK : BQ) / 64;
  static constexpr int kThreads = kWarpgroups * m::kWarpgroup;
  static constexpr int kStageBytes = 2 * BK * m::kRowBytes;  // BK K rows, then BK V rows
  static constexpr int kQ = 0;
  static constexpr int kRing = kQ + BQ * m::kRowBytes;
  // TR: pᵀ of each warpgroup (64 keys × BQ queries, BQ/64 swizzled tiles)
  static constexpr int kP = kRing + kStages * kStageBytes;
  static constexpr int kRed = kP + (TR ? kWarpgroups * BQ * m::kRowBytes : 0);
  // TR: per-warp column partials [warpgroup][warp][BQ], then [warpgroup][BQ]
  // column maxima
  static constexpr int kColMax = kRed + (TR ? 4 * kWarpgroups * 4 * BQ : 0);
  static constexpr int kEnd = kColMax + (TR ? 4 * kWarpgroups * BQ : 0);
  static constexpr size_t kBytes = 1024 + kEnd;  // + the alignment of the base
  // TR epilogue: accᵀ of each warpgroup as an fp32 [BQ][kLdO] tile in the ring
  static constexpr int kLdO = kD + 4;
  static_assert(!TR || kWarpgroups * BQ * kLdO * 4 <= kStages * kStageBytes, "staging");
  // registers a thread needs (accumulators: rows 32 + S BK/2 + P BK/4;
  // transposed 2·BQ/2 + column statistics) set how many blocks an SM may hold
  static constexpr int kRegCap = TR ? (BQ == 64 ? 128 : 255) : (BK == 64 ? 128 : 168);
  static constexpr int kBySmem = (228 * 1024) / (int)(kBytes + 1024);
  static constexpr int kByRegs = 65536 / (kThreads * kRegCap);
  static constexpr int kMinBlocks =
      (kBySmem < kByRegs ? kBySmem : kByRegs) < 1 ? 1 : (kBySmem < kByRegs ? kBySmem : kByRegs);
};

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 × N) = A·Bᵀ over 64 columns, A and B K-major swizzled tiles (B N
// rows). Starts four wgmma; the caller fences before and commits after.
template <int N>
__device__ __forceinline__ void product_kmajor(float (&d)[N / 2], uint64_t da, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // 16 columns = 32 bytes further along the rows
    if constexpr (N == 64) m::wgmma_ss(d, da + 2 * kk, db + 2 * kk, kk > 0 ? 1 : 0);
    else m::wgmma_ss_n128<0>(d, da + 2 * kk, db + 2 * kk, kk > 0 ? 1 : 0);
  }
}

// d (64 × N) += A·B over 64 rows, A and B MN-major: rows of both are the
// reduction index.
template <int N>
__device__ __forceinline__ void product_mnmajor(float (&d)[N / 2], uint64_t da, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // 16 rows = 2048 bytes further down
    if constexpr (N == 64) m::wgmma_ss_mn(d, da + 128 * kk, db + 128 * kk, 1);
    else m::wgmma_ss_n128<1>(d, da + 128 * kk, db + 128 * kk, 1);
  }
}

__device__ __forceinline__ float clamped_exp2(float x, float c) {
  return m::exp2_approx(fminf(fmaxf(x, -c), c));
}

// scale_log2 = scale·log2e; clamp_log2 = C·log2e (CLAMP only).
template <int BQ, int BK, bool TR, bool CLAMP>
__global__ void __launch_bounds__(MmaPlan<BQ, BK, TR>::kThreads, MmaPlan<BQ, BK, TR>::kMinBlocks)
flash_variant_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int Nq, int Nk, float scale_log2,
                         float clamp_log2) {
  using P = MmaPlan<BQ, BK, TR>;
  constexpr int kThreads = P::kThreads;
  static_assert(TR || CLAMP, "the rows layout with the online max is csrc/flash_attention.cu");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = m::align_smem(smem_raw);
  const uint32_t base = m::smem_u32(smem);
  const uint32_t q_tile = base + P::kQ, ring = base + P::kRing;

  const int tid = threadIdx.x, wg = tid / m::kWarpgroup, wg_thread = tid % m::kWarpgroup;
  const int warp = wg_thread / 32, lane = tid & 31;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const bf16* kb = k + (size_t)bh * Nk * kD;
  const bf16* vb = v + (size_t)bh * Nk * kD;
  const int tiles = Nk / BK;

  auto load_kv = [&](int tile) {
    const uint32_t stage = ring + (tile % kStages) * P::kStageBytes;
    const long long row = (long long)tile * BK;
    m::load_rows_async<BK, kThreads>(stage, kb + row * kD, kD, BK);
    m::load_rows_async<BK, kThreads>(stage + BK * m::kRowBytes, vb + row * kD, kD, BK);
  };
  // prologue: Q and the first kStages − 1 tiles, one commit group per tile
  m::load_rows_async<BQ, kThreads>(q_tile, q + ((size_t)bh * Nq + q0) * kD, kD, BQ);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < tiles) load_kv(t);
    m::cp_async_commit();
  }
  // the start of step j: tile j has landed for everyone, tile j − 1 is free
  auto next_tile = [&](int j) {
    m::cp_async_wait<kStages - 2>();
    m::fence_proxy_async();
    __syncthreads();
    if (j + kStages - 1 < tiles) load_kv(j + kStages - 1);
    m::cp_async_commit();
    return ring + (j % kStages) * P::kStageBytes;
  };

  if constexpr (!TR) {
    // ---- rows: this warpgroup's 64 queries against BK keys a step ----
    constexpr int NS = BK / 2;  // registers of the 64 × BK score tile
    float acc[32], s[NS];
    uint32_t p[NS / 2];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float l0 = 0.f, l1 = 0.f;  // this thread's share of the sums of rows r, r + 8
    const uint64_t dq = m::tile_descriptor(q_tile + wg * m::kTileBytes);

    for (int j = 0; j < tiles; ++j) {
      const uint32_t k_tile = next_tile(j);
      m::wgmma_fence();
      product_kmajor<BK>(s, dq, m::tile_descriptor(k_tile));
      m::wgmma_commit();
      m::wgmma_wait<0>();
      fence_regs(s);

#pragma unroll
      for (int i = 0; i < NS; i += 4) {
        s[i] = clamped_exp2(s[i] * scale_log2, clamp_log2);
        s[i + 1] = clamped_exp2(s[i + 1] * scale_log2, clamp_log2);
        s[i + 2] = clamped_exp2(s[i + 2] * scale_log2, clamp_log2);
        s[i + 3] = clamped_exp2(s[i + 3] * scale_log2, clamp_log2);
        l0 += s[i] + s[i + 1];
        l1 += s[i + 2] + s[i + 3];
      }
      // fragment kk of P: keys 16kk .. 16kk + 15 (m::pack_a_fragments' layout)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        p[4 * kk + 0] = m::pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        p[4 * kk + 1] = m::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[4 * kk + 2] = m::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[4 * kk + 3] = m::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      m::fence_accumulator(acc);
      m::wgmma_fence();
      const uint64_t dv = m::tile_descriptor(k_tile + BK * m::kRowBytes);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // V rows 16kk .. 16kk + 15, 2048 bytes apart
        m::wgmma_rs(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3], dv + 128 * kk, 1);
      m::wgmma_commit();
      m::wgmma_wait<0>();
      m::fence_accumulator(acc);
    }

    l0 = m::quad_sum(l0);
    l1 = m::quad_sum(l1);
    const int r = wg * m::kTile + warp * 16 + (lane >> 2);  // row in the block
    if (lse != nullptr && (lane & 3) == 0) {
      float* lse_b = lse + (size_t)bh * Nq + q0;
      lse_b[r] = log2f(l0) * m::kLn2;
      lse_b[r + 8] = log2f(l1) * m::kLn2;
    }
    m::store_accumulator(acc, 1.f / l0, 1.f / l1, smem + P::kQ + wg * m::kTileBytes,
                         o + ((size_t)bh * Nq + q0 + wg * m::kTile) * kD, kD, m::kTile,
                         wg_thread, 1 + wg);
  } else {
    // ---- transposed: this warpgroup's 64 keys of a step against all BQ queries ----
    constexpr int NA = BQ / 2;  // registers of a 64 × BQ accumulator
    constexpr int NC = BQ / 4;  // query columns a thread holds: 8j + cq + e, j < BQ/8, e < 2
    float acc[NA], s[NA], col_l[NC], col_m[CLAMP ? 1 : NC];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) col_l[c] = 0.f;
    if constexpr (!CLAMP) {
#pragma unroll
      for (int c = 0; c < NC; ++c) col_m[c] = -INFINITY;
    }
    const int r = warp * 16 + (lane >> 2);  // key row of sᵀ and pᵀ, d row of accᵀ
    const int cq = 2 * (lane & 3);
    unsigned char* p_tile = smem + P::kP + wg * BQ * m::kRowBytes;
    float* red = reinterpret_cast<float*>(smem + P::kRed) + wg * 4 * BQ;  // [warp][BQ]
    const uint64_t dq = m::tile_descriptor(q_tile);
    const uint64_t dp = m::tile_descriptor_mn(m::smem_u32(p_tile), m::kTileBytes);

    for (int j = 0; j < tiles; ++j) {
      const uint32_t stage = next_tile(j);
      const uint32_t k_tile = stage + wg * m::kTileBytes;
      m::wgmma_fence();
      product_kmajor<BQ>(s, m::tile_descriptor(k_tile), dq);
      m::wgmma_commit();
      m::wgmma_wait<0>();
      fence_regs(s);

      if constexpr (CLAMP) {
#pragma unroll
        for (int jj = 0; jj < BQ / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[4 * jj + e] = clamped_exp2(s[4 * jj + e] * scale_log2, clamp_log2);
            s[4 * jj + 2 + e] = clamped_exp2(s[4 * jj + 2 + e] * scale_log2, clamp_log2);
            col_l[2 * jj + e] += s[4 * jj + e] + s[4 * jj + 2 + e];
          }
      } else {
        // the step's column max: a thread's two rows, the 8 lanes of a
        // column, then the four warps through shared memory
#pragma unroll
        for (int jj = 0; jj < BQ / 8; ++jj) {
          float mx[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[4 * jj + e] *= scale_log2;
            s[4 * jj + 2 + e] *= scale_log2;
            mx[e] = fmaxf(s[4 * jj + e], s[4 * jj + 2 + e]);
#pragma unroll
            for (int off = 4; off < 32; off <<= 1)
              mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], off));
          }
          if (lane < 4)
            *reinterpret_cast<float2*>(red + warp * BQ + 8 * jj + cq) = make_float2(mx[0], mx[1]);
        }
        m::named_barrier(1 + wg, m::kWarpgroup);
#pragma unroll
        for (int jj = 0; jj < BQ / 8; ++jj) {
          float2 t = *reinterpret_cast<const float2*>(red + 8 * jj + cq);
#pragma unroll
          for (int w = 1; w < 4; ++w) {
            const float2 u = *reinterpret_cast<const float2*>(red + w * BQ + 8 * jj + cq);
            t.x = fmaxf(t.x, u.x);
            t.y = fmaxf(t.y, u.y);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 2 * jj + e;
            const float m_new = fmaxf(col_m[c], e == 0 ? t.x : t.y);
            const float alpha = m::exp2_approx(col_m[c] - m_new);  // 0 on the first step
            col_m[c] = m_new;
            acc[4 * jj + e] *= alpha;
            acc[4 * jj + 2 + e] *= alpha;
            s[4 * jj + e] = m::exp2_approx(s[4 * jj + e] - m_new);
            s[4 * jj + 2 + e] = m::exp2_approx(s[4 * jj + 2 + e] - m_new);
            col_l[c] = col_l[c] * alpha + s[4 * jj + e] + s[4 * jj + 2 + e];
          }
        }
      }

      // pᵀ to shared memory, rounded to bf16: rows are keys, 64 queries a
      // swizzled tile (the MN-major B operand of accᵀ += Vᵀ·Pᵀ)
#pragma unroll
      for (int jj = 0; jj < BQ / 8; ++jj) {
        unsigned char* t = p_tile + (jj / 8) * m::kTileBytes;
        *reinterpret_cast<uint32_t*>(t + m::swizzled(r, jj % 8) + 2 * cq) =
            m::pack_bf16(s[4 * jj], s[4 * jj + 1]);
        *reinterpret_cast<uint32_t*>(t + m::swizzled(r + 8, jj % 8) + 2 * cq) =
            m::pack_bf16(s[4 * jj + 2], s[4 * jj + 3]);
      }
      m::fence_proxy_async();
      m::named_barrier(1 + wg, m::kWarpgroup);

      fence_regs(acc);
      m::wgmma_fence();
      product_mnmajor<BQ>(acc, m::tile_descriptor(stage + BK * m::kRowBytes + wg * m::kTileBytes),
                          dp);
      m::wgmma_commit();
      m::wgmma_wait<0>();
      fence_regs(acc);
    }

    // column sums over the 8 lanes of a column, then the warps and
    // warpgroups through shared memory; the warpgroups' maxima combined
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) col_l[c] += __shfl_xor_sync(0xffffffffu, col_l[c], off);
    m::cp_async_wait<0>();  // only empty groups are left; the ring is reused below
    __syncthreads();        // every warpgroup is past its last exchange
    float* col_max = reinterpret_cast<float*>(smem + P::kColMax);  // [warpgroup][BQ]
    if (lane < 4) {
#pragma unroll
      for (int jj = 0; jj < BQ / 8; ++jj) {
        *reinterpret_cast<float2*>(red + warp * BQ + 8 * jj + cq) =
            make_float2(col_l[2 * jj], col_l[2 * jj + 1]);
        if constexpr (!CLAMP) {
          if (warp == 0)
            *reinterpret_cast<float2*>(col_max + wg * BQ + 8 * jj + cq) =
                make_float2(col_m[2 * jj], col_m[2 * jj + 1]);
        }
      }
    }
    __syncthreads();
    const float* red_all = reinterpret_cast<const float*>(smem + P::kRed);
#pragma unroll
    for (int jj = 0; jj < BQ / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * jj + cq + e;
        float mx = 0.f;  // the clamped forms have no max: 0 in every warpgroup
        if constexpr (!CLAMP) {
          mx = col_max[col];
#pragma unroll
          for (int w = 1; w < P::kWarpgroups; ++w) mx = fmaxf(mx, col_max[w * BQ + col]);
        }
        float l = 0.f;
#pragma unroll
        for (int w = 0; w < P::kWarpgroups; ++w) {
          float lw = 0.f;
#pragma unroll
          for (int x = 0; x < 4; ++x) lw += red_all[(w * 4 + x) * BQ + col];
          l += CLAMP ? lw : lw * m::exp2_approx(col_max[w * BQ + col] - mx);
        }
        const float f = (CLAMP ? 1.f : m::exp2_approx(col_m[CLAMP ? 0 : 2 * jj + e] - mx)) / l;
        acc[4 * jj + e] *= f;
        acc[4 * jj + 2 + e] *= f;
      }

    // accᵀ transposed through an fp32 [query][d] tile a warpgroup, the
    // warpgroups' tiles summed, rows leaving in 16-byte stores
    constexpr int LDO = P::kLdO;
    float* stage = reinterpret_cast<float*>(smem + P::kRing);
    float* mine = stage + wg * BQ * LDO;
#pragma unroll
    for (int jj = 0; jj < BQ / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * jj + cq + e;
        mine[col * LDO + r] = acc[4 * jj + e];
        mine[col * LDO + r + 8] = acc[4 * jj + 2 + e];
      }
    __syncthreads();
    bf16* ob = o + ((size_t)bh * Nq + q0) * kD;
    for (int idx = tid; idx < BQ * 8; idx += kThreads) {
      const int row = idx >> 3, chunk = idx & 7;
      float4 a = *reinterpret_cast<const float4*>(stage + row * LDO + 8 * chunk);
      float4 b = *reinterpret_cast<const float4*>(stage + row * LDO + 8 * chunk + 4);
#pragma unroll
      for (int w = 1; w < P::kWarpgroups; ++w) {
        const float4 a2 = *reinterpret_cast<const float4*>(stage + (w * BQ + row) * LDO + 8 * chunk);
        const float4 b2 =
            *reinterpret_cast<const float4*>(stage + (w * BQ + row) * LDO + 8 * chunk + 4);
        a.x += a2.x; a.y += a2.y; a.z += a2.z; a.w += a2.w;
        b.x += b2.x; b.y += b2.y; b.z += b2.z; b.w += b2.w;
      }
      uint4 out;
      out.x = m::pack_bf16(a.x, a.y);
      out.y = m::pack_bf16(a.z, a.w);
      out.z = m::pack_bf16(b.x, b.y);
      out.w = m::pack_bf16(b.z, b.w);
      *reinterpret_cast<uint4*>(ob + row * kD + 8 * chunk) = out;
    }
  }
}

template <int BQ, int BK, bool TR, bool CLAMP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                       int Nq, int Nk, float scale, float clamp, cudaStream_t s) {
  using P = MmaPlan<BQ, BK, TR>;
  auto kernel = flash_variant_mma_kernel<BQ, BK, TR, CLAMP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Nq / BQ, BH), P::kThreads, P::kBytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, Nq, Nk, scale * m::kLog2e, clamp * m::kLog2e);
  return cudaGetLastError();
}

template <int BQ, int BK, bool TR, bool CLAMP>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                       int Nq, int Nk, float scale, float clamp, cudaStream_t s) {
  constexpr size_t smem = FmaPlan<BQ, BK, TR>::kBytes;
  auto kernel = flash_variant_fma_kernel<BQ, BK, TR, CLAMP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Nq / BQ, BH), kFmaThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, Nq, Nk, scale, clamp);
  return cudaGetLastError();
}

// The three variants of a tile pair: transposed with the online max (v2) or
// clamped (v4), rows clamped (v1, v3).
#define UDT_FV_PICK(LAUNCH)                                                        \
  if (transposed)                                                                  \
    return clamp > 0.f ? LAUNCH<BQ, BK, true, true>(q, k, v, o, lse, BH, Nq, Nk, scale, clamp, s) \
                       : LAUNCH<BQ, BK, true, false>(q, k, v, o, lse, BH, Nq, Nk, scale, 0.f, s); \
  if (clamp > 0.f) return LAUNCH<BQ, BK, false, true>(q, k, v, o, lse, BH, Nq, Nk, scale, clamp, s); \
  return cudaErrorInvalidValue;

template <int BQ, int BK>
cudaError_t pick_mma(int transposed, float clamp, const void* q, const void* k, const void* v,
                     void* o, float* lse, int BH, int Nq, int Nk, float scale, cudaStream_t s) {
  UDT_FV_PICK(launch_mma)
}

template <int BQ, int BK>
cudaError_t pick_fma(int transposed, float clamp, const void* q, const void* k, const void* v,
                     void* o, float* lse, int BH, int Nq, int Nk, float scale, cudaStream_t s) {
  UDT_FV_PICK(launch_fma)
}
#undef UDT_FV_PICK

template <int BQ, int BK>
int mma_bytes(int transposed) {
  return (int)(transposed ? MmaPlan<BQ, BK, true>::kBytes : MmaPlan<BQ, BK, false>::kBytes);
}

template <int BQ, int BK>
int fma_bytes(int transposed) {
  return (int)(transposed ? FmaPlan<BQ, BK, true>::kBytes : FmaPlan<BQ, BK, false>::kBytes);
}

}  // namespace

// The tile menu: bf16 (64, 64), (64, 128), (128, 64), (128, 128) on the
// wgmma kernel; fp32 (64, 64) on the FMA kernel.
#define UDT_FV_MENU(MMA, FMA)                              \
  if (dtype == udt::kBFloat16) {                           \
    if (bq == 64 && bk == 64) return MMA(64, 64);          \
    if (bq == 64 && bk == 128) return MMA(64, 128);        \
    if (bq == 128 && bk == 64) return MMA(128, 64);        \
    if (bq == 128 && bk == 128) return MMA(128, 128);      \
  }                                                        \
  if (dtype == udt::kFloat32 && bq == 64 && bk == 64) return FMA(64, 64);

// Dynamic shared memory of the instantiation for (bq, bk, transposed, dtype),
// in bytes, or -1 if the menu does not hold it.
extern "C" int udt_flash_variant_smem_bytes(int bq, int bk, int transposed, int dtype) {
#define UDT_FV_MMA_BYTES(BQ, BK) mma_bytes<BQ, BK>(transposed)
#define UDT_FV_FMA_BYTES(BQ, BK) fma_bytes<BQ, BK>(transposed)
  UDT_FV_MENU(UDT_FV_MMA_BYTES, UDT_FV_FMA_BYTES)
#undef UDT_FV_MMA_BYTES
#undef UDT_FV_FMA_BYTES
  return -1;
}

// q, o: (BH, Nq, 64); k, v: (BH, Nk, 64): contiguous, 16-byte aligned, one
// dtype. clamp: the logit clamp C > 0 of a max-free variant, or 0 for the
// online max (transposed only). lse: (BH, Nq) fp32 or null; log Σp (with the
// online max, m + log Σp), written by the rows layout and by fp32.
// Nq % bq == 0, Nk % bk == 0, (bq, bk) from the menu above. Returns
// cudaGetLastError() after the launch (or the first failing call);
// cudaErrorInvalidValue for anything the menu does not hold.
extern "C" int udt_flash_variant(const void* q, const void* k, const void* v, void* o, void* lse,
                                 int BH, int Nq, int Nk, int D, int bq, int bk, int transposed,
                                 float clamp, float scale, int dtype, void* stream) {
  if (BH <= 0 || BH > 65535 || D != kD || bq <= 0 || bk <= 0 || Nq <= 0 || Nk <= 0 ||
      Nq % bq != 0 || Nk % bk != 0 || !(scale > 0.f) || !(clamp >= 0.f))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define UDT_FV_MMA(BQ, BK) pick_mma<BQ, BK>(transposed, clamp, q, k, v, o, l, BH, Nq, Nk, scale, s)
#define UDT_FV_FMA(BQ, BK) pick_fma<BQ, BK>(transposed, clamp, q, k, v, o, l, BH, Nq, Nk, scale, s)
  UDT_FV_MENU(UDT_FV_MMA, UDT_FV_FMA)
#undef UDT_FV_MMA
#undef UDT_FV_FMA
  return cudaErrorInvalidValue;
}
