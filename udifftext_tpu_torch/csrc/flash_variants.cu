// Flash-attention forward variants for Hopper (sm_90a), for a layout probe:
// softmax(q·kᵀ·scale)·v on (B·H, N, 64) contiguous tensors, templated on
// <BQ, BK, TRANSPOSED, CLAMP>.
//
// Replaces: scripts/flash_variants.py `run_variant` → `_kernel_v2`,
// `_kernel_v3` (the Pallas TPU variants) and `v1_fn`, the shipped TPU forward
// `udifftext_tpu/ops/flash_attention.py` `_flash_kernel` at caller-chosen
// block sizes.
//
//   v1 = <.., false, false>: s = q·kᵀ (BQ × BK), online max, acc (BQ × d) +=
//        p·v; writes the output and the log-sum-exp, as csrc/flash_attention.cu.
//        It ports the function `v1_fn` computes (exact softmax, LSE), not
//        `_flash_kernel`'s schedule, which is transposed, max-free and clamped
//        at ±75: that layout is v4 here, at clamp 60.
//   v2 = <.., true,  false>: sᵀ = k·qᵀ (BK × BQ), statistics per query
//        column, accᵀ (d × BQ) += vᵀ·pᵀ, transposed once on the way out.
//   v3 = <.., false, true>, v4 = <.., true, true>: no running max:
//        p = exp(clip(s·scale, −60, 60)), out = Σp·v / Σp. That equals
//        softmax only while |logits| < 60; 60 + ln 4096 < 88, so nothing
//        overflows fp32 (or bf16's exponent) for N up to 4096 and beyond.
//
// What bounds it on the H100: operations (4·N²·64 flops a head against
// 4·N·64 elements moved). bf16 runs on the tensor cores through warp-level
// wmma tiles (16×16×16, fp32 accumulate); fp32 inputs run on FMAs and serve
// the accuracy check. wgmma, TMA and a pipelined K/V ring are later work.
//
// What the transposition decides on this card. The TPU asked which axis
// fills the matrix unit's result lanes. Here it decides which operand's rows
// fill the MMA's M dimension and where a softmax row lives: in v1/v3 a
// query's keys lie along a shared-memory row, a warp owns the row and
// reduces across its lanes with shuffles; in v2/v4 a query is a column, a
// thread walks down it and only the 2-4 threads that share a column exchange
// values. The accumulator's transpose costs nothing: wmma stores the
// (d × BQ) tiles column-major, which is (BQ × d) row-major.
//
// Design. One block of 256 threads per (BQ-row query tile, batch·head); a
// loop over BK-key tiles staged in shared memory (the next tile's global
// loads are issued into registers before the current tile is computed). Per
// tile: the eight warps split the 16×16 tiles of s (q fragments are loaded
// once, before the loop) and store them to shared memory in fp32; the softmax
// step reads them, writes p
// in the input dtype and, for the online-max variants, the rescale factor
// alpha; each warp then rescales and extends its own output tiles, which stay
// in registers for the whole loop. wmma fragments have an opaque layout, so
// alpha reaches them as a fragment too: it is written to shared memory as a
// 16-wide tile with alpha repeated along the other axis and loaded with the
// accumulator's layout, which makes the rescale an elementwise product. The
// clamped variants skip that, which is their point.

#include <math.h>
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kD = 64;  // head width
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kClamp = 60.f;

// Shared-memory plan of one instantiation; byte offsets are multiples of 128.
template <typename T, int BQ, int BK, bool TR>
struct Plan {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int kLdIn = kD + 16 / (int)sizeof(T);  // q, k, v rows: 16 bytes of padding
  static constexpr int kParts = kThreads / BQ;            // threads sharing a query (TR)
  static constexpr int kSRows = TR ? BK : BQ;
  static constexpr int kSCols = TR ? BQ : BK;
  // fp32 logits. TR: lanes read (key = i·parts + part, query) with 32/parts
  // queries a warp, so a pitch of 32/parts mod 32 spreads them over all banks.
  static constexpr int kLdS = kSCols + (TR ? 32 / kParts : 4);
  static constexpr int kLdP = kBf16 ? kSCols + 8 : kLdS;  // fp32: p overwrites s in place
  static constexpr int kLdO = kD + 4;                     // fp32 output tile, aliases s
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + sizeof(T) * BQ * kLdIn;
  static constexpr size_t kV = kK + sizeof(T) * BK * kLdIn;
  static constexpr size_t kS = kV + sizeof(T) * BK * kLdIn;
  static constexpr size_t kSBytes =
      sizeof(float) * (kSRows * kLdS > BQ * kLdO ? kSRows * kLdS : BQ * kLdO);
  static constexpr size_t kP = kS + kSBytes;
  static constexpr size_t kA = kP + (kBf16 ? sizeof(bf16) * kSRows * kLdP : 0);
  static constexpr size_t kStat = kA + sizeof(float) * BQ * 16;  // alpha tile
  static constexpr size_t kBytes = kStat + sizeof(float) * 2 * BQ;  // row max, row sum
  static constexpr int kBlocksPerSm = 3 * kBytes <= 227 * 1024 ? 3 : 2 * kBytes <= 227 * 1024 ? 2 : 1;
  static_assert(kThreads % BQ == 0 && BK % 32 == 0 && BK % kParts == 0, "tile sizes");
};

// `rows` rows of kD elements from global (row pitch kD) to shared (pitch ld), 16 bytes a copy.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* __restrict__ src, int rows) {
  constexpr int kChunks = kD * (int)sizeof(T) / 16;
  constexpr int kPer = 16 / (int)sizeof(T);
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    *reinterpret_cast<uint4*>(dst + r * ld + c * kPer) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * kD + c * kPer);
  }
}

// A BK-row tile of k or v on its way from global to shared memory through
// registers: `fetch` issues the loads, `stash` stores them. Between the two
// the block computes on the tile before, so the loads' latency is hidden.
template <typename T, int ROWS>
struct TileInFlight {
  static constexpr int kChunks = kD * (int)sizeof(T) / 16;  // 16-byte copies a row
  static constexpr int kPer = 16 / (int)sizeof(T);
  static constexpr int kMine = ROWS * kChunks / kThreads;   // copies a thread
  static_assert(ROWS * kChunks % kThreads == 0, "a tile divides evenly among the threads");
  uint4 regs[kMine];
  __device__ __forceinline__ void fetch(const T* __restrict__ src) {
#pragma unroll
    for (int j = 0; j < kMine; ++j) {
      const int i = threadIdx.x + j * kThreads, r = i / kChunks, c = i - r * kChunks;
      regs[j] = *reinterpret_cast<const uint4*>(src + (size_t)r * kD + c * kPer);
    }
  }
  __device__ __forceinline__ void stash(T* dst, int ld) const {
#pragma unroll
    for (int j = 0; j < kMine; ++j) {
      const int i = threadIdx.x + j * kThreads, r = i / kChunks, c = i - r * kChunks;
      *reinterpret_cast<uint4*>(dst + r * ld + c * kPer) = regs[j];
    }
  }
};

__device__ __forceinline__ float exp_clamped(float s) {
  return expf(fminf(fmaxf(s, -kClamp), kClamp));
}

// Hold the registers to what the blocks that fit an SM's shared memory can
// share (3 blocks of 256 threads: 85 each, 2: 128), or a few registers too
// many would leave one of them out.
template <typename T, int BQ, int BK, bool TR, bool CLAMP>
__global__ void __launch_bounds__(kThreads, Plan<T, BQ, BK, TR>::kBlocksPerSm)
flash_variant_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, int Nq, int Nk, float scale) {
  using P = Plan<T, BQ, BK, TR>;
  constexpr bool kBf16 = P::kBf16;
  constexpr int LDI = P::kLdIn, LDS = P::kLdS, LDP = P::kLdP, LDO = P::kLdO;
  extern __shared__ __align__(128) unsigned char smem_fv[];
  T* Qs = reinterpret_cast<T*>(smem_fv + P::kQ);          // [BQ][LDI]
  T* Ks = reinterpret_cast<T*>(smem_fv + P::kK);          // [BK][LDI]
  T* Vs = reinterpret_cast<T*>(smem_fv + P::kV);          // [BK][LDI]
  float* Ss = reinterpret_cast<float*>(smem_fv + P::kS);  // [BQ][LDS], TR: [BK][LDS]
  T* Ps = kBf16 ? reinterpret_cast<T*>(smem_fv + P::kP) : reinterpret_cast<T*>(Ss);
  float* At = reinterpret_cast<float*>(smem_fv + P::kA);  // [BQ][16], TR: [16][BQ]
  float* row_m = reinterpret_cast<float*>(smem_fv + P::kStat);
  float* row_l = row_m + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const T* kb = k + (size_t)bh * Nk * kD;
  const T* vb = v + (size_t)bh * Nk * kD;

  load_tile(Qs, LDI, q + ((size_t)bh * Nq + q0) * kD, BQ);
  if (tid < BQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }
  __syncthreads();

  // --- who owns what -------------------------------------------------------
  // s tiles: QT × KT of 16×16; a warp's SPW tiles share one query tile.
  constexpr int QT = BQ / 16, KT = BK / 16, DT = kD / 16;
  constexpr int SPW = QT * KT / kWarps;
  static_assert(SPW >= 1 && KT % SPW == 0, "a warp's s tiles must share a query tile");
  const int s_qt = (warp * SPW) / KT, s_kt0 = (warp * SPW) % KT;
  // output tiles: QT × DT; a warp's OPW tiles share one query tile.
  constexpr int OPW = QT * DT / kWarps;
  static_assert(OPW >= 1 && DT % OPW == 0, "a warp's output tiles must share a query tile");
  const int o_qt = (warp * OPW) / DT, o_dt0 = (warp * OPW) % DT;
  // fp32: a thread owns output (row tid/64 + 4j, column tid%64), j < BQ/4.
  constexpr int FJ = BQ / 4;
  const int f_r0 = tid / kD, f_d = tid % kD;
  // TR softmax: a thread owns query column tid/parts and keys i·parts + part.
  constexpr int PARTS = P::kParts;
  const int t_q = tid / PARTS, t_part = tid % PARTS;
  float col_m = -INFINITY, col_l = 0.f;  // TR: the column's running max and sum

  using AFrag = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
  using AFragT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
  using BFrag = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
  using BFragT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
  using CFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

  // q fragments of this warp's query tile, loaded once: the A operand of
  // q·kᵀ, or (TR) the B operand of k·qᵀ. Both read Qs[query][d].
  AFrag qa[kBf16 && !TR ? DT : 1];
  BFragT qb[kBf16 && TR ? DT : 1];
  CFrag acc[kBf16 ? OPW : 1];
  float accf[kBf16 ? 1 : FJ];
  if constexpr (kBf16) {
    const bf16* qt = reinterpret_cast<const bf16*>(Qs) + s_qt * 16 * LDI;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      if constexpr (TR) wmma::load_matrix_sync(qb[kk], qt + kk * 16, LDI);
      else wmma::load_matrix_sync(qa[kk], qt + kk * 16, LDI);
    }
#pragma unroll
    for (int f = 0; f < OPW; ++f) wmma::fill_fragment(acc[f], 0.f);
  } else {
#pragma unroll
    for (int j = 0; j < FJ; ++j) accf[j] = 0.f;
  }

  TileInFlight<T, BK> k_next, v_next;
  k_next.fetch(kb);
  v_next.fetch(vb);
  for (int k0 = 0; k0 < Nk; k0 += BK) {
    __syncthreads();  // the previous tile's k, v, p and alpha are no longer read
    k_next.stash(Ks, LDI);
    v_next.stash(Vs, LDI);
    if (k0 + BK < Nk) {  // the next tile's loads fly while this one is computed
      k_next.fetch(kb + (size_t)(k0 + BK) * kD);
      v_next.fetch(vb + (size_t)(k0 + BK) * kD);
    }
    __syncthreads();

    // --- logits: s (BQ × BK), or sᵀ (BK × BQ) -------------------------------
    if constexpr (kBf16) {
      const bf16* ks = reinterpret_cast<const bf16*>(Ks);
#pragma unroll
      for (int j = 0; j < SPW; ++j) {
        const int kt = s_kt0 + j;
        CFrag c;
        wmma::fill_fragment(c, 0.f);
#pragma unroll
        for (int kk = 0; kk < DT; ++kk) {
          if constexpr (TR) {  // (keys × d)·(d × queries)
            AFrag a;
            wmma::load_matrix_sync(a, ks + kt * 16 * LDI + kk * 16, LDI);
            wmma::mma_sync(c, a, qb[kk], c);
          } else {  // (queries × d)·(d × keys)
            BFragT b;
            wmma::load_matrix_sync(b, ks + kt * 16 * LDI + kk * 16, LDI);
            wmma::mma_sync(c, qa[kk], b, c);
          }
        }
        float* dst = TR ? Ss + kt * 16 * LDS + s_qt * 16 : Ss + s_qt * 16 * LDS + kt * 16;
        wmma::store_matrix_sync(dst, c, LDS, wmma::mem_row_major);
      }
    } else {
      for (int i = tid; i < BQ * BK; i += kThreads) {
        // consecutive threads take consecutive elements of a row of s (or sᵀ)
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
        Ss[TR ? c * LDS + r : r * LDS + c] = s;
      }
    }
    __syncthreads();

    // --- softmax step: p in the input dtype, alpha, running statistics ------
    if constexpr (!TR) {
      // a warp owns BQ/8 rows; a lane BK/32 keys of a row
      constexpr int RPW = BQ / kWarps, KPL = BK / 32;
      for (int rr = 0; rr < RPW; ++rr) {
        const int r = warp * RPW + rr;
        const float* sr = Ss + r * LDS;
        float sv[KPL];
#pragma unroll
        for (int j = 0; j < KPL; ++j) sv[j] = sr[lane + 32 * j] * scale;
        float sum = 0.f;
        if constexpr (CLAMP) {
#pragma unroll
          for (int j = 0; j < KPL; ++j) {
            sv[j] = exp_clamped(sv[j]);
            sum += sv[j];
          }
          sum = udt::warp_sum(sum);
          if (lane == 0) row_l[r] += sum;
        } else {
          const float m_old = row_m[r];
          float mx = sv[0];
#pragma unroll
          for (int j = 1; j < KPL; ++j) mx = fmaxf(mx, sv[j]);
          const float m_new = fmaxf(m_old, udt::warp_max(mx));
#pragma unroll
          for (int j = 0; j < KPL; ++j) {
            sv[j] = expf(sv[j] - m_new);
            sum += sv[j];
          }
          sum = udt::warp_sum(sum);
          const float alpha = expf(m_old - m_new);  // 0 on the first tile
          if (lane < 16) At[r * 16 + lane] = alpha;
          if (lane == 0) {
            row_l[r] = row_l[r] * alpha + sum;
            row_m[r] = m_new;
          }
        }
        T* prow = Ps + r * LDP;
#pragma unroll
        for (int j = 0; j < KPL; ++j) udt::store_from_f32(prow + lane + 32 * j, sv[j]);
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
        m_new = fmaxf(col_m, mx * scale);  // scale > 0: the max of s·scale
      }
      float sum = 0.f;
#pragma unroll 8
      for (int i = 0; i < KPT; ++i) {
        const int key = i * PARTS + t_part;
        const float s = Ss[key * LDS + t_q] * scale;
        const float p = CLAMP ? exp_clamped(s) : expf(s - m_new);
        sum += p;
        udt::store_from_f32(Ps + key * LDP + t_q, p);
      }
#pragma unroll
      for (int off = PARTS / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if constexpr (CLAMP) {
        col_l += sum;
      } else {
        const float alpha = expf(col_m - m_new);  // 0 on the first tile
        for (int i = t_part; i < 16; i += PARTS) At[i * BQ + t_q] = alpha;
        col_l = col_l * alpha + sum;
        col_m = m_new;
      }
    }
    __syncthreads();

    // --- acc = acc·alpha + p·v, or accᵀ = accᵀ·alpha + vᵀ·pᵀ -----------------
    if constexpr (kBf16) {
      if constexpr (!CLAMP) {
        CFrag af;  // alpha in the accumulator's own layout
        if constexpr (TR) wmma::load_matrix_sync(af, At + o_qt * 16, BQ, wmma::mem_row_major);
        else wmma::load_matrix_sync(af, At + o_qt * 256, 16, wmma::mem_row_major);
#pragma unroll
        for (int f = 0; f < OPW; ++f)
#pragma unroll
          for (int e = 0; e < af.num_elements; ++e) acc[f].x[e] *= af.x[e];
      }
      const bf16* ps = reinterpret_cast<const bf16*>(Ps);
      const bf16* vs = reinterpret_cast<const bf16*>(Vs);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        if constexpr (TR) {  // (d × keys)·(keys × queries): vᵀ read column-major from Vs
          BFrag pb;
          wmma::load_matrix_sync(pb, ps + kk * 16 * LDP + o_qt * 16, LDP);
#pragma unroll
          for (int f = 0; f < OPW; ++f) {
            AFragT va;
            wmma::load_matrix_sync(va, vs + kk * 16 * LDI + (o_dt0 + f) * 16, LDI);
            wmma::mma_sync(acc[f], va, pb, acc[f]);
          }
        } else {  // (queries × keys)·(keys × d)
          AFrag pa;
          wmma::load_matrix_sync(pa, ps + o_qt * 16 * LDP + kk * 16, LDP);
#pragma unroll
          for (int f = 0; f < OPW; ++f) {
            BFrag vf;
            wmma::load_matrix_sync(vf, vs + kk * 16 * LDI + (o_dt0 + f) * 16, LDI);
            wmma::mma_sync(acc[f], pa, vf, acc[f]);
          }
        }
      }
    } else {
      if constexpr (!CLAMP) {
#pragma unroll
        for (int j = 0; j < FJ; ++j) {
          const int r = f_r0 + 4 * j;
          accf[j] *= TR ? At[r] : At[r * 16];
        }
      }
      for (int kk = 0; kk < BK; ++kk) {
        const float vv = Vs[kk * LDI + f_d];
#pragma unroll
        for (int j = 0; j < FJ; ++j) {
          const int r = f_r0 + 4 * j;
          accf[j] = fmaf(TR ? Ps[kk * LDP + r] : Ps[r * LDP + kk], vv, accf[j]);
        }
      }
    }
  }

  // --- out = acc / l through an fp32 (BQ × d) tile that aliases s ------------
  __syncthreads();  // s (and, in fp32, p) are no longer read
  float* Os = Ss;
  if constexpr (kBf16) {
#pragma unroll
    for (int f = 0; f < OPW; ++f) {
      float* dst = Os + o_qt * 16 * LDO + (o_dt0 + f) * 16;
      // TR: tile element (d, query) lands at [query][d]: the transpose
      wmma::store_matrix_sync(dst, acc[f], LDO, TR ? wmma::mem_col_major : wmma::mem_row_major);
    }
  } else {
#pragma unroll
    for (int j = 0; j < FJ; ++j) Os[(f_r0 + 4 * j) * LDO + f_d] = accf[j];
  }
  if constexpr (TR) {
    if (t_part == 0) {
      row_l[t_q] = col_l;
      row_m[t_q] = col_m;
    }
  }
  __syncthreads();
  T* ob = o + ((size_t)bh * Nq + q0) * kD;
  for (int i = tid; i < BQ * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    udt::store_from_f32(ob + i, Os[r * LDO + c] / row_l[r]);
  }
  if constexpr (!CLAMP) {
    if (lse != nullptr && tid < BQ) lse[(size_t)bh * Nq + q0 + tid] = row_m[tid] + logf(row_l[tid]);
  }
}

template <typename T, int BQ, int BK, bool TR, bool CLAMP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                   int Nq, int Nk, float scale, cudaStream_t s) {
  constexpr size_t smem = Plan<T, BQ, BK, TR>::kBytes;
  auto kernel = flash_variant_kernel<T, BQ, BK, TR, CLAMP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Nq / BQ, BH), kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Nq, Nk, scale);
  return cudaGetLastError();
}

template <typename T, int BQ, int BK>
cudaError_t pick_variant(int transposed, int clamp, const void* q, const void* k, const void* v,
                         void* o, float* lse, int BH, int Nq, int Nk, float scale,
                         cudaStream_t s) {
  if (transposed)
    return clamp ? launch<T, BQ, BK, true, true>(q, k, v, o, lse, BH, Nq, Nk, scale, s)
                 : launch<T, BQ, BK, true, false>(q, k, v, o, lse, BH, Nq, Nk, scale, s);
  return clamp ? launch<T, BQ, BK, false, true>(q, k, v, o, lse, BH, Nq, Nk, scale, s)
               : launch<T, BQ, BK, false, false>(q, k, v, o, lse, BH, Nq, Nk, scale, s);
}

template <typename T, int BQ, int BK>
int plan_bytes(int transposed) {
  return (int)(transposed ? Plan<T, BQ, BK, true>::kBytes : Plan<T, BQ, BK, false>::kBytes);
}

}  // namespace

// The tile menu: bf16 (64, 64), (64, 128), (128, 64), (128, 128); fp32 (64, 64).
#define UDT_FV_MENU(CALL)                                    \
  if (dtype == udt::kBFloat16) {                             \
    if (bq == 64 && bk == 64) return CALL(bf16, 64, 64);     \
    if (bq == 64 && bk == 128) return CALL(bf16, 64, 128);   \
    if (bq == 128 && bk == 64) return CALL(bf16, 128, 64);   \
    if (bq == 128 && bk == 128) return CALL(bf16, 128, 128); \
  }                                                          \
  if (dtype == udt::kFloat32 && bq == 64 && bk == 64) return CALL(float, 64, 64);

// Dynamic shared memory of the instantiation for (bq, bk, transposed, dtype),
// in bytes, or -1 if the menu does not hold it.
extern "C" int udt_flash_variant_smem_bytes(int bq, int bk, int transposed, int dtype) {
#define UDT_FV_BYTES(T, BQ, BK) plan_bytes<T, BQ, BK>(transposed)
  UDT_FV_MENU(UDT_FV_BYTES)
#undef UDT_FV_BYTES
  return -1;
}

// q, o: (BH, Nq, 64); k, v: (BH, Nk, 64): contiguous, 16-byte aligned, one
// dtype. lse: (BH, Nq) fp32 or null; written only by the variants without the
// clamp. Nq % bq == 0, Nk % bk == 0, (bq, bk) from the menu above.
// Returns cudaGetLastError() after the launch (or the first failing call);
// cudaErrorInvalidValue for anything the menu does not hold.
extern "C" int udt_flash_variant(const void* q, const void* k, const void* v, void* o, void* lse,
                                 int BH, int Nq, int Nk, int D, int bq, int bk, int transposed,
                                 int clamp, float scale, int dtype, void* stream) {
  if (BH <= 0 || BH > 65535 || D != kD || bq <= 0 || bk <= 0 || Nq <= 0 || Nk <= 0 ||
      Nq % bq != 0 || Nk % bk != 0 || !(scale > 0.f))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define UDT_FV_LAUNCH(T, BQ, BK) \
  pick_variant<T, BQ, BK>(transposed, clamp, q, k, v, o, l, BH, Nq, Nk, scale, s)
  UDT_FV_MENU(UDT_FV_LAUNCH)
#undef UDT_FV_LAUNCH
  return cudaErrorInvalidValue;
}
