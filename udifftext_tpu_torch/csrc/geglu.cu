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
// What bounds it on the H100: 6·M·C·I flops against M·C·2 bytes of x and
// out plus 3·C·I·2 bytes of weights, so at the UNet's shapes it is bound by
// the tensor cores for bf16 (2.01e10 flops at every B=2 shape: 0.0204 ms at
// 989 TFLOP/s; ds4 at B=2 with its 39 MB of weights, 0.0117 ms at 3.35 TB/s,
// is close to the memory line too).
//
// Three kernels, chosen by the wrapper (ops/geglu.py `geglu_kernel_route`):
//
// "mma" (geglu_mma_kernel<NT, G, RG>): bf16 with C / 64 = NT·G, NT <= 5 and
// G in {1, 2, 4}: every width of the UNet. Both products run on `wgmma`
// m64n64k16 with fp32 accumulators in registers, on the 128-byte-swizzled
// 64×64 tiles of flash_mma.cuh.
//   - Rows and columns. A warpgroup owns 64 rows and NT 64-column tiles of
//     the output: 32·NT accumulator registers a thread for the whole hidden
//     loop, which is what caps NT at 5 (C = 320). G warpgroups share the
//     same 64 rows and split the columns: G = 1 up to C = 320 (a block is RG
//     = 1 or 2 row groups: 64 or 128 rows, so a staged weight byte serves up
//     to 128 rows), G = 2 up to C = 640 (one block of two warpgroups), G = 4
//     up to C = 1280, where 64 rows of fp32 output (320 KB) exceed one
//     multiprocessor's registers: a cluster of two CTAs, two warpgroups
//     each. Nothing is recomputed: every h and g is formed once.
//   - The x rows of the block (LayerNorm applied in place first when there
//     is a prologue: fp32 centered statistics on the swizzled layout, the
//     arithmetic and summation order of `udt::layer_norm_rows`; rows beyond
//     M are zero) stay in shared memory for the whole loop: 64 rows × 1280
//     bf16 = 160 KB at most. With G = 4 both CTAs hold them.
//   - The hidden dimension is walked in chunks of 64 units (128 for G = 4).
//     A chunk is cut into 32-unit slices: a warpgroup forms [h, g] of one
//     slice (G = 1: of both, one after the other) as ONE 64×64 accumulator,
//     the B tile being the slice's 32 h rows and 32 g rows of W1 side by
//     side (two row ranges of W1, one tile), so that a thread holds h and g
//     of the same unit: b1 is added and erf evaluated on the accumulator's
//     own registers, and act is rounded to bf16 there. act then makes its
//     one trip through shared memory: 64 rows × the chunk's units as
//     swizzled tile(s), written by the warpgroups that gated the slices (for
//     G = 4 into both CTAs through distributed shared memory, one cluster
//     barrier to publish and one to release a chunk) and read by every
//     warpgroup as the A operand of out += act·W2ᵀ. (Feeding that product
//     from registers where one warpgroup owns all columns, G = 1, was built
//     and measured: ptxas serialized its pipeline, C7511, and it was slower.)
//   - Weights arrive through a ring of 3-4 stages in shared memory filled by
//     16-byte `cp.async`: a stage holds the tiles of one step (G = 1: one
//     whole product of a slice, NT tiles; G = 2: two 64-column slices for
//     each warpgroup; G = 4: one), the copies run kStages − 1 steps ahead,
//     and one `__syncthreads()` a step publishes what landed and frees the
//     stage the next copy overwrites. A step's products are issued, the
//     refill is issued behind them, then the products are waited for.
//   - Filling the card. Where the row blocks alone leave multiprocessors
//     idle, the hidden dimension is split. Up to C = 640 the splits of a row
//     block are the 2 or 4 CTAs of ONE cluster: each leaves its fp32 sums in
//     its own shared memory, and CTA k adds rows k·kBM/splits.. of all of
//     them up in split order through distributed shared memory, adds b2 and
//     writes bf16: one launch, no partial sum in device memory,
//     deterministic. For C = 1280 the cluster is taken by the column split,
//     so each split writes an fp32 partial (splits, M, C) and
//     geglu_reduce_kernel adds them in split order: the wrapper keeps
//     splits·M·C·4 bytes under the weights' 3·C·I·2 (ds4 at B=2: 8 splits,
//     21.0 MB against 39.3 MB; written once, read once). With one split
//     every kernel writes bf16 `out` itself, b2 added in fp32: one launch.
//   Registers a thread / dynamic shared memory a block (nvcc 12.8, no spill
//   in any instantiation; the build log has the numbers): <5,1,1> C=320, 64
//   rows: 248 / 209 KB; <5,1,2> C=320, 128 rows: 254 / 217 KB; <5,2,1>
//   C=640: 255 / 217 KB; <5,4,1> C=1280: 255 / 225 KB a CTA. One block a
//   multiprocessor in every case.
//   What holds it back (NVIDIA H100 80GB HBM3, 700 W): a block takes about
//   6 µs for a chunk at C = 320 and 8.5 µs at C = 640 whether one or two of
//   its warpgroups work, 3-4 times the chunk's tensor-core time. Each of
//   these was built, timed in the same call as the kernel above and moved
//   that by less than 5 %, so none was kept: fewer and larger steps (1 to 5
//   tiles), a ring and barrier of its own for each warpgroup, the second
//   product interleaved across its output tiles, erf left out, the chunk
//   order staggered across blocks (no hot spot in L2). Waiting for a step's
//   products one step later, and unrolling the two slices of G = 1, made
//   ptxas serialize the pipeline (C7515, C7511). What is left, and not
//   measured directly: an m64n64k16 product whose two operands both come
//   from shared memory reads 4 KB for 32 cycles of tensor-core work, the
//   whole of a multiprocessor's shared-memory rate; wider products (n = 128
//   and up) read less per flop but need accumulator registers this layout
//   does not have. From C = 640 on a staged byte serves 64 rows only, and at
//   large M the copies from L2 then run at 3.3-3.8 TB/s.
//
// "wmma" (geglu_wmma_kernel): bf16 with any other C % 16 == 0. A block owns
// 16·MT rows and ALL C output columns, with MT chosen by the wrapper so that
// MT·C ≈ 1280: warp-level wmma tiles (16×16×16, fp32 accumulate), x rows in
// shared memory, the hidden dimension in chunks of 64 units whose [h, g]
// crosses shared memory in fp32 and act in bf16, weight tiles read from
// global memory (L2) directly. The hidden dimension may be split over
// `splits` blocks; each writes an fp32 partial and geglu_reduce_kernel sums
// them in a fixed order: deterministic, no atomics. Two launches a call.
//
// "fma" (geglu_simt_kernel): fp32, the same structure with fp32 FMAs, 16 rows
// per block, no split, one launch.
//
// LayerNorm prologue (ln_scale != nullptr), every route: each block
// normalizes its own rows in shared memory before the hidden loop, so the
// normalized activation never reaches device memory. With the hidden
// dimension split across blocks every split normalizes its rows again; the
// TPU kernel did it once per x block only because its grid runs in order.

#include <math.h>
#include <mma.h>

#include "flash_mma.cuh"
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

// Sums the splits' fp32 partials in split order, adds b2, rounds once.
void launch_reduce(const float* partial, const void* b2, void* out, int M, int C, int splits,
                   cudaStream_t s) {
  const long long n = (long long)M * C;
  const long long want = (n + kThreads - 1) / kThreads;
  geglu_reduce_kernel<<<(int)(want < 4096 ? want : 4096), kThreads, 0, s>>>(
      partial, static_cast<const bf16*>(b2), static_cast<bf16*>(out), M, C, splits);
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
  launch_reduce(partial, b2, out, M, C, splits, s);
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
// bf16, C % 64 == 0: `wgmma` ("mma")
// ---------------------------------------------------------------------------

namespace mm = udt::mma;

// The shape of one instantiation: NT 64-column output tiles a warpgroup
// (its 32·NT accumulator registers a thread), G warpgroups over the same 64
// rows (1, 2, or 4 = two CTAs of a cluster), and for G = 1 the RG row groups
// of a block.
template <int NT, int G, int RG>
struct MmaShape {
  static_assert(NT >= 1 && NT <= 5 && (G == 1 || G == 2 || G == 4) && (RG == 1 || RG == 2) &&
                (G == 1 || RG == 1), "geglu_mma: shape");
  static constexpr int kT = NT * G;                       // 64-column slices of C
  static constexpr int kC = 64 * kT;
  static constexpr int kWarpgroups = G == 1 ? RG : 2;
  static constexpr int kThreads = mm::kWarpgroup * kWarpgroups;
  static constexpr int kBM = G == 1 ? 64 * RG : 64;       // rows a block (a cluster)
  static constexpr int kSub = G == 4 ? 4 : 2;             // 32-unit slices a chunk
  static constexpr int kChunk = 32 * kSub;                // hidden units a chunk
  static constexpr int kN2 = NT * (kSub / 2);             // weight tiles a warpgroup of the second product
  static constexpr int kUnitTiles = G == 1 ? 1 : 2;       // a unit: one tile (G = 1), or one a warpgroup
  static constexpr int kUnitBytes = kUnitTiles * mm::kTileBytes;
  static constexpr int kP = G == 1 ? kT : (G == 2 ? 2 : 1);   // units a step (a stage of the ring)
  static constexpr int kStageBytes = kP * kUnitBytes;
  static constexpr int kLoads = kUnitTiles * 512 / kThreads;  // 16-byte copies a thread a unit
  static constexpr int kSteps1 = (kT + kP - 1) / kP;      // steps of one slice's first product
  static constexpr int kSteps2 = (kN2 + kP - 1) / kP;     // steps of the second product
  static constexpr int kChunkSteps = (G == 1 ? 2 : 1) * kSteps1 + kSteps2;
  static constexpr int kXBytes = kBM * kC * 2;
  static constexpr int kActBytes = (G == 1 ? RG : kSub / 2) * mm::kTileBytes;
  static constexpr int kRoom = (232448 - 1024 - kXBytes - kActBytes) / kStageBytes;
  static constexpr int kStages = kRoom < 4 ? kRoom : 4;
  static_assert(kStages >= 3, "geglu_mma: the ring needs three stages");
  static_assert(kT % kP == 0, "geglu_mma: the first product's steps are whole");
  static constexpr int kSmemBytes = 1024 + kXBytes + kActBytes + kStages * kStageBytes;
  static constexpr int kRedPitch = kC + 8;                // fp32 row pitch of the cluster's sum
  static_assert(G == 4 || kBM * kRedPitch * 4 + 1024 <= kSmemBytes, "geglu_mma: the sum needs its room");
};

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The address of this CTA's shared-memory location `addr` in CTA `rank` of
// the cluster, and a 32-bit store to such an address.
__device__ __forceinline__ uint32_t map_to_cta(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ float4 ld_cluster_f32x4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// A warpgroup's 64×64 accumulator of one 32-unit slice, columns 0-31 h and
// 32-63 g of the hidden units u0 .. u0+31: act = (h + b1)·gelu(g + b1) in
// fp32, left in hg[0..15] (the accumulator's layout of a 64×32 tile). A
// thread holds h and g of the same unit, so nothing is exchanged.
__device__ __forceinline__ void gate_slice(float (&hg)[32], const bf16* __restrict__ b1, int u0,
                                           int I, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int u = u0 + 8 * j + 2 * (lane & 3);
    const float2 bh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + u));
    const float2 bg = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + I + u));
    hg[4 * j + 0] = (hg[4 * j + 0] + bh.x) * gelu_erf(hg[16 + 4 * j + 0] + bg.x);
    hg[4 * j + 1] = (hg[4 * j + 1] + bh.y) * gelu_erf(hg[16 + 4 * j + 1] + bg.y);
    hg[4 * j + 2] = (hg[4 * j + 2] + bh.x) * gelu_erf(hg[16 + 4 * j + 2] + bg.x);
    hg[4 * j + 3] = (hg[4 * j + 3] + bh.y) * gelu_erf(hg[16 + 4 * j + 3] + bg.y);
  }
}

template <int NT, int G, int RG>
__global__ void __launch_bounds__(MmaShape<NT, G, RG>::kThreads, 1)
geglu_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                 const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                 const bf16* __restrict__ b2, bf16* __restrict__ out,
                 float* __restrict__ partial, int M, int I, int chunks_per_split, int splits,
                 const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                 float eps) {
  using S = MmaShape<NT, G, RG>;
  constexpr int C = S::kC, T = S::kT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = mm::align_smem(smem_raw);
  const uint32_t x_tiles = mm::smem_u32(smem);        // [kBM / 64][T] tiles: rows × 64 columns of x
  const uint32_t act_tiles = x_tiles + S::kXBytes;    // [kSub / 2] tiles: 64 rows × 64 units of act
  const uint32_t ring = act_tiles + S::kActBytes;     // kStages stages of kP units of weight tiles

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid / mm::kWarpgroup, wg_thread = tid % mm::kWarpgroup;
  const int rank = G == 4 ? (int)cluster_ctarank() : 0;
  const int m0 = (G == 4 ? blockIdx.x >> 1 : blockIdx.x) * S::kBM;
  const int split = blockIdx.y;
  const int rows_valid = min(S::kBM, M - m0);
  const int rg = G == 1 ? wg : 0;                              // this warpgroup's row group
  const int cg = G == 1 ? 0 : (G == 2 ? wg : 2 * rank + wg);   // its column group and slice
  const int j_begin = split * chunks_per_split * S::kChunk;
  const int total_steps = chunks_per_split * S::kChunkSteps;

  // the block's x rows, resident for the whole hidden loop; rows beyond M are zero
  for (int idx = tid; idx < S::kBM * T * 8; idx += S::kThreads) {
    const int row = idx / (T * 8), rem = idx - row * (T * 8);
    const int s = rem >> 3, chunk = rem & 7;
    const uint32_t off = ((row >> 6) * T + s) * mm::kTileBytes + mm::swizzled(row & 63, chunk);
    if (row < rows_valid)
      mm::cp_async16(x_tiles + off, x + (long long)(m0 + row) * C + s * 64 + chunk * 8);
    else
      *reinterpret_cast<uint4*>(smem + off) = make_uint4(0u, 0u, 0u, 0u);
  }
  mm::cp_async_commit();
  if (ln_scale != nullptr) {
    // the LayerNorm prologue on the swizzled rows: `udt::layer_norm_rows`'s
    // arithmetic and order of summation, a warp a row
    mm::cp_async_wait<0>();
    __syncthreads();
    auto at = [&](int row, int c) {
      return reinterpret_cast<bf16*>(smem + ((row >> 6) * T + (c >> 6)) * mm::kTileBytes +
                                     mm::swizzled(row & 63, (c & 63) >> 3) + (c & 7) * 2);
    };
    for (int r = tid / 32; r < S::kBM; r += S::kThreads / 32) {
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += __bfloat162float(*at(r, c));
      const float mean = udt::warp_sum(s) / (float)C;
      float ss = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = __bfloat162float(*at(r, c)) - mean;
        ss = fmaf(d, d, ss);
      }
      const float inv = rsqrtf(udt::warp_sum(ss) / (float)C + eps);
      for (int c = lane; c < C; c += 32)
        *at(r, c) = __float2bfloat16_rn((__bfloat162float(*at(r, c)) - mean) * inv * ln_scale[c] +
                                        ln_bias[c]);
    }
  }

  // The weight tiles in the order they are used. A unit is one tile (G = 1)
  // or one tile for each warpgroup; a step takes up to kP units of one phase
  // into one stage of the ring. Phases of a chunk: the first product of each
  // 32-unit slice this block forms (G = 1: two, one after the other), whose
  // unit s is the 32 h rows and the 32 g rows of W1 (two row ranges, one
  // tile) against the columns 64s .. 64s+63; then the second product, whose
  // unit q is 64 rows of W2 (output columns) against 64 hidden units.
  constexpr int kPhases = G == 1 ? 3 : 2;
  int ld_step = 0, ld_phase = 0, ld_unit = 0, ld_j0 = j_begin;
  auto issue_load = [&]() {
    if (ld_step < total_steps) {
      const uint32_t stage = ring + (ld_step % S::kStages) * S::kStageBytes;
      const bool first = ld_phase < kPhases - 1;
      const int phase_units = first ? T : S::kN2;
      const int n = min(S::kP, phase_units - ld_unit);
      for (int u = 0; u < n; ++u) {
        const int pos = ld_unit + u;
#pragma unroll
        for (int i = 0; i < S::kLoads; ++i) {
          const int idx = tid + i * S::kThreads;
          const int tile = idx >> 9, row = (idx >> 3) & 63, chunk = idx & 7;
          const bf16* src;
          if (first) {
            const int slice = G == 1 ? ld_phase : (G == 2 ? tile : 2 * rank + tile);
            const long long w_row = (row < 32 ? 0 : I - 32) + ld_j0 + 32 * slice + row;
            src = w1 + w_row * C + pos * 64 + chunk * 8;
          } else {
            const int cb =
                G == 1 ? pos : (G == 2 ? tile * NT + pos : (2 * rank + tile) * NT + (pos >> 1));
            const int jt = G == 4 ? (pos & 1) : 0;
            src = w2 + (long long)(cb * 64 + row) * I + ld_j0 + jt * 64 + chunk * 8;
          }
          mm::cp_async16(stage + u * S::kUnitBytes + tile * mm::kTileBytes + mm::swizzled(row, chunk),
                         src);
        }
      }
      ++ld_step;
      ld_unit += n;
      if (ld_unit == phase_units) {
        ld_unit = 0;
        if (++ld_phase == kPhases) {
          ld_phase = 0;
          ld_j0 += S::kChunk;
        }
      }
    }
  };
#pragma unroll 1
  for (int t = 0; t < S::kStages - 1; ++t) {
    issue_load();
    mm::cp_async_commit();
  }

  // One step: its tiles have landed for everyone, and everyone's products of
  // the previous step are complete ...
  int step = 0;
  auto next_stage = [&]() -> uint32_t {
    mm::cp_async_wait<S::kStages - 2>();
    mm::fence_proxy_async();
    __syncthreads();
    const uint32_t stage = ring + (step % S::kStages) * S::kStageBytes + (G == 1 ? 0 : wg) * mm::kTileBytes;
    ++step;
    return stage;
  };
  // ... so, once this step's products are issued, that step's stage takes the
  // copy kStages − 1 steps ahead.
  auto refill = [&]() {
    issue_load();
    mm::cp_async_commit();
  };

  float acc[NT][32], hg[32];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[t][i] = 0.f;
  const uint32_t x_wg = x_tiles + rg * T * mm::kTileBytes;
  const uint32_t act_wg = act_tiles + rg * mm::kTileBytes;
  const int r0 = (wg_thread >> 5) * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8 of the 64
  if (G == 4) cluster_arrive();                         // the act tiles are free

  for (int ch = 0; ch < chunks_per_split; ++ch) {
    const int j0 = j_begin + ch * S::kChunk;
    // [h, g] of this warpgroup's slice(s), gated in registers
#pragma unroll 1
    for (int half = 0; half < (G == 1 ? 2 : 1); ++half) {
#pragma unroll 1
      for (int s0 = 0; s0 < T; s0 += S::kP) {
        const uint32_t stage = next_stage();
        mm::wgmma_fence();
#pragma unroll
        for (int u = 0; u < S::kP; ++u)
          mm::tile_product_ss(hg, x_wg + (s0 + u) * mm::kTileBytes, stage + u * S::kUnitBytes,
                              s0 + u > 0);
        mm::wgmma_commit();
        refill();
        mm::wgmma_wait<0>();
      }
      mm::fence_accumulator(hg);
      const int slice = G == 1 ? half : cg;
      gate_slice(hg, b1, j0 + 32 * slice, I, lane);
      // act crosses shared memory once: columns 32·slice .. +31 of the act
      // tile(s) of these 64 rows, in this CTA and (G = 4) in the other one
      if (G == 4) cluster_wait();  // both CTAs are past the last chunk's second product
      const uint32_t tile = act_wg + (slice >> 1) * mm::kTileBytes;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int chunk = (slice & 1) * 4 + j;
        const uint32_t lo = tile + mm::swizzled(r0, chunk) + (lane & 3) * 4;
        const uint32_t hi = tile + mm::swizzled(r0 + 8, chunk) + (lane & 3) * 4;
        const uint32_t v_lo = mm::pack_bf16(hg[4 * j + 0], hg[4 * j + 1]);
        const uint32_t v_hi = mm::pack_bf16(hg[4 * j + 2], hg[4 * j + 3]);
        st_shared_u32(lo, v_lo);
        st_shared_u32(hi, v_hi);
        if (G == 4) {
          st_cluster_u32(map_to_cta(lo, rank ^ 1), v_lo);
          st_cluster_u32(map_to_cta(hi, rank ^ 1), v_hi);
        }
      }
    }
    // the writes before the tensor cores' reads, across everyone who shares the rows
    mm::fence_proxy_async();
    if (G == 1) {
      mm::named_barrier(1 + wg, mm::kWarpgroup);
    } else if (G == 2) {
      __syncthreads();
    } else {
      cluster_arrive();
      cluster_wait();
      mm::fence_proxy_async();
    }
    // out += act·W2ᵀ over the chunk, a 64-column output tile at a time
#pragma unroll
    for (int q0 = 0; q0 < S::kN2; q0 += S::kP) {
      const uint32_t stage = next_stage();
      mm::wgmma_fence();
#pragma unroll
      for (int q = q0; q < (q0 + S::kP < S::kN2 ? q0 + S::kP : S::kN2); ++q) {
        const uint32_t w_tile = stage + (q - q0) * S::kUnitBytes;
        if constexpr (G == 4)
          mm::tile_product_ss(acc[q >> 1], act_wg + (q & 1) * mm::kTileBytes, w_tile, true);
        else
          mm::tile_product_ss(acc[q], act_wg, w_tile, true);
      }
      mm::wgmma_commit();
      refill();
      mm::wgmma_wait<0>();
    }
    if (G == 4) cluster_arrive();  // this CTA no longer reads the act tiles
  }
  if (G == 4) cluster_wait();

  mm::cp_async_wait<0>();
  __syncthreads();  // the ring is free: its first tiles stage the stores
#pragma unroll
  for (int t = 0; t < NT; ++t) mm::fence_accumulator(acc[t]);
  const int rows_wg = rows_valid - rg * 64;
  const long long row0 = m0 + rg * 64;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int col0 = (cg * NT + t) * 64;
    if (splits == 1) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(b2 + col0 + 8 * j + 2 * (lane & 3)));
        acc[t][4 * j + 0] += b.x;
        acc[t][4 * j + 1] += b.y;
        acc[t][4 * j + 2] += b.x;
        acc[t][4 * j + 3] += b.y;
      }
      mm::store_accumulator(acc[t], 1.f, 1.f, smem + S::kXBytes + S::kActBytes + wg * mm::kTileBytes,
                            out + row0 * C + col0, C, rows_wg, wg_thread, 1 + wg);
    } else if (G == 4) {
      // this split's fp32 partial sums; geglu_reduce_kernel adds them up
      float* dst = partial + ((long long)split * M + row0) * C + col0 + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (r0 < rows_wg)
          *reinterpret_cast<float2*>(dst + (long long)r0 * C + 8 * j) =
              make_float2(acc[t][4 * j + 0], acc[t][4 * j + 1]);
        if (r0 + 8 < rows_wg)
          *reinterpret_cast<float2*>(dst + (long long)(r0 + 8) * C + 8 * j) =
              make_float2(acc[t][4 * j + 2], acc[t][4 * j + 3]);
      }
    } else {
      // the splits are the CTAs of one cluster: this one's sums go to its own
      // shared memory, fp32 [kBM][kRedPitch] over the x rows and the ring
      float* dst = reinterpret_cast<float*>(smem) + (rg * 64 + r0) * S::kRedPitch + col0 +
                   2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[t][4 * j + 0], acc[t][4 * j + 1]);
        *reinterpret_cast<float2*>(dst + 8 * S::kRedPitch + 8 * j) =
            make_float2(acc[t][4 * j + 2], acc[t][4 * j + 3]);
      }
    }
  }
  if (G != 4 && splits > 1) {
    // CTA k of the cluster adds up rows k·kBM/splits .. of all CTAs in split
    // order, adds b2, rounds once and writes them: no partial sum leaves the chip
    cluster_arrive();
    cluster_wait();
    const int rows_per = S::kBM / splits;
    for (int idx = tid; idx < rows_per * (C / 4); idx += S::kThreads) {
      const int row = split * rows_per + idx / (C / 4), c = (idx % (C / 4)) * 4;
      const uint32_t mine = x_tiles + (row * S::kRedPitch + c) * 4;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < splits; ++k) {
        const float4 v = ld_cluster_f32x4(map_to_cta(mine, k));
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      if (row < rows_valid) {
        const float2 b_lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2 + c));
        const float2 b_hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2 + c + 2));
        uint2 v;
        v.x = mm::pack_bf16(sum.x + b_lo.x, sum.y + b_lo.y);
        v.y = mm::pack_bf16(sum.z + b_hi.x, sum.w + b_hi.y);
        *reinterpret_cast<uint2*>(out + (long long)(m0 + row) * C + c) = v;
      }
    }
    cluster_arrive();  // no CTA leaves while another still reads its sums
    cluster_wait();
  }
}

template <int NT, int G, int RG>
cudaError_t launch_mma(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* out, float* partial, int M, int I, int splits,
                       LnArgs ln, cudaStream_t s) {
  using S = MmaShape<NT, G, RG>;
  if (I % (S::kChunk * splits) != 0) return cudaErrorInvalidValue;
  auto kernel = geglu_mma_kernel<NT, G, RG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         S::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int row_blocks = (M + S::kBM - 1) / S::kBM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G == 4 ? 2 * row_blocks : row_blocks, splits);
  cfg.blockDim = dim3(S::kThreads);
  cfg.dynamicSmemBytes = S::kSmemBytes;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  // G = 4: the two CTAs that share the rows; else the splits of a row block
  cluster[0].val.clusterDim.x = G == 4 ? 2 : 1;
  cluster[0].val.clusterDim.y = G == 4 ? 1 : splits;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = (G == 4 || splits > 1) ? 1 : 0;
  if (G != 4 && (splits > 8 || S::kBM % splits != 0)) return cudaErrorInvalidValue;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(x),
                           static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
                           static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
                           static_cast<bf16*>(out), partial, M, I, I / (S::kChunk * splits), splits,
                           ln.scale, ln.bias, ln.eps);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1 || G != 4) return err;
  launch_reduce(partial, b2, out, M, S::kC, splits, s);
  return cudaGetLastError();
}

// C / 64 = NT·G with NT <= 5: one warpgroup a row group up to C = 320 (64 or
// 128 rows a block), two over 64 rows up to 640, four (a cluster of two
// CTAs) up to 1280.
cudaError_t dispatch_mma(const void* x, const void* w1, const void* b1, const void* w2,
                         const void* b2, void* out, float* partial, int M, int C, int I, int rows,
                         int splits, LnArgs ln, cudaStream_t s) {
#define UDT_GEGLU_MMA(NT, G, RG) \
  return launch_mma<NT, G, RG>(x, w1, b1, w2, b2, out, partial, M, I, splits, ln, s)
  const int t = C / 64;
  if (C % 64 != 0 || splits < 1 || (rows != 64 && rows != 128) || (rows == 128 && t > 5))
    return cudaErrorInvalidValue;
  if (rows == 128) {
    switch (t) {
      case 1: UDT_GEGLU_MMA(1, 1, 2);
      case 2: UDT_GEGLU_MMA(2, 1, 2);
      case 3: UDT_GEGLU_MMA(3, 1, 2);
      case 4: UDT_GEGLU_MMA(4, 1, 2);
      case 5: UDT_GEGLU_MMA(5, 1, 2);
    }
  }
  switch (t) {
    case 1: UDT_GEGLU_MMA(1, 1, 1);
    case 2: UDT_GEGLU_MMA(2, 1, 1);
    case 3: UDT_GEGLU_MMA(3, 1, 1);
    case 4: UDT_GEGLU_MMA(4, 1, 1);
    case 5: UDT_GEGLU_MMA(5, 1, 1);
    case 6: UDT_GEGLU_MMA(3, 2, 1);
    case 8: UDT_GEGLU_MMA(4, 2, 1);
    case 10: UDT_GEGLU_MMA(5, 2, 1);
    case 12: UDT_GEGLU_MMA(3, 4, 1);
    case 16: UDT_GEGLU_MMA(4, 4, 1);
    case 20: UDT_GEGLU_MMA(5, 4, 1);
    default: return cudaErrorInvalidValue;
  }
#undef UDT_GEGLU_MMA
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
// epsilon), or both null for none. `route` as ops/geglu.py ROUTE_CODES:
//   2 ("mma"):  bf16, C / 64 in {1..5, 6, 8, 10, 12, 16, 20}; `rows` a block 64,
//               or 128 up to C = 320; I % (chunk·splits) == 0 with chunk = 64
//               (128 from C = 768 on); pointers 16-byte aligned; `partial` is
//               fp32 scratch of splits·M·C elements, unused when splits == 1
//               (the kernel then writes `out` itself: one launch).
//   1 ("wmma"): bf16, C % 16 == 0, rows in {16, 32, 64} with rows·C/256 <= 128
//               output tiles, I % (64·splits) == 0; `partial` as above, always
//               used; pointers 32-byte aligned.
//   0 ("fma"):  fp32, C <= 2048, I % 32 == 0; `partial`, rows and splits unused.
// Returns cudaGetLastError() after the launches (or the first failing call),
// cudaErrorInvalidValue for what the route does not take.
extern "C" int udt_geglu_ff(const void* x, const void* ln_scale, const void* ln_bias,
                            const void* w1, const void* b1, const void* w2, const void* b2,
                            void* out, void* partial, int M, int C, int I, int rows, int splits,
                            float eps, int dtype, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || C <= 0 || I <= 0 || (ln_scale == nullptr) != (ln_bias == nullptr))
    return cudaErrorInvalidValue;
  const LnArgs ln{static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias), eps};
  float* p = static_cast<float*>(partial);
  if (route == 2) {
    if (dtype != udt::kBFloat16) return cudaErrorInvalidValue;
    return dispatch_mma(x, w1, b1, w2, b2, out, p, M, C, I, rows, splits, ln, s);
  }
  if (route == 1) {
    if (dtype != udt::kBFloat16 || C % 16 != 0 || splits < 1 || I % (kKC * splits) != 0)
      return cudaErrorInvalidValue;
    switch (rows) {
      case 16: return dispatch_wmma<1>(x, w1, b1, w2, b2, out, p, M, C, I, splits, ln, s);
      case 32: return dispatch_wmma<2>(x, w1, b1, w2, b2, out, p, M, C, I, splits, ln, s);
      case 64: return dispatch_wmma<4>(x, w1, b1, w2, b2, out, p, M, C, I, splits, ln, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (route == 0 && dtype == udt::kFloat32) {
    if (C > 8 * kThreads || I % kSC != 0) return cudaErrorInvalidValue;
    return dispatch_simt(x, w1, b1, w2, b2, out, M, C, I, ln, s);
  }
  return cudaErrorInvalidValue;
}
