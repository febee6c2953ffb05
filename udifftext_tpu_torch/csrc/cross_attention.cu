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
// Two kernels, chosen by the wrapper (ops/cross_attention.py
// `cross_attention_plan`):
//
// "mma" (cross_attn_mma_kernel<RG>): bf16 with C % 64 == 0, C >= 128 and the
// block's tiles within shared memory (C + inner <= 1280 for 64 rows, 640 for
// 128; the ds1 and ds2 widths). It is the shipped flash forward's S = Q·Kᵀ,
// P·V with a projection in front and one behind, all on `wgmma` m64n64k16
// with fp32 accumulators, on flash_mma.cuh's 128-byte-swizzled 64×64 tiles.
// A warpgroup owns 64 rows; a block is RG = 1 or 2 of them (64 or 128 rows of
// one batch element), and both share every staged weight tile, which halves
// the weight traffic from L2 where 128 rows fit (C = inner = 320: 0.4 GB a
// call at ds1 B=32 instead of 0.8).
//   1. The block's x rows arrive by `cp.async` into swizzled tiles, and the
//      LayerNorm runs in place on them (`udt::layer_norm_rows`'s arithmetic
//      and summation order, a warp a row).
//   2. Per head h: q_h = xn·Wq[h]ᵀ on `wgmma_ss` (Wq's tiles streamed
//      through the ring); q_h rounded to bf16 stays in registers as the A
//      operand of s = q_h·k_hᵀ (`wgmma_rs_k`), the keys one 64-row tile
//      zero-filled past L and their logits set to −∞ before the max; the
//      softmax in registers (quad reductions, exp2); p rounded to bf16 as the
//      A operand of o_h = p·v_h (`wgmma_rs`, V read MN-major from the tile
//      as it landed); o_h rounded into the head's tile of an attention-output
//      buffer in shared memory.
//   3. out = attn·Woᵀ, a 64-column output tile at a time (Wo through the
//      ring); the epilogue adds bo to the fp32 accumulator, stages it in the
//      warpgroup's x tiles (dead by then; XOR-swizzled fp32 rows), and a
//      coalesced pass adds the fp32 of x read again (16-byte loads; the tile
//      was read moments before, so from L2) and writes bf16 with one
//      rounding, 16 bytes a store.
//   Weights, k and v arrive through one ring of 4 stages of two 64×64 tiles
//   (16 KB) filled by 16-byte `cp.async` three steps ahead (a step's products
//   take a fraction of an L2 copy's latency, so the ring is as deep as shared
//   memory allows); one `__syncthreads()` a step publishes what landed and
//   frees the stage that the next copy overwrites, as in geglu.cu. The
//   padding of the keys to 64 costs +10 % of the work at ds1 (C = 320, L =
//   12) and +5 % at ds2. What holds it back on the card (PERF.md row 6): a
//   step takes several times its products' tensor-core time, and with one
//   block an SM nothing overlaps a block's x load and LayerNorm.
//
// "wmma" / "fma" (cross_attn_kernel<T, BM>, the first-cut kernel): bf16 at the
// other widths (C = 1280 among them) and fp32. A block owns a tile of rows
// of one batch element (k and v are per batch element, so N % 64 == 0 keeps
// a tile from straddling two): 64 rows up to C = 384, 32 above, 16 in fp32.
// Two shared-memory buffers of rows × (C + 8) are reused through the stages,
// which is what lets C = 1280 fit (2·32·1288·2 B = 165 KB):
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

#include "flash_mma.cuh"
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


// ---------------------------------------------------------------------------
// bf16, C % 64 == 0: `wgmma` ("mma")
// ---------------------------------------------------------------------------

namespace mm = udt::mma;

constexpr int kMmaStages = 4;                              // stages of the ring
constexpr int kStageBytes = 2 * mm::kTileBytes;            // two 64×64 tiles a stage
constexpr int kMmaSmemMax = 232448;                        // a block's opt-in maximum

// Dynamic shared memory of the "mma" route for RG warpgroups, C = 64·ct and
// inner = 64·it (ops/cross_attention.py `mma_smem_bytes` mirrors it): the
// alignment slack, RG·ct x tiles, RG·it attention-output tiles, the ring.
size_t mma_smem_bytes(int rg, int ct, int it) {
  return 1024 + (size_t)mm::kTileBytes * rg * (ct + it) + (size_t)kMmaStages * kStageBytes;
}

// cp.async of 16 bytes, or 16 zero bytes when !valid (src is then not read).
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// grid: B·N / (64·RG) blocks of RG warpgroups; N % (64·RG) == 0, so a block's
// rows lie in one batch element. scale_log2 = d^-0.5 · log2(e).
template <int RG>
__global__ void __launch_bounds__(RG * mm::kWarpgroup, 1)
cross_attn_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_scale,
                      const float* __restrict__ ln_bias, const bf16* __restrict__ wq,
                      const bf16* __restrict__ k, const bf16* __restrict__ v,
                      const bf16* __restrict__ wo, const bf16* __restrict__ bo,
                      bf16* __restrict__ out, int N, int C, int inner, int L, float eps,
                      float scale_log2) {
  constexpr int kThreads = RG * mm::kWarpgroup;
  constexpr int BM = 64 * RG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = mm::align_smem(smem_raw);
  const int CT = C / 64, heads = inner / kD;
  const uint32_t x_tiles = mm::smem_u32(smem);                        // [RG][CT]
  const uint32_t attn_tiles = x_tiles + RG * CT * mm::kTileBytes;     // [RG][heads]
  const uint32_t ring = attn_tiles + RG * heads * mm::kTileBytes;     // [kMmaStages][2]
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid / mm::kWarpgroup, wg_thread = tid % mm::kWarpgroup;
  const long long m0 = (long long)blockIdx.x * BM;
  const long long batch = m0 / N;

  // the block's x rows, one commit group. Every loop around the products
  // has a trip count that is the same in every thread (BM·CT·8 / kThreads =
  // 4·CT here): a loop the compiler must treat as divergent makes ptxas
  // serialize the wgmma pipeline (C7520).
  for (int i = 0; i < 4 * CT; ++i) {
    const int idx = tid + i * kThreads;
    const int row = idx / (CT * 8), rem = idx - row * (CT * 8);
    const int t = rem >> 3, chunk = rem & 7;
    mm::cp_async16(x_tiles + ((row >> 6) * CT + t) * mm::kTileBytes + mm::swizzled(row & 63, chunk),
                   x + (m0 + row) * C + t * 64 + chunk * 8);
  }
  mm::cp_async_commit();

  // The tiles in the order they are used, two a step: per head the Wq tiles
  // of its q projection (columns 64t .. of rows 64h ..), then its k and v
  // tiles (keys past L zero); then per output tile n the Wo tiles of its
  // projection (columns 64t .. of rows 64n ..). Where a projection has an
  // odd number of tiles its last step's second tile is zero, so that every
  // step issues the same two products and no branch surrounds a wgmma.
  const int q_steps = (CT + 1) / 2, head_steps = q_steps + 1, o_steps = (heads + 1) / 2;
  const int total_steps = heads * head_steps + CT * o_steps;
  int ld_step = 0;
  auto issue_load = [&]() {
    if (ld_step < total_steps) {
      const uint32_t stage = ring + (ld_step % kMmaStages) * kStageBytes;
      int kind, a, t0;  // 0: Wq of head a; 1: k and v of head a; 2: Wo of output tile a
      if (ld_step < heads * head_steps) {
        a = ld_step / head_steps;
        const int i = ld_step - a * head_steps;
        kind = i < q_steps ? 0 : 1;
        t0 = 2 * i;
      } else {
        const int j = ld_step - heads * head_steps;
        a = j / o_steps;
        kind = 2;
        t0 = 2 * (j - a * o_steps);
      }
      const int tiles = kind == 0 ? CT : heads;  // of the projection (kind 0 or 2)
#pragma unroll
      for (int i = 0; i < 1024 / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int tile = idx >> 9, row = (idx >> 3) & 63, chunk = idx & 7;
        const uint32_t dst = stage + tile * mm::kTileBytes + mm::swizzled(row, chunk);
        if (kind != 1) {
          const bool valid = t0 + tile < tiles;
          const int t = valid ? t0 + tile : t0;
          cp_async16_zfill(dst,
                           kind == 0 ? wq + (long long)(a * 64 + row) * C + t * 64 + chunk * 8
                                     : wo + (long long)(a * 64 + row) * inner + t * 64 + chunk * 8,
                           valid);
        } else {
          const bool valid = row < L;
          cp_async16_zfill(dst, (tile == 0 ? k : v) + (batch * L + (valid ? row : 0)) * inner +
                                    a * kD + chunk * 8,
                           valid);
        }
      }
      ++ld_step;
    }
  };
#pragma unroll 1
  for (int t = 0; t < kMmaStages - 1; ++t) {
    issue_load();
    mm::cp_async_commit();
  }

  // the LayerNorm in place on the swizzled rows: `udt::layer_norm_rows`'s
  // arithmetic and order of summation, a warp a row
  mm::cp_async_wait<kMmaStages - 1>();  // the x rows' group is the oldest
  __syncthreads();
  {
    auto at = [&](int row, int c) {
      return reinterpret_cast<bf16*>(smem + ((row >> 6) * CT + (c >> 6)) * mm::kTileBytes +
                                     mm::swizzled(row & 63, (c & 63) >> 3) + (c & 7) * 2);
    };
    for (int i = 0; i < BM / (kThreads / 32); ++i) {  // 16 rows a warp
      const int r = tid / 32 + i * (kThreads / 32);
      float sum = 0.f;
      for (int c0 = 0; c0 < C; c0 += 32) sum += __bfloat162float(*at(r, c0 + lane));
      const float mean = udt::warp_sum(sum) / (float)C;
      float ss = 0.f;
      for (int c0 = 0; c0 < C; c0 += 32) {
        const float d = __bfloat162float(*at(r, c0 + lane)) - mean;
        ss = fmaf(d, d, ss);
      }
      const float inv = rsqrtf(udt::warp_sum(ss) / (float)C + eps);
      for (int c0 = 0; c0 < C; c0 += 32) {
        const int c = c0 + lane;
        *at(r, c) = __float2bfloat16_rn((__bfloat162float(*at(r, c)) - mean) * inv * ln_scale[c] +
                                        ln_bias[c]);
      }
    }
  }

  // One step: its tiles have landed for everyone and every warpgroup's
  // products of the previous step are complete; once this step's products
  // are issued, the previous step's stage takes the copy three steps ahead.
  int step = 0;
  auto next_stage = [&]() -> uint32_t {
    mm::cp_async_wait<kMmaStages - 2>();
    mm::fence_proxy_async();  // this thread's shared-memory writes before the tensor cores' reads
    __syncthreads();
    return ring + (step++ % kMmaStages) * kStageBytes;
  };
  auto refill = [&]() {
    issue_load();
    mm::cp_async_commit();
  };

  const uint32_t x_wg = x_tiles + wg * CT * mm::kTileBytes;
  const uint32_t attn_wg = attn_tiles + wg * heads * mm::kTileBytes;
  const int r0 = (wg_thread >> 5) * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8 of the 64
  float acc[32], s[32];
  uint32_t a[16];

#pragma unroll 1
  for (int h = 0; h < heads; ++h) {
    // q_h = xn·Wq[h]ᵀ over C, two 64-column tiles a step
#pragma unroll 1
    for (int t0 = 0; t0 < CT; t0 += 2) {
      const uint32_t stage = next_stage();
      mm::wgmma_fence();
      mm::tile_product_ss(acc, x_wg + t0 * mm::kTileBytes, stage, t0 > 0);
      // past the last x tile the weight tile is zero: any x tile serves as A
      mm::tile_product_ss(acc, x_wg + min(t0 + 1, CT - 1) * mm::kTileBytes, stage + mm::kTileBytes,
                          true);
      mm::wgmma_commit();
      refill();
      mm::wgmma_wait<0>();
    }
    mm::fence_accumulator(acc);
    mm::pack_a_fragments(acc, a);  // q_h rounded to bf16: the A operand of q_h·k_hᵀ
    // s = q_h·k_hᵀ with the keys as one zero-padded 64-row tile
    const uint32_t kv = next_stage();
    mm::wgmma_fence();
    mm::tile_product_rs_k(s, a, kv);
    mm::wgmma_commit();
    refill();
    mm::wgmma_wait<0>();
    mm::fence_accumulator(s);
    // the softmax in registers: logits of keys >= L are −∞
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = 8 * j + 2 * (lane & 3) + e < L;
        s[4 * j + e] = valid ? s[4 * j + e] * scale_log2 : -INFINITY;
        s[4 * j + 2 + e] = valid ? s[4 * j + 2 + e] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[4 * j + e]);
        mx1 = fmaxf(mx1, s[4 * j + 2 + e]);
      }
    }
    mx0 = mm::quad_max(mx0);
    mx1 = mm::quad_max(mx1);
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      s[i] = mm::exp2_approx(s[i] - mx0);
      s[i + 1] = mm::exp2_approx(s[i + 1] - mx0);
      s[i + 2] = mm::exp2_approx(s[i + 2] - mx1);
      s[i + 3] = mm::exp2_approx(s[i + 3] - mx1);
      l0 += s[i] + s[i + 1];
      l1 += s[i + 2] + s[i + 3];
    }
    const float inv0 = 1.f / mm::quad_sum(l0), inv1 = 1.f / mm::quad_sum(l1);
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      s[i] *= inv0;
      s[i + 1] *= inv0;
      s[i + 2] *= inv1;
      s[i + 3] *= inv1;
    }
    mm::pack_a_fragments(s, a);  // p rounded to bf16: the A operand of p·v_h
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    mm::wgmma_fence();
    mm::tile_product_rs(acc, a, kv + mm::kTileBytes);
    mm::wgmma_commit();
    mm::wgmma_wait<0>();
    mm::fence_accumulator(acc);
    // o_h rounded into the head's tile of the attention outputs (these 64 rows)
    const uint32_t tile = attn_wg + h * mm::kTileBytes;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      st_shared_u32(tile + mm::swizzled(r0, j) + (lane & 3) * 4, mm::pack_bf16(acc[4 * j], acc[4 * j + 1]));
      st_shared_u32(tile + mm::swizzled(r0 + 8, j) + (lane & 3) * 4,
                    mm::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]));
    }
  }

  // out = attn·Woᵀ + bo + x, a 64-column output tile at a time. The x tiles
  // are no longer read: the first two of this warpgroup's stage its fp32
  // tile, row r at r·64 floats, 8-float block j at (j ^ (r mod 8))·8, so that
  // the accumulator's 8-byte writes and the 16-byte reads of a row meet few
  // bank conflicts.
  float* stage_f = reinterpret_cast<float*>(smem + (size_t)wg * CT * mm::kTileBytes);
  auto staged = [&](int row, int col) { return stage_f + row * 64 + (col ^ ((row & 7) << 3)); };
  const long long row0 = m0 + wg * 64;
#pragma unroll 1
  for (int n = 0; n < CT; ++n) {
#pragma unroll 1
    for (int t0 = 0; t0 < heads; t0 += 2) {
      const uint32_t stage = next_stage();
      mm::wgmma_fence();
      mm::tile_product_ss(acc, attn_wg + t0 * mm::kTileBytes, stage, t0 > 0);
      mm::tile_product_ss(acc, attn_wg + min(t0 + 1, heads - 1) * mm::kTileBytes,
                          stage + mm::kTileBytes, true);
      mm::wgmma_commit();
      refill();
      mm::wgmma_wait<0>();
    }
    mm::fence_accumulator(acc);
    mm::named_barrier(1 + wg, mm::kWarpgroup);  // the last tile's staged rows are read
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bo + n * 64 + col));
      *reinterpret_cast<float2*>(staged(r0, col)) = make_float2(acc[4 * j] + b.x, acc[4 * j + 1] + b.y);
      *reinterpret_cast<float2*>(staged(r0 + 8, col)) =
          make_float2(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
    }
    mm::named_barrier(1 + wg, mm::kWarpgroup);
#pragma unroll
    for (int i = 0; i < 64 * 8 / mm::kWarpgroup; ++i) {
      const int idx = wg_thread + i * mm::kWarpgroup;
      const int row = idx >> 3, chunk = idx & 7;
      const long long gi = (row0 + row) * C + n * 64 + chunk * 8;
      float xv[8], o[8];
      load8(x + gi, xv);
      const float4 p0 = *reinterpret_cast<const float4*>(staged(row, chunk * 8));
      const float4 p1 = *reinterpret_cast<const float4*>(staged(row, chunk * 8) + 4);
      o[0] = p0.x + xv[0], o[1] = p0.y + xv[1], o[2] = p0.z + xv[2], o[3] = p0.w + xv[3];
      o[4] = p1.x + xv[4], o[5] = p1.y + xv[5], o[6] = p1.z + xv[6], o[7] = p1.w + xv[7];
      store8(out + gi, o);
    }
  }
}

template <int RG>
cudaError_t launch_mma(const void* x, const float* ln_scale, const float* ln_bias, const void* wq,
                       const void* k, const void* v, const void* wo, const void* bo, void* out,
                       int B, int N, int C, int inner, int L, float eps, float scale,
                       cudaStream_t s) {
  const size_t smem = mma_smem_bytes(RG, C / 64, inner / kD);
  if (C % 64 || C < 128 || N % (64 * RG) || smem > (size_t)kMmaSmemMax) return cudaErrorInvalidValue;
  static bool smem_set = false;  // the opt-in is made once an instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        cross_attn_mma_kernel<RG>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmemMax);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const long long blocks = (long long)B * N / (64 * RG);
  cross_attn_mma_kernel<RG><<<(unsigned)blocks, RG * mm::kWarpgroup, smem, s>>>(
      static_cast<const bf16*>(x), ln_scale, ln_bias, static_cast<const bf16*>(wq),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<const bf16*>(wo),
      static_cast<const bf16*>(bo), static_cast<bf16*>(out), N, C, inner, L, eps,
      scale * mm::kLog2e);
  return cudaGetLastError();
}

}  // namespace

// Routes "wmma" (bf16) and "fma" (fp32).
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

// Route "mma". As udt_cross_attention, bf16 only, with C % 64 == 0, C >= 128,
// `rows` 64 or 128 a block, N % rows == 0 and the block's tiles within 227 KB
// of shared memory (mma_smem_bytes).
// Returns cudaGetLastError() after the launch (or the first failing call).
extern "C" int udt_cross_attention_mma(const void* x, const void* ln_scale, const void* ln_bias,
                                       const void* wq, const void* k, const void* v,
                                       const void* wo, const void* bo, void* out, int B, int N,
                                       int C, int inner, int L, int rows, float eps, float scale,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0 || C <= 0 || inner <= 0 || inner % kD || L < 2 || L > 64)
    return cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(ln_scale);
  const float* bi = static_cast<const float*>(ln_bias);
  if (rows == 64)
    return launch_mma<1>(x, sc, bi, wq, k, v, wo, bo, out, B, N, C, inner, L, eps, scale, s);
  if (rows == 128)
    return launch_mma<2>(x, sc, bi, wq, k, v, wo, bo, out, B, N, C, inner, L, eps, scale, s);
  return cudaErrorInvalidValue;
}
