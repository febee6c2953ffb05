// Fused GroupNorm (+ SiLU) for Hopper (sm_90a) on channels-last input:
//   y = silu?( (x − mean_g)·rsqrt(var_g + eps)·scale_c + bias_c )
// with x (B, N, C) contiguous, G groups of C/G adjacent channels, statistics
// per (sample, group) in fp32, SiLU on the fp32 value, one rounding at the store.
//
// Replaces: udifftext_tpu/ops/groupnorm.py `fused_groupnorm_silu` /
// `_gn_kernel` (the Pallas TPU kernel).
//
// What differs from the TPU kernel, on purpose:
//   - its grid is one program per sample with the whole (N, C) sample in
//     VMEM; 2.6 MB does not fit 227 KB of shared memory, and B programs would
//     leave most of 132 SMs idle. Here blocks own (sample, chunk of rows);
//   - its one-hot membership matmul exists because the TPU's vector unit
//     cannot retile (N, G, C/G); here a thread sums its own channels and a
//     shared-memory reduction groups them;
//   - its variance is E[x²] − mean², which cancels when |mean| >> spread;
//     here every chunk's sums run over x − pivot (the pivot a value of the
//     group itself), give the chunk's mean and its M2 about that mean, and
//     chunks are merged with Chan's update: as accurate as the centered
//     variance of GroupNorm32, from one read of x;
//   - it drops the rows past the last full 512-row chunk; here every row
//     counts.
//
// What bounds it on the H100: bytes. x is read and y written once: 2·B·N·C
// elements over 3.35 TB/s, 0.050 ms at (32, 64, 64, 320) bf16. This design
// reads x in two launches: pass 1 (statistics) and pass 2 (normalize). At
// B = 2 (5 MB) the second read is served by the
// 50 MB L2; at B = 32 (84 MB) it cannot be, so the kernel moves 3 units of
// traffic where the bound counts 2.
//
// Design. Two launches, no atomics, deterministic:
//   pass 1, grid (chunks, B): a block sums d = x − pivot and d² for each
//     channel of its rows (a thread owns one 16-byte vector of channels and
//     strides over rows, so loads are coalesced along C), reduces channels
//     to groups in a fixed order, and writes the chunk's (mean, M2) per
//     group to an fp32 workspace (B, chunks, G, 2). The
//     wrapper picks the rows per chunk: fewer while SMs would idle, but at
//     most 64 chunks a sample, since pass 2 merges them one after the other;
//   pass 2, grid (chunks, B): a block merges its sample's partials in chunk
//     order (Chan et al.: mean += δ·n_k/n, M2 += M2_k + δ²·n·n_k/(n + n_k)),
//     folds rstd·scale per channel and normalizes its chunk with 16-byte
//     loads and stores.
// A block per group would read C/G·2-byte slivers (20 bytes at C = 320) and
// is avoided.

#include <math.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxChannels = 4096;  // csum holds one fp32 per (thread row, channel)
constexpr int kMaxGroups = 256;

// VEC consecutive elements (16 bytes) widened to fp32, and back.
template <typename T>
struct Vec;
template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ static void load(const bf16* p, float (&out)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(bf16* p, const float (&v)[8]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&out)[4]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  }
  __device__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// How a block's threads tile a chunk: tx picks a 16-byte vector of channels,
// ty a row; a thread strides over rows by `ty_n` and over vectors by `tx_n`.
struct ThreadTile {
  int tx, ty, tx_n, ty_n;
  __device__ ThreadTile(int vectors) {
    tx_n = vectors < kThreads ? vectors : kThreads;
    ty_n = kThreads / tx_n;
    tx = threadIdx.x % tx_n;
    ty = threadIdx.x / tx_n;  // ty >= ty_n: a thread with no work
  }
  __device__ bool active() const { return ty < ty_n; }
};

// Σ over the block's thread rows and a group's channels of csum, in a fixed order.
__device__ __forceinline__ float group_sum(const float* csum, int ty_n, int C, int g, int cg) {
  float s = 0.f;
  for (int t = 0; t < ty_n; ++t)
    for (int c = g * cg; c < (g + 1) * cg; ++c) s += csum[t * C + c];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial, int N, int C, int G,
                int rows_per_chunk) {
  constexpr int VEC = Vec<T>::N;
  // Σd and Σd² per (thread row, channel): [ty_n][C]; ty_n·C <= max(kThreads·VEC, C)
  __shared__ float csum1[kMaxChannels], csum2[kMaxChannels];
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int r0 = chunk * rows_per_chunk;
  const int rows = min(rows_per_chunk, N - r0);
  const int cg = C / G;
  const ThreadTile tt(C / VEC);
  const T* xb = x + ((size_t)b * N + r0) * C;

  // d = x − pivot, the pivot of a group being its first element in the
  // chunk: a value from inside the data, so Σd² − (Σd)²/n does not cancel
  if (tt.active()) {
    for (int j = tt.tx; j < C / VEC; j += tt.tx_n) {
      float p[VEC], s1[VEC], s2[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        p[i] = udt::load_f32(xb + (j * VEC + i) / cg * cg);
        s1[i] = s2[i] = 0.f;
      }
#pragma unroll 4
      for (int r = tt.ty; r < rows; r += tt.ty_n) {
        float v[VEC];
        Vec<T>::load(xb + (size_t)r * C + j * VEC, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = v[i] - p[i];
          s1[i] += d;
          s2[i] = fmaf(d, d, s2[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        csum1[tt.ty * C + j * VEC + i] = s1[i];
        csum2[tt.ty * C + j * VEC + i] = s2[i];
      }
    }
  }
  __syncthreads();
  float* dst = partial + ((size_t)b * gridDim.x + chunk) * G * 2;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    const float n = (float)(rows * cg);
    const float sd = group_sum(csum1, tt.ty_n, C, g, cg), sdd = group_sum(csum2, tt.ty_n, C, g, cg);
    dst[2 * g] = udt::load_f32(xb + g * cg) + sd / n;   // the chunk's mean
    dst[2 * g + 1] = fmaxf(sdd - sd * sd / n, 0.f);     // and its M2 about that mean
  }
}

template <typename T, bool SILU>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, const float* __restrict__ partial,
                T* __restrict__ y, int N, int C, int G, int rows_per_chunk, float eps) {
  constexpr int VEC = Vec<T>::N;
  __shared__ float gmean[kMaxGroups], grstd[kMaxGroups];
  const int chunk = blockIdx.x, chunks = gridDim.x, b = blockIdx.y;
  const int r0 = chunk * rows_per_chunk;
  const int rows = min(rows_per_chunk, N - r0);
  const int cg = C / G;

  const float* src = partial + (size_t)b * chunks * G * 2;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float n = 0.f, mean = 0.f, m2 = 0.f;
#pragma unroll 8  // the loads do not depend on the running merge: keep several in flight
    for (int k = 0; k < chunks; ++k) {  // chunk order: the same sum in every block
      const float nk = (float)(min(rows_per_chunk, N - k * rows_per_chunk) * cg);
      const float mk = src[((size_t)k * G + g) * 2], m2k = src[((size_t)k * G + g) * 2 + 1];
      const float tot = n + nk, delta = mk - mean;
      mean += delta * (nk / tot);
      m2 += m2k + delta * delta * (n * nk / tot);
      n = tot;
    }
    gmean[g] = mean;
    grstd[g] = rsqrtf(m2 / n + eps);
  }
  __syncthreads();

  const ThreadTile tt(C / VEC);
  if (!tt.active()) return;
  const size_t base = ((size_t)b * N + r0) * C;
  for (int j = tt.tx; j < C / VEC; j += tt.tx_n) {
    float m[VEC], a[VEC], bb[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = j * VEC + i;
      m[i] = gmean[c / cg];
      a[i] = grstd[c / cg] * scale[c];
      bb[i] = bias[c];
    }
    for (int r = tt.ty; r < rows; r += tt.ty_n) {
      float v[VEC];
      Vec<T>::load(x + base + (size_t)r * C + j * VEC, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float o = fmaf(v[i] - m[i], a[i], bb[i]);
        if (SILU) o = o / (1.f + expf(-o));
        v[i] = o;
      }
      Vec<T>::store(y + base + (size_t)r * C + j * VEC, v);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, const float* bias, float* partial, void* y,
                   int B, int N, int C, int G, int rows_per_chunk, float eps, int with_silu,
                   cudaStream_t s) {
  const dim3 grid((N + rows_per_chunk - 1) / rows_per_chunk, B);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  gn_stats_kernel<T><<<grid, kThreads, 0, s>>>(xt, partial, N, C, G, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (with_silu)
    gn_apply_kernel<T, true><<<grid, kThreads, 0, s>>>(xt, scale, bias, partial, yt, N, C, G,
                                                       rows_per_chunk, eps);
  else
    gn_apply_kernel<T, false><<<grid, kThreads, 0, s>>>(xt, scale, bias, partial, yt, N, C, G,
                                                        rows_per_chunk, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y (B, N, C) contiguous, 16-byte aligned, one dtype; scale, bias (C,)
// fp32; partial: fp32 scratch of B·ceil(N / rows_per_chunk)·G·2 elements.
// C % G == 0, C % 8 == 0, C <= 4096, G <= 256, B <= 65535, rows_per_chunk >= 1.
// Returns cudaGetLastError() after the launches (or the first failing call).
extern "C" int udt_groupnorm_silu(const void* x, const void* scale, const void* bias,
                                  void* partial, void* y, int B, int N, int C, int G,
                                  int rows_per_chunk, float eps, int with_silu, int dtype,
                                  void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || C <= 0 || G <= 0 || G > kMaxGroups || C % G != 0 ||
      C % 8 != 0 || C > kMaxChannels || rows_per_chunk < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* p = static_cast<float*>(partial);
  if (dtype == udt::kBFloat16)
    return launch<bf16>(x, sc, bi, p, y, B, N, C, G, rows_per_chunk, eps, with_silu, s);
  if (dtype == udt::kFloat32)
    return launch<float>(x, sc, bi, p, y, B, N, C, G, rows_per_chunk, eps, with_silu, s);
  return cudaErrorInvalidValue;
}
