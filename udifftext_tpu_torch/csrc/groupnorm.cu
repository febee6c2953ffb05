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
//     leave most of 132 SMs idle. Here the rows of a sample are split over
//     blocks;
//   - its one-hot membership matmul exists because the TPU's vector unit
//     cannot retile (N, G, C/G); here a thread sums its own channels and a
//     shared-memory reduction groups them;
//   - its variance is E[x²] − mean², which cancels when |mean| >> spread;
//     here every block's M2 is taken about its own mean and the blocks'
//     (mean, M2) are merged with Chan's update: as accurate as the centered
//     variance of GroupNorm32;
//   - it drops the rows past the last full 512-row chunk; here every row
//     counts.
//
// What bounds it on the H100: bytes. x is read and y written once: 2·B·N·C
// elements over 3.35 TB/s, 0.050 ms at (32, 64, 64, 320) bf16.
//
// Two routes, chosen by shape on the host (ops/groupnorm.py `groupnorm_plan`):
//
// "cluster" (gn_cluster_kernel): one launch; x read once and y written once.
//   A thread-block cluster of K <= 8 CTAs owns one (sample, slice of S whole
//   groups), the slice a 16-byte multiple of channels (8 groups = 80
//   channels = 160 bytes at C = 320 bf16). The CTAs split the sample's rows;
//   each copies its rows × slice into shared memory with 16-byte `cp.async`
//   in four commit groups, summing each landed quarter while the rest is in
//   flight, then takes the per-group mean of its copy and, in a second pass
//   over shared memory, the M2 about that mean: an exactly centered partial.
//   The partials cross to every CTA of the cluster through distributed
//   shared memory after one cluster barrier, and each CTA merges them in
//   rank order with Chan's update (mean += δ·n_k/n, M2 += M2_k +
//   δ²·n·n_k/(n + n_k)): the same sums in every CTA, deterministic, no
//   atomics and no scratch in device memory. It then normalizes its copy
//   and writes y with 16-byte stores. The host picks S and K so that the
//   (sample, slice) fits K CTAs, preferring first a grid of two CTAs for
//   each SM, then a copy small enough for two CTAs an SM (one loads while
//   the other computes), then the widest slice.
//
// "stream" (gn_stream_stats_kernel, gn_stream_apply_kernel): a (sample,
//   slice) that no cluster holds, or holds only as a sliver of 16-64 bytes a
//   row, e.g. the autoencoder's (16, 512, 512, 128) fp32. Two launches over
//   one grid (chunks, G / S, B): a block owns `rows_per_chunk` rows of one
//   (sample, slab of S whole groups). No atomics, deterministic; x is read
//   twice and y written once (3 units of traffic where the bound counts 2):
//   pass 1: the block streams its rows with 16-byte loads, four in flight a
//     thread; a thread keeps a Welford (mean, M2) of each of its channels,
//     and the block merges them with Chan's update in a fixed order (a warp
//     a group, lanes then a shuffle tree) into one centered (mean, M2) a
//     group, written to an fp32 workspace (B, chunks, G). The host bounds
//     the chunks of a sample (`MAX_CHUNKS`) and picks the slab and chunks so
//     that the grid fills the SMs;
//   pass 2: each block merges its slab's partials of every chunk in chunk
//     order (the same sums in every block), folds rstd·scale per channel and
//     normalizes its rows with 16-byte loads and stores, last row first:
//     the rows pass 1 read last are the ones still in L2.
// A block per group would read C/G·2-byte slivers (20 bytes at C = 320) and
// is avoided on both routes.

#include <math.h>

#include "common.cuh"
#include "flash_mma.cuh"

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
    unpack(*reinterpret_cast<const uint4*>(p), out);
  }
  __device__ static void unpack(const uint4& raw, float (&out)[8]) {
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
    unpack(*reinterpret_cast<const uint4*>(p), out);
  }
  __device__ static void unpack(const uint4& raw, float (&out)[4]) {
    out[0] = __uint_as_float(raw.x), out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z), out[3] = __uint_as_float(raw.w);
  }
  __device__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// How a block's threads tile a slab: tx picks a 16-byte vector of channels,
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
  // rows r < rows with r ≡ ty (mod ty_n): what thread row ty visits
  __device__ int visits(int ty_, int rows) const {
    return ty_ < rows ? (rows - ty_ + ty_n - 1) / ty_n : 0;
  }
};

// Chan's update: (n, mean, m2) absorbs a disjoint part (nb, mb, m2b); a part
// of no elements changes nothing.
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb, float mb,
                                           float m2b) {
  if (nb > 0.f) {
    const float tot = n + nb, delta = mb - mean, w = nb / tot;
    mean = fmaf(delta, w, mean);
    m2 = m2 + m2b + delta * delta * (n * w);
    n = tot;
  }
}

// One row's vector into a thread's Welford state of k − 1 rows (inv = 1 / k).
template <int VEC>
__device__ __forceinline__ void welford(const float (&v)[VEC], float inv, float (&mean)[VEC],
                                        float (&m2)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float d = v[i] - mean[i];
    mean[i] = fmaf(d, inv, mean[i]);
    m2[i] = fmaf(d, v[i] - mean[i], m2[i]);
  }
}

constexpr int kStreamUnroll = 4;  // 16-byte loads in flight a thread

// Pass 1 of route "stream": grid (chunks, G / S, B); the block's centered
// (mean, M2) of each of its slab's groups into partial[b][chunk][group].
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_stream_stats_kernel(const T* __restrict__ x, float2* __restrict__ partial, int N, int C, int G,
                       int cg, int width, int rows_per_chunk) {
  constexpr int VEC = Vec<T>::N;
  // a thread row's (mean, M2) per channel of the slab: [ty_n][width];
  // ty_n·width <= max(kThreads·VEC, width) <= kMaxChannels
  __shared__ float smean[kMaxChannels], sm2[kMaxChannels];
  const int chunk = blockIdx.x, slab = blockIdx.y, b = blockIdx.z;
  const int r0 = chunk * rows_per_chunk;
  const int rows = min(rows_per_chunk, N - r0);
  const int groups = width / cg;
  const ThreadTile tt(width / VEC);
  const T* xb = x + ((size_t)b * N + r0) * C + (size_t)slab * width;
  const size_t step = (size_t)tt.ty_n * C;

  if (tt.active()) {
    for (int j = tt.tx; j < width / VEC; j += tt.tx_n) {
      float mean[VEC], m2[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) mean[i] = m2[i] = 0.f;
      const T* p = xb + (size_t)tt.ty * C + j * VEC;
      int r = tt.ty, k = 0;
      for (; r + (kStreamUnroll - 1) * tt.ty_n < rows; r += kStreamUnroll * tt.ty_n) {
        float v[kStreamUnroll][VEC];
#pragma unroll
        for (int u = 0; u < kStreamUnroll; ++u) Vec<T>::load(p + u * step, v[u]);
        p += kStreamUnroll * step;
#pragma unroll
        for (int u = 0; u < kStreamUnroll; ++u) welford(v[u], 1.f / (float)(++k), mean, m2);
      }
      for (; r < rows; r += tt.ty_n) {
        float v[VEC];
        Vec<T>::load(p, v);
        p += step;
        welford(v, 1.f / (float)(++k), mean, m2);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        smean[tt.ty * width + j * VEC + i] = mean[i];
        sm2[tt.ty * width + j * VEC + i] = m2[i];
      }
    }
  }
  __syncthreads();

  // a warp a group: each lane merges the entries (thread row, channel) e ≡
  // lane (mod 32) in order, then the lanes merge down a shuffle tree
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x / 32; g < groups; g += kThreads / 32) {
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int e = lane; e < tt.ty_n * cg; e += 32) {
      const int t = e / cg, c = g * cg + e % cg;
      chan_merge(n, mean, m2, (float)tt.visits(t, rows), smean[t * width + c], sm2[t * width + c]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float nb = __shfl_down_sync(0xffffffffu, n, off);
      const float mb = __shfl_down_sync(0xffffffffu, mean, off);
      const float m2b = __shfl_down_sync(0xffffffffu, m2, off);
      chan_merge(n, mean, m2, nb, mb, m2b);
    }
    if (lane == 0)
      partial[((size_t)b * gridDim.x + chunk) * G + slab * groups + g] = make_float2(mean, m2);
  }
}

// Pass 2 of route "stream": the same grid; every block merges its slab's
// partials in chunk order, then normalizes its rows, last first.
template <typename T, bool SILU>
__global__ void __launch_bounds__(kThreads)
gn_stream_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, const float2* __restrict__ partial,
                       T* __restrict__ y, int N, int C, int G, int cg, int width,
                       int rows_per_chunk, float eps) {
  constexpr int VEC = Vec<T>::N;
  __shared__ float2 stat[kMaxGroups];  // (mean, rstd) of the slab's groups
  const int chunk = blockIdx.x, chunks = gridDim.x, slab = blockIdx.y, b = blockIdx.z;
  const int r0 = chunk * rows_per_chunk;
  const int rows = min(rows_per_chunk, N - r0);
  const int groups = width / cg;

  const float2* src = partial + (size_t)b * chunks * G + slab * groups;
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    float n = 0.f, mean = 0.f, m2 = 0.f;
#pragma unroll 8  // the loads do not depend on the running merge: keep several in flight
    for (int k = 0; k < chunks; ++k) {  // chunk order: the same sums in every block
      const float2 pk = src[(size_t)k * G + g];
      chan_merge(n, mean, m2, (float)(min(rows_per_chunk, N - k * rows_per_chunk) * cg), pk.x,
                 pk.y);
    }
    stat[g] = make_float2(mean, rsqrtf(m2 / n + eps));
  }
  __syncthreads();

  const ThreadTile tt(width / VEC);
  if (!tt.active() || tt.ty >= rows) return;
  const size_t base = ((size_t)b * N + r0) * C + (size_t)slab * width;
  const size_t step = (size_t)tt.ty_n * C;
  const int last = tt.ty + (rows - 1 - tt.ty) / tt.ty_n * tt.ty_n;  // this thread's last row
  for (int j = tt.tx; j < width / VEC; j += tt.tx_n) {
    float m[VEC], a[VEC], bb[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = j * VEC + i;
      const float2 st = stat[c / cg];
      m[i] = st.x;
      a[i] = st.y * scale[slab * width + c];
      bb[i] = bias[slab * width + c];
    }
    const size_t off0 = base + (size_t)last * C + j * VEC;
    const T* px = x + off0;
    T* py = y + off0;
    int r = last;
    for (; r - (kStreamUnroll - 1) * tt.ty_n >= 0; r -= kStreamUnroll * tt.ty_n) {
      // the loads in flight as raw 16-byte vectors, widened one at a time
      // (widened all at once, bf16 with SiLU spills)
      uint4 raw[kStreamUnroll];
#pragma unroll
      for (int u = 0; u < kStreamUnroll; ++u)
        raw[u] = *reinterpret_cast<const uint4*>(px - u * step);
#pragma unroll
      for (int u = 0; u < kStreamUnroll; ++u) {
        float v[VEC];
        Vec<T>::unpack(raw[u], v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float o = fmaf(v[i] - m[i], a[i], bb[i]);
          if (SILU) o = o / (1.f + expf(-o));
          v[i] = o;
        }
        Vec<T>::store(py - u * step, v);
      }
      px -= kStreamUnroll * step;
      py -= kStreamUnroll * step;
    }
    for (; r >= 0; r -= tt.ty_n) {
      float v[VEC];
      Vec<T>::load(px, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float o = fmaf(v[i] - m[i], a[i], bb[i]);
        if (SILU) o = o / (1.f + expf(-o));
        v[i] = o;
      }
      Vec<T>::store(py, v);
      px -= step;
      py -= step;
    }
  }
}

template <typename T>
cudaError_t launch_stream(const void* x, const float* scale, const float* bias, float2* partial,
                          void* y, int B, int N, int C, int G, int slice_groups,
                          int rows_per_chunk, float eps, int with_silu, cudaStream_t s) {
  constexpr int VEC = Vec<T>::N;
  const int cg = C / G, width = slice_groups * cg;
  if (slice_groups < 1 || G % slice_groups || width % VEC || rows_per_chunk < 1)
    return cudaErrorInvalidValue;
  const dim3 grid((N + rows_per_chunk - 1) / rows_per_chunk, G / slice_groups, B);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  gn_stream_stats_kernel<T><<<grid, kThreads, 0, s>>>(xt, partial, N, C, G, cg, width,
                                                       rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (with_silu)
    gn_stream_apply_kernel<T, true><<<grid, kThreads, 0, s>>>(xt, scale, bias, partial, yt, N, C,
                                                              G, cg, width, rows_per_chunk, eps);
  else
    gn_stream_apply_kernel<T, false><<<grid, kThreads, 0, s>>>(xt, scale, bias, partial, yt, N, C,
                                                               G, cg, width, rows_per_chunk, eps);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// route "cluster"
// ---------------------------------------------------------------------------

constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may opt in to
constexpr int kLoadStages = 4;    // commit groups of the copy: quarters of the rows

using udt::mma::cp_async16;
using udt::mma::cp_async_commit;
using udt::mma::cp_async_wait;
using udt::mma::smem_u32;

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
// the cluster, and an 8-byte load from such an address.
__device__ __forceinline__ uint32_t map_to_cta(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float2 ld_cluster_f32x2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// A CTA's dynamic shared memory, in bytes from its start (ops/groupnorm.py
// `cluster_smem_bytes` mirrors it): the copy [rows][width] of x's dtype, the
// column sums [kThreads·vec] fp32, and two (mean, ·) pairs a group.
struct ClusterLayout {
  size_t csum, part, stat, total;
  ClusterLayout(int rows, int width, int esize, int vec, int groups) {
    csum = ((size_t)rows * width * esize + 15) / 16 * 16;
    part = csum + (size_t)kThreads * vec * sizeof(float);
    stat = part + (size_t)groups * sizeof(float2);
    total = stat + (size_t)groups * sizeof(float2);
  }
};

// Adds rows ra .. rb − 1 of the packed copy that fall to this thread (rows
// ty, ty + ty_n, ...; vector column tx) to its per-element sums.
template <typename T>
__device__ __forceinline__ void sum_rows(const T* data, int width, int ra, int rb, int tx, int ty,
                                         int ty_n, float (&acc)[Vec<T>::N]) {
  constexpr int VEC = Vec<T>::N;
  for (int r = ra + ty; r < rb; r += ty_n) {
    float v[VEC];
    Vec<T>::load(data + (size_t)r * width + tx * VEC, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] += v[i];
  }
}

// The threads' per-element sums into csum [ty_n][width], then a barrier.
template <int VEC>
__device__ __forceinline__ void group_sums(const float (&acc)[VEC], float* csum, bool active,
                                           int tx, int ty, int width) {
  if (active) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) csum[ty * width + tx * VEC + i] = acc[i];
  }
  __syncthreads();
}

// A lane's share of Σ over the thread rows and group g's channels of csum,
// in a fixed order (a warp a group; the caller adds the lanes up).
__device__ __forceinline__ float group_sum_lanes(const float* csum, int ty_n, int width, int cg,
                                                 int g, int lane) {
  float t = 0.f;
  for (int e = lane; e < ty_n * cg; e += 32) t += csum[(e / cg) * width + g * cg + e % cg];
  return t;
}

// gridDim = (K, G / S, B), one cluster of K CTAs along x; CTA `rank` owns rows
// rank·rows_per_cta .. of sample blockIdx.z, channels blockIdx.y·width ..
// (width = S·cg). Offsets of the layout are passed in from the host.
template <typename T, bool SILU>
__global__ void __launch_bounds__(kThreads)
gn_cluster_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y, int N, int C, int cg,
                  int width, int rows_per_cta, int off_csum, int off_part, int off_stat,
                  float eps) {
  constexpr int VEC = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem_gn[];
  const int groups = width / cg;  // S whole groups in the slice
  T* data = reinterpret_cast<T*>(smem_gn);                         // [rows][width]
  float* csum = reinterpret_cast<float*>(smem_gn + off_csum);      // [ty_n][width]
  float2* part = reinterpret_cast<float2*>(smem_gn + off_part);    // [S]: this CTA's (mean, M2)
  float2* stat = reinterpret_cast<float2*>(smem_gn + off_stat);    // [S]: its mean; then (mean, rstd)
  const int rank = (int)cluster_ctarank(), ctas = gridDim.x;
  const int slice = blockIdx.y, b = blockIdx.z;
  const int r0 = rank * rows_per_cta;
  const int rows = min(rows_per_cta, N - r0);  // >= 1: the host sizes the cluster so
  const int vr = width / VEC;                  // 16-byte vectors a row, <= kThreads / 2
  const int tid = threadIdx.x, lane = tid & 31;
  // a thread keeps one vector column tx and walks rows ty, ty + ty_n, ...; a
  // warp's loads from the packed copy are then 512 consecutive bytes
  const int ty_n = kThreads / vr, tx = tid % vr, ty = tid / vr;
  const bool active = ty < ty_n;
  const size_t gbase = ((size_t)b * N + r0) * C + (size_t)slice * width;

  // the copy, in kLoadStages commit groups of consecutive rows
  const uint32_t data_u32 = smem_u32(data);
#pragma unroll 1
  for (int s = 0; s < kLoadStages; ++s) {
    const int ra = rows * s / kLoadStages, rb = rows * (s + 1) / kLoadStages;
    for (int idx = ra * vr + tid; idx < rb * vr; idx += kThreads) {
      const int r = idx / vr, c = idx - r * vr;
      cp_async16(data_u32 + (uint32_t)idx * 16, x + gbase + (size_t)r * C + c * VEC);
    }
    cp_async_commit();
  }

  // pass 1: the mean of each group over this CTA's rows, summed as the copy lands
  float s1[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = 0.f;
  static_assert(kLoadStages == 4, "one wait per commit group");
  cp_async_wait<3>();
  __syncthreads();
  if (active) sum_rows(data, width, rows * 0 / 4, rows * 1 / 4, tx, ty, ty_n, s1);
  cp_async_wait<2>();
  __syncthreads();
  if (active) sum_rows(data, width, rows * 1 / 4, rows * 2 / 4, tx, ty, ty_n, s1);
  cp_async_wait<1>();
  __syncthreads();
  if (active) sum_rows(data, width, rows * 2 / 4, rows * 3 / 4, tx, ty, ty_n, s1);
  cp_async_wait<0>();
  __syncthreads();
  if (active) sum_rows(data, width, rows * 3 / 4, rows, tx, ty, ty_n, s1);
  const float n_cta = (float)rows * cg;
  group_sums(s1, csum, active, tx, ty, width);
  for (int g = tid / 32; g < groups; g += kThreads / 32) {
    const float t = udt::warp_sum(group_sum_lanes(csum, ty_n, width, cg, g, lane));
    if (lane == 0) stat[g].x = t / n_cta;
  }
  __syncthreads();

  // pass 2: M2 about that mean, from the copy again: an exactly centered partial
  float m[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    m[i] = stat[(tx * VEC + i) / cg].x;
    s2[i] = 0.f;
  }
  if (active) {
    for (int r = ty; r < rows; r += ty_n) {
      float v[VEC];
      Vec<T>::load(data + (size_t)r * width + tx * VEC, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = v[i] - m[i];
        s2[i] = fmaf(d, d, s2[i]);
      }
    }
  }
  group_sums(s2, csum, active, tx, ty, width);
  for (int g = tid / 32; g < groups; g += kThreads / 32) {
    const float t = udt::warp_sum(group_sum_lanes(csum, ty_n, width, cg, g, lane));
    if (lane == 0) part[g] = make_float2(stat[g].x, t);
  }
  __syncthreads();

  // every CTA's partials are in its shared memory: each CTA merges all of
  // them in rank order, so every CTA computes the same (mean, rstd)
  cluster_arrive();
  cluster_wait();
  for (int g = tid; g < groups; g += kThreads) {
    float n = 0.f, mean = 0.f, m2 = 0.f;
    const uint32_t mine = smem_u32(part + g);
    for (int k = 0; k < ctas; ++k) {
      const float2 pk = ld_cluster_f32x2(map_to_cta(mine, (uint32_t)k));
      const float nk = (float)(min(rows_per_cta, N - k * rows_per_cta) * cg);
      const float tot = n + nk, delta = pk.x - mean;
      mean += delta * (nk / tot);
      m2 += pk.y + delta * delta * (n * nk / tot);
      n = tot;
    }
    stat[g] = make_float2(mean, rsqrtf(m2 / n + eps));
  }
  __syncthreads();
  cluster_arrive();  // this CTA reads no other CTA's shared memory from here on

  // normalize the copy and write y with 16-byte stores
  if (active) {
    float a[VEC], bb[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = tx * VEC + i;
      const float2 st = stat[c / cg];
      m[i] = st.x;
      a[i] = st.y * scale[slice * width + c];
      bb[i] = bias[slice * width + c];
    }
    for (int r = ty; r < rows; r += ty_n) {
      float v[VEC];
      Vec<T>::load(data + (size_t)r * width + tx * VEC, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float o = fmaf(v[i] - m[i], a[i], bb[i]);
        if (SILU) o = o / (1.f + expf(-o));
        v[i] = o;
      }
      Vec<T>::store(y + gbase + (size_t)r * C + tx * VEC, v);
    }
  }
  cluster_wait();  // no CTA leaves while another may still read its partials
}

template <typename T, bool SILU>
cudaError_t launch_cluster_kernel(const T* x, const float* scale, const float* bias, T* y, int B,
                                  int N, int C, int G, int slice_groups, int cluster,
                                  int rows_per_cta, float eps, cudaStream_t s) {
  constexpr int VEC = Vec<T>::N;
  const int cg = C / G, width = slice_groups * cg;
  const ClusterLayout lay(rows_per_cta, width, (int)sizeof(T), VEC, slice_groups);
  if (lay.total > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  static bool smem_set = false;  // the opt-in is made once an instantiation
  if (!smem_set) {
    auto kernel = gn_cluster_kernel<T, SILU>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, G / slice_groups, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto kernel = gn_cluster_kernel<T, SILU>;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, scale, bias, y,
                                             N, C, cg, width, rows_per_cta, (int)lay.csum,
                                             (int)lay.part, (int)lay.stat, eps);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t launch_cluster(const void* x, const float* scale, const float* bias, void* y, int B,
                           int N, int C, int G, int slice_groups, int cluster, int rows_per_cta,
                           float eps, int with_silu, cudaStream_t s) {
  constexpr int VEC = Vec<T>::N;
  const int width = slice_groups * (C / G);
  if (slice_groups < 1 || G % slice_groups || width % VEC || width / VEC > kThreads / 2 ||
      cluster < 1 || cluster > 8 || rows_per_cta < 1 ||
      (long long)rows_per_cta * (cluster - 1) >= N || (long long)rows_per_cta * cluster < N)
    return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (with_silu)
    return launch_cluster_kernel<T, true>(xt, scale, bias, yt, B, N, C, G, slice_groups, cluster,
                                          rows_per_cta, eps, s);
  return launch_cluster_kernel<T, false>(xt, scale, bias, yt, B, N, C, G, slice_groups, cluster,
                                         rows_per_cta, eps, s);
}

}  // namespace

// Route "stream". x, y (B, N, C) contiguous, 16-byte aligned, one dtype; scale,
// bias (C,) fp32; partial: fp32 scratch of B·ceil(N / rows_per_chunk)·G·2
// elements. A block owns rows_per_chunk rows of one (sample, slab of
// `slice_groups` whole groups), the slab a multiple of 16 bytes.
// C % G == 0, C % 8 == 0, C <= 4096, G <= 256, B <= 65535, rows_per_chunk >= 1.
// Returns cudaGetLastError() after the launches (or the first failing call).
extern "C" int udt_groupnorm_silu_stream(const void* x, const void* scale, const void* bias,
                                         void* partial, void* y, int B, int N, int C, int G,
                                         int slice_groups, int rows_per_chunk, float eps,
                                         int with_silu, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || C <= 0 || G <= 0 || G > kMaxGroups || C % G != 0 ||
      C % 8 != 0 || C > kMaxChannels)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float2* p = static_cast<float2*>(partial);
  if (dtype == udt::kBFloat16)
    return launch_stream<bf16>(x, sc, bi, p, y, B, N, C, G, slice_groups, rows_per_chunk, eps,
                               with_silu, s);
  if (dtype == udt::kFloat32)
    return launch_stream<float>(x, sc, bi, p, y, B, N, C, G, slice_groups, rows_per_chunk, eps,
                                with_silu, s);
  return cudaErrorInvalidValue;
}

// Route "cluster". x, y (B, N, C) contiguous, 16-byte aligned, one dtype;
// scale, bias (C,) fp32. A cluster of `cluster` CTAs (<= 8) owns one (sample,
// slice of `slice_groups` groups), each CTA `rows_per_cta` rows of it, all of
// them at least one row; the slice a multiple of 16 bytes and at most
// kThreads / 2 vectors of 16 bytes wide; the CTA's shared memory
// (ClusterLayout) within 227 KB. One launch, no scratch.
// Returns cudaGetLastError() after the launch (or the first failing call).
extern "C" int udt_groupnorm_silu_cluster(const void* x, const void* scale, const void* bias,
                                          void* y, int B, int N, int C, int G, int slice_groups,
                                          int cluster, int rows_per_cta, float eps, int with_silu,
                                          int dtype, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || C <= 0 || G <= 0 || G > kMaxGroups || C % G != 0 ||
      C % 8 != 0 || C > kMaxChannels)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == udt::kBFloat16)
    return launch_cluster<bf16>(x, sc, bi, y, B, N, C, G, slice_groups, cluster, rows_per_cta, eps,
                                with_silu, s);
  if (dtype == udt::kFloat32)
    return launch_cluster<float>(x, sc, bi, y, B, N, C, G, slice_groups, cluster, rows_per_cta,
                                 eps, with_silu, s);
  return cudaErrorInvalidValue;
}
