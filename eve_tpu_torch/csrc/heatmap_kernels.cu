// Hopper kernels for the two heatmap ops of the EVE pipeline.
//
// Built by eve_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes by
// eve_tpu_torch/kernels/heatmap_kernels.py. No --use_fast_math: both
// kernels use the full-precision expf, and the render keeps the plain
// version's rounding (no fused multiply-add) so that the two agree bit for
// bit.
//
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns the launch's cudaError_t (or
// cudaGetLastError()) so that a refused launch raises in the Python
// wrapper.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSigmas = 4;
constexpr int kMaxCluster = 8;

// The render's warps each stage up to this many bytes of their rows at a
// time, in two stages, for one TMA bulk store each.
constexpr int kWarpChunkBytes = 2048;

// Rows of `row_bytes` a render warp stage holds (at least one).
__host__ __device__ __forceinline__ int chunk_rows_for(int row_bytes) {
  return row_bytes < kWarpChunkBytes ? kWarpChunkBytes / row_bytes : 1;
}

// The soft-argmax's CTAs load their rows in chunks of up to this many bytes
// (whole rows), two stages in flight; a thread holds its quads of a chunk
// in registers.
constexpr int kSamStageBytes = 32 * 1024;
constexpr int kSamQuadsPerThread = kSamStageBytes / 16 / kThreads;

// ---------------------------------------------------------------------------
// Gaussian heatmap render, one launch for up to four sigmas.
//
// Replaces eve_tpu/kernels/heatmap_kernels.py:38 pallas_make_heatmaps (body
// _render_kernel, :28). Output (S, N, H, W): map (s, n) is
// exp(alpha_s * ((x - cx_n)^2 + (y - cy_n)^2)) + 1e-8, times multiplier[n]
// when one is given, so each sigma's maps are one contiguous (N, H, W) view.
//
// What bounds it on the card: by bytes, the writes (36,864 bytes a 72 x 128
// map against 8 bytes read); but at the serving shape (80 maps, 2.95 MB)
// the launch floor (an empty kernel of the same grid) and the issue of each
// pixel's arithmetic (one expf, a few adds and multiplies) on the SMs take
// longer than the writes. Design:
// - A CTA renders `rows` rows of one (sigma, map); the host sizes it so the
//   grid is about two CTAs an SM. The index arithmetic is per CTA and per
//   warp, not per pixel: each lane owns fixed column quads, computes their
//   (x - cx)^2 once, and walks its warp's rows.
// - Each warp owns a contiguous share of the CTA's rows and renders up to
//   kWarpChunkBytes of them into a shared stage; after a proxy fence, lane
//   0 hands the chunk to the copy engine as one TMA bulk store, and the
//   warp renders the next chunk into its other stage while the store
//   drains, waiting (wait_group.read) only before a stage is reused. No
//   CTA-wide barrier is needed.
// - The expression keeps the plain version's rounding (__fmul_rn /
//   __fadd_rn, no contraction into fma) so the two agree bit for bit, and
//   the multiplier is a multiply, so a NaN centre under a zero multiplier
//   gives NaN, as `hm * mask` does.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
render_heatmaps_kernel(const float* __restrict__ centres,
                       const float* __restrict__ multiplier,
                       float* __restrict__ out, int n, int h, int w,
                       float4 alphas, float scale_x, float scale_y, int rows,
                       int blocks_per_map) {
  extern __shared__ __align__(128) float4 s_stage[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int quads_per_row = w >> 2;
  const int chunk_rows = chunk_rows_for(w * 4);
  const int stage_quads = chunk_rows * quads_per_row;
  float4* stages = s_stage + 2 * warp * stage_quads;

  // This CTA's (sigma, map) and rows; this warp's share of them.
  const int sn = blockIdx.x / blocks_per_map;
  const int y0 = (blockIdx.x - sn * blocks_per_map) * rows;
  const int cta_rows = min(rows, h - y0);
  const int wy0 = y0 + cta_rows * warp / kWarps;
  const int wy1 = y0 + cta_rows * (warp + 1) / kWarps;
  const int sigma = sn / n;
  const int map = sn - sigma * n;
  const float alpha = sigma == 0   ? alphas.x
                      : sigma == 1 ? alphas.y
                      : sigma == 2 ? alphas.z
                                   : alphas.w;
  const float cx = __fmul_rn(centres[2 * map], scale_x);
  const float cy = __fmul_rn(centres[2 * map + 1], scale_y);
  const float factor = multiplier != nullptr ? multiplier[map] : 1.f;
  float* dst = out + static_cast<size_t>(sn) * h * w;

  // (x - cx)^2 of this lane's first column quad; lanes of rows wider than
  // 128 columns recompute the others.
  float dx2_first[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float dx = __fsub_rn(static_cast<float>(4 * lane + i), cx);
    dx2_first[i] = __fmul_rn(dx, dx);
  }
  int k = 0;
  for (int ya = wy0; ya < wy1; ya += chunk_rows, ++k) {
    const int nrows = min(chunk_rows, wy1 - ya);
    float4* stage = stages + (k & 1) * stage_quads;
    if (k >= 2) {
      // The store issued from this stage two chunks ago has read it.
      if (lane == 0) eve::bulk_wait_read<1>();
      __syncwarp();
    }
    for (int r = 0; r < nrows; ++r) {
      const float dy = __fsub_rn(static_cast<float>(ya + r), cy);
      const float dy2 = __fmul_rn(dy, dy);
      for (int cq = lane; cq < quads_per_row; cq += 32) {
        float dx2[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (cq == lane) {
            dx2[i] = dx2_first[i];
          } else {
            const float dx = __fsub_rn(static_cast<float>(4 * cq + i), cx);
            dx2[i] = __fmul_rn(dx, dx);
          }
        }
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i] = __fadd_rn(expf(__fmul_rn(alpha, __fadd_rn(dy2, dx2[i]))),
                           1e-8f);
          if (multiplier != nullptr) v[i] = __fmul_rn(v[i], factor);
        }
        stage[r * quads_per_row + cq] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    eve::fence_proxy_async_smem();
    __syncwarp();
    if (lane == 0) {
      eve::bulk_store(dst + static_cast<size_t>(ya) * w, stage,
                      static_cast<uint32_t>(nrows * w) * 4u);
      eve::bulk_commit();
    }
  }
  // Shared memory must outlive the stores that read it.
  if (lane == 0) eve::bulk_wait_read<0>();
}

// ---------------------------------------------------------------------------
// Soft-argmax.
//
// Replaces eve_tpu/kernels/heatmap_kernels.py:99 pallas_soft_argmax (body
// _softargmax_kernel, :75): a beta softmax over each map, its expectation
// against linspace(0, 1) grids, scaled to the screen and clamped.
//
// What bounds it on the card: by bytes, reading the map (36,864 bytes a
// 72 x 128 map against 8 bytes written); but at the serving shape (80 maps)
// the launch floor and the latency of one CTA's chain (copy in, max, exp,
// sums, combine) set the time. One CTA a map would leave 52 of the 132 SMs
// idle. Design:
// - A thread-block cluster of C CTAs a map (the wrapper picks C in
//   {1, 2, 4, 8} so that N * C covers the SMs); each CTA takes a
//   contiguous slice of whole rows.
// - Thread 0 loads the slice with TMA bulk copies, in chunks of up to
//   kSamStageBytes through two stages of shared memory, each completing on
//   its own mbarrier; both first chunks are in flight at once, and a slice
//   larger than two stages loops, so any map size is taken. The map is
//   read from device memory once.
// - Each thread reads its quads of a chunk from shared memory once, into
//   registers; each warp takes its own max m (shuffles, no CTA barrier),
//   then sum p, sum p*col and sum p*row with p = exp(beta * (x - m)),
//   rescaled by exp(beta * dm) when m grows. Warp 0 merges the eight warp
//   partials: one max, one rescale each, then plain sums.
// - Cluster combine, pushed: each CTA but rank 0 writes its partial into
//   rank 0's shared memory with st.async, which completes on an mbarrier of
//   rank 0. Rank 0 waits on that barrier alone, merges, divides, scales,
//   clamps and writes. A relaxed cluster arrive at the start, waited on
//   only by the pushing thread, orders that barrier's init before the
//   pushes; no CTA reads another's shared memory, so none has to outlive a
//   peer.
// ---------------------------------------------------------------------------
struct Partial {
  float m, t, sx, sy;  // max, sum p, sum p*col, sum p*row
};

__device__ __forceinline__ Partial to_partial(float4 v) {
  return Partial{v.x, v.y, v.z, v.w};
}

// Merges the partials of lanes 0..7 (the rest empty) into every lane of
// the eight: one max, one rescale a lane, then plain sums.
__device__ __forceinline__ void merge_lanes8(Partial& p, float beta) {
  float m = p.m;
#pragma unroll
  for (int o = 4; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float f = p.m == -INFINITY ? 0.f : expf(beta * (p.m - m));
  p.t *= f;
  p.sx *= f;
  p.sy *= f;
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) {
    p.t += __shfl_xor_sync(0xffffffffu, p.t, o);
    p.sx += __shfl_xor_sync(0xffffffffu, p.sx, o);
    p.sy += __shfl_xor_sync(0xffffffffu, p.sy, o);
  }
  p.m = m;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows of a soft-argmax chunk, for rows of `row_bytes` and a CTA slice of
// at most `slice_rows` rows.
__host__ __device__ __forceinline__ int sam_chunk_rows(int row_bytes,
                                                       int slice_rows) {
  const int rows = row_bytes < kSamStageBytes ? kSamStageBytes / row_bytes : 1;
  return rows < slice_rows ? rows : slice_rows;
}

__global__ void __launch_bounds__(kThreads)
soft_argmax_kernel(const float* __restrict__ heatmaps, float* __restrict__ out,
                   int h, int w, float beta, float screen_w, float screen_h) {
  extern __shared__ __align__(128) float4 s_stage[];
  __shared__ __align__(8) uint64_t s_full[2];
  __shared__ __align__(8) uint64_t s_recv;  // rank 0: the peers' partials
  __shared__ float4 s_peer[kMaxCluster];
  __shared__ float4 s_warp[kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int map = blockIdx.x / c;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int quads_per_row = w >> 2;

  // This CTA's rows of the map, and its chunks.
  const int r0 = h * rank / c;
  const int slice_rows = h * (rank + 1) / c - r0;
  const int chunk_rows = sam_chunk_rows(w * 4, (h + c - 1) / c);
  const int nchunks = (slice_rows + chunk_rows - 1) / chunk_rows;
  const int stage_quads = chunk_rows * quads_per_row;
  const float* src = heatmaps + (static_cast<size_t>(map) * h + r0) * w;

  auto issue = [&](int k) {
    const int nrows = min(chunk_rows, slice_rows - k * chunk_rows);
    const uint32_t bytes = static_cast<uint32_t>(nrows * w) * 4u;
    eve::mbar_arrive_expect_tx(&s_full[k & 1], bytes);
    eve::bulk_load(s_stage + (k & 1) * stage_quads,
                   src + static_cast<size_t>(k) * chunk_rows * w, bytes,
                   &s_full[k & 1]);
  };
  const bool peers = c > 1;
  if (tid == 0) {
    eve::mbar_init(&s_full[0], 1);
    eve::mbar_init(&s_full[1], 1);
    if (peers && rank == 0) eve::mbar_init(&s_recv, 1);
    eve::fence_mbar_init();
    if (peers && rank == 0)
      eve::mbar_arrive_expect_tx(&s_recv, static_cast<uint32_t>(c - 1) * 16u);
    for (int k = 0; k < min(nchunks, 2); ++k) issue(k);
  }
  // Published with it: s_recv's init (rank 0), for the pushes at the end.
  if (peers) eve::cluster_arrive_relaxed();
  __syncthreads();

  Partial acc{-INFINITY, 0.f, 0.f, 0.f};
  for (int k = 0; k < nchunks; ++k) {
    const int nrows = min(chunk_rows, slice_rows - k * chunk_rows);
    const int row0 = r0 + k * chunk_rows;
    const float4* stage = s_stage + (k & 1) * stage_quads;
    eve::mbar_wait(&s_full[k & 1], (k >> 1) & 1);
    // This thread's quads of the chunk, held in registers: one read of
    // shared memory, and every exp independent of the others.
    const int nquads = nrows * quads_per_row;
    float4 v[kSamQuadsPerThread];
    float cm = -INFINITY;
#pragma unroll
    for (int j = 0; j < kSamQuadsPerThread; ++j) {
      const int q = tid + j * kThreads;
      v[j] = q < nquads ? stage[q] : make_float4(-INFINITY, -INFINITY,
                                                 -INFINITY, -INFINITY);
      cm = fmaxf(cm, fmaxf(fmaxf(v[j].x, v[j].y), fmaxf(v[j].z, v[j].w)));
    }
    cm = warp_max(cm);
    if (cm > acc.m) {
      const float f = expf(beta * (acc.m - cm));
      acc.t *= f;
      acc.sx *= f;
      acc.sy *= f;
      acc.m = cm;
    }
#pragma unroll
    for (int j = 0; j < kSamQuadsPerThread; ++j) {
      const int q = tid + j * kThreads;
      if (q < nquads) {
        const int r = q / quads_per_row;
        const float col = static_cast<float>(4 * (q - r * quads_per_row));
        const float p0 = expf(beta * (v[j].x - acc.m));
        const float p1 = expf(beta * (v[j].y - acc.m));
        const float p2 = expf(beta * (v[j].z - acc.m));
        const float p3 = expf(beta * (v[j].w - acc.m));
        const float p = (p0 + p1) + (p2 + p3);
        acc.t += p;
        acc.sx += p * col + (p1 + 2.f * p2 + 3.f * p3);
        acc.sy += p * static_cast<float>(row0 + r);
      }
    }
    if (k + 2 < nchunks) {
      __syncthreads();  // the stage has been read: refill it
      if (tid == 0) issue(k + 2);
    }
  }
  acc.t = warp_sum(acc.t);
  acc.sx = warp_sum(acc.sx);
  acc.sy = warp_sum(acc.sy);
  if (lane == 0) s_warp[warp] = make_float4(acc.m, acc.t, acc.sx, acc.sy);
  __syncthreads();
  if (warp != 0) return;

  Partial p = lane < kWarps ? to_partial(s_warp[lane])
                            : Partial{-INFINITY, 0.f, 0.f, 0.f};
  merge_lanes8(p, beta);
  if (peers && rank != 0) {
    if (lane == 0) {
      eve::cluster_wait_acquire();  // rank 0's s_recv is initialised
      eve::st_async_f4(eve::cluster_map(&s_peer[rank], 0),
                       make_float4(p.m, p.t, p.sx, p.sy),
                       eve::cluster_map(&s_recv, 0));
    }
    return;
  }
  if (peers) {
    eve::mbar_wait(&s_recv, 0);
    if (lane != 0)
      p = lane < c ? to_partial(s_peer[lane])
                   : Partial{-INFINITY, 0.f, 0.f, 0.f};
    merge_lanes8(p, beta);
  }
  if (lane == 0) {
    // Expectation over linspace(0, 1, w) x linspace(0, 1, h), to screen px.
    const float x = p.sx / (p.t * static_cast<float>(w - 1)) * screen_w;
    const float y = p.sy / (p.t * static_cast<float>(h - 1)) * screen_h;
    out[2 * map] = fminf(fmaxf(x, 0.f), screen_w);
    out[2 * map + 1] = fminf(fmaxf(y, 0.f), screen_h);
  }
}

// An empty kernel: the launch floor of a chain of launches, at a grid and
// cluster shape of the caller's choosing.
__global__ void empty_kernel() {}

bool misaligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) != 0;
}

bool bad_cluster(int cluster) {
  return cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0;
}

// Dynamic shared memory of a render launch: two stages a warp.
long long render_shared_bytes(int w) {
  return 2LL * kWarps * chunk_rows_for(w * 4) * w * 4;
}

// Dynamic shared memory of a soft-argmax launch: up to two chunk stages.
long long sam_shared_bytes(int h, int w, int cluster) {
  const int slice_rows = (h + cluster - 1) / cluster;
  const int chunk_rows = sam_chunk_rows(w * 4, slice_rows);
  const int stages = (slice_rows + chunk_rows - 1) / chunk_rows > 1 ? 2 : 1;
  return static_cast<long long>(stages) * chunk_rows * w * 4;
}

constexpr int kMaxSharedBytes = 227 * 1024;

// Above 48 KB a kernel's dynamic shared memory needs an opt-in.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int ctas, int cluster,
                           int smem, void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// centres: (n, 2) float32; multiplier: (n,) float32 or null; out: (s, n, h,
// w) float32, 16-byte aligned. 1 <= s <= 4 (alpha0..alpha{s-1} are read),
// w % 4 == 0. rows: rows of one map a CTA renders.
int eve_render_heatmaps(const void* centres, const void* multiplier, void* out,
                        int n, int s, int h, int w, float alpha0, float alpha1,
                        float alpha2, float alpha3, float scale_x,
                        float scale_y, int rows, int device, void* stream) {
  if (n <= 0) return 0;
  if (s < 1 || s > kMaxSigmas || h <= 0 || w <= 0 || (w & 3) != 0 ||
      rows < 1 || static_cast<long long>(s) * n * h * w > INT_MAX ||
      render_shared_bytes(w) > kMaxSharedBytes || misaligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(render_shared_bytes(w));
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_shared(render_heatmaps_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows > h) rows = h;
  const int blocks_per_map = (h + rows - 1) / rows;
  render_heatmaps_kernel<<<s * n * blocks_per_map, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(centres),
      static_cast<const float*>(multiplier), static_cast<float*>(out), n, h,
      w, make_float4(alpha0, alpha1, alpha2, alpha3), scale_x, scale_y, rows,
      blocks_per_map);
  return static_cast<int>(cudaGetLastError());
}

// heatmaps: (n, h, w) float32, 16-byte aligned; out: (n, 2) float32.
// w % 4 == 0, 4 <= w <= 8192 (a row fits a stage), h >= 2; cluster in
// {1, 2, 4, 8} CTAs a map.
int eve_soft_argmax(const void* heatmaps, void* out, int n, int h, int w,
                    float beta, float screen_w, float screen_h, int cluster,
                    int device, void* stream) {
  if (n <= 0) return 0;
  if (h < 2 || w < 4 || (w & 3) != 0 || w * 4 > kSamStageBytes ||
      bad_cluster(cluster) || static_cast<long long>(h) * w > INT_MAX ||
      static_cast<long long>(n) * cluster > INT_MAX || misaligned(heatmaps))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sam_shared_bytes(h, w, cluster));
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_shared(soft_argmax_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_cluster(
      soft_argmax_kernel, n * cluster, cluster, smem, stream,
      static_cast<const float*>(heatmaps), static_cast<float*>(out), h, w,
      beta, screen_w, screen_h));
}

// ctas CTAs of 256 threads, in clusters of `cluster`, doing nothing.
int eve_empty_kernel(int ctas, int cluster, int device, void* stream) {
  if (ctas < 1 || bad_cluster(cluster) || ctas % cluster != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cluster == 1) {
    empty_kernel<<<ctas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(
      launch_cluster(empty_kernel, ctas, cluster, 0, stream));
}

}  // extern "C"
