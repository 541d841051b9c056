// Hopper kernels for the two heatmap ops of the EVE pipeline.
//
// Built by eve_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes by
// eve_tpu_torch/kernels/heatmap_kernels.py. No --use_fast_math: both
// kernels use the full-precision expf, and the render keeps the plain
// version's rounding (no fused multiply-add) so that the two agree to a
// few ulp.
//
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so that a refused
// launch raises in the Python wrapper.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Soft-argmax keeps its whole map in registers: at most this many float4
// per thread, which covers maps of up to 256 * 9 * 4 = 9216 pixels (the
// 72 x 128 heatmap exactly).
constexpr int kSoftArgmaxVecs = 9;

// ---------------------------------------------------------------------------
// Gaussian heatmap render.
//
// Replaces eve_tpu/kernels/heatmap_kernels.py:38 pallas_make_heatmaps (body
// _render_kernel, :28). What bounds it on the card: the output writes, 36,864
// bytes per 72 x 128 map against 8 bytes of input; the arithmetic (one expf a
// pixel) is far below the card's rate. Design: one block of 256 threads per
// (map, 1024 pixels), i.e. per 8 rows of a 128-wide map; each thread computes
// four adjacent columns and stores them as one float4, so a warp writes one
// 512-byte row, coalesced. Each block reads its own centre (the TPU kernel's
// scalar prefetch has no counterpart to carry over).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
render_heatmaps_kernel(const float* __restrict__ centres,
                       float* __restrict__ out, int blocks_per_map, int h,
                       int w, float alpha, float scale_x, float scale_y) {
  const int map = blockIdx.x / blocks_per_map;
  const int part = blockIdx.x - map * blocks_per_map;
  const int quad = part * kThreads + threadIdx.x;
  const int quads = (h * w) >> 2;
  if (quad >= quads) return;
  const float cx = __fmul_rn(centres[2 * map], scale_x);
  const float cy = __fmul_rn(centres[2 * map + 1], scale_y);
  const int idx = quad << 2;
  const int row = idx / w;
  const int col = idx - row * w;
  const float dy = __fsub_rn(static_cast<float>(row), cy);
  const float dy2 = __fmul_rn(dy, dy);
  float r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float dx = __fsub_rn(static_cast<float>(col + k), cx);
    const float d2 = __fadd_rn(dy2, __fmul_rn(dx, dx));
    r[k] = __fadd_rn(expf(__fmul_rn(alpha, d2)), 1e-8f);
  }
  float4* dst = reinterpret_cast<float4*>(out + static_cast<size_t>(map) * h * w);
  dst[quad] = make_float4(r[0], r[1], r[2], r[3]);
}

// ---------------------------------------------------------------------------
// Soft-argmax.
//
// Replaces eve_tpu/kernels/heatmap_kernels.py:99 pallas_soft_argmax (body
// _softargmax_kernel, :75). What bounds it on the card: reading the map,
// 36,864 bytes per 72 x 128 map against 8 bytes written. Design: one block
// of 256 threads per map; the map is read from device memory once, as
// float4, into registers (36 floats a thread); a block max (warp shuffles,
// then shared memory across the 8 warps) gives m; one pass over the
// registers forms sum p, sum p*col and sum p*row with p = exp(beta*(x-m)),
// which are block-reduced the same way; thread 0 scales, clamps and writes
// the two floats. The TPU kernel's padding of N to blocks of 16 maps was a
// TPU block constraint and has no counterpart.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
soft_argmax_kernel(const float* __restrict__ heatmaps, float* __restrict__ out,
                   int h, int w, float beta, float screen_w, float screen_h) {
  __shared__ float s_max[kWarps];
  __shared__ float s_sum[3][kWarps];
  const int map = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int quads = (h * w) >> 2;
  const float4* src =
      reinterpret_cast<const float4*>(heatmaps + static_cast<size_t>(map) * h * w);

  float4 v[kSoftArgmaxVecs];
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < kSoftArgmaxVecs; ++k) {
    const int q = tid + k * kThreads;
    if (q < quads) {
      v[k] = src[q];
      m = fmaxf(m, fmaxf(fmaxf(v[k].x, v[k].y), fmaxf(v[k].z, v[k].w)));
    }
  }
  m = warp_max(m);
  if (lane == 0) s_max[warp] = m;
  __syncthreads();
  m = s_max[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) m = fmaxf(m, s_max[i]);

  float total = 0.f, sum_col = 0.f, sum_row = 0.f;
#pragma unroll
  for (int k = 0; k < kSoftArgmaxVecs; ++k) {
    const int q = tid + k * kThreads;
    if (q < quads) {
      const int idx = q << 2;
      const int row = idx / w;
      const float col = static_cast<float>(idx - row * w);
      const float p0 = expf(beta * (v[k].x - m));
      const float p1 = expf(beta * (v[k].y - m));
      const float p2 = expf(beta * (v[k].z - m));
      const float p3 = expf(beta * (v[k].w - m));
      const float p = (p0 + p1) + (p2 + p3);
      total += p;
      sum_col += p * col + (p1 + 2.f * p2 + 3.f * p3);
      sum_row += p * static_cast<float>(row);
    }
  }
  total = warp_sum(total);
  sum_col = warp_sum(sum_col);
  sum_row = warp_sum(sum_row);
  if (lane == 0) {
    s_sum[0][warp] = total;
    s_sum[1][warp] = sum_col;
    s_sum[2][warp] = sum_row;
  }
  __syncthreads();
  if (tid == 0) {
    float t = 0.f, sc = 0.f, sr = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      t += s_sum[0][i];
      sc += s_sum[1][i];
      sr += s_sum[2][i];
    }
    // Expectation over linspace(0, 1, w) x linspace(0, 1, h), to screen px.
    const float x = sc / (t * static_cast<float>(w - 1)) * screen_w;
    const float y = sr / (t * static_cast<float>(h - 1)) * screen_h;
    out[2 * map] = fminf(fmaxf(x, 0.f), screen_w);
    out[2 * map + 1] = fminf(fmaxf(y, 0.f), screen_h);
  }
}

bool misaligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) != 0;
}

}  // namespace

extern "C" {

// centres: (n, 2) float32; out: (n, h, w) float32. w % 4 == 0.
int eve_render_heatmaps(const void* centres, void* out, int n, int h, int w,
                        float alpha, float scale_x, float scale_y, int device,
                        void* stream) {
  if (n <= 0) return 0;
  if (h <= 0 || w <= 0 || (w & 3) != 0 || misaligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int quads = (h * w) >> 2;
  const int blocks_per_map = (quads + kThreads - 1) / kThreads;
  render_heatmaps_kernel<<<n * blocks_per_map, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(centres), static_cast<float*>(out),
      blocks_per_map, h, w, alpha, scale_x, scale_y);
  return static_cast<int>(cudaGetLastError());
}

// heatmaps: (n, h, w) float32; out: (n, 2) float32. w % 4 == 0 and
// h * w <= 4 * 256 * 9.
int eve_soft_argmax(const void* heatmaps, void* out, int n, int h, int w,
                    float beta, float screen_w, float screen_h, int device,
                    void* stream) {
  if (n <= 0) return 0;
  if (h < 2 || w < 2 || (w & 3) != 0 || h * w > 4 * kThreads * kSoftArgmaxVecs ||
      misaligned(heatmaps))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  soft_argmax_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(heatmaps), static_cast<float*>(out), h, w, beta,
      screen_w, screen_h);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
