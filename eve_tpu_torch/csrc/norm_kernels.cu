// Hopper kernels for the bf16 instance norm of the EVE networks, with the
// activation that follows it folded in.
//
// Built by eve_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes by
// eve_tpu_torch/kernels/norm_kernels.py. No --use_fast_math, and no fused
// multiply-add where the plain version rounds twice: the kernels keep the
// plain version's roundings, so the two agree bit for bit except where the
// order of a plane's float32 sums tips the bf16 rounding of its scale or
// shift.
//
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns the launch's cudaError_t (or
// cudaGetLastError()) so that a refused launch raises in the Python
// wrapper.
//
// ---------------------------------------------------------------------------
// Instance norm + activation, one launch a call.
//
// Replaces no Pallas kernel. eve_tpu's instance_norm
// (eve_tpu/models/layers.py:29) is plain jnp, and XLA fuses it with the ReLU
// or LeakyReLU after it into one pass over the map. PyTorch runs the same
// bf16 form eagerly as about 16 kernels and one more for the activation: a
// float32 cast, two mean reductions, a square, two broadcast bf16 passes
// and the activation's pass, some 34 bytes of device memory an element.
//
// What it computes, for each (n, c) plane of HW values x, exactly the plain
// version's bf16 form (norm_kernels.instance_norm_plain):
//   mean = sum(x) * inv_hw, ex2 = sum(x * x) * inv_hw (float32);
//   scale = rsqrt(max(ex2 - mean^2, 0) + eps) [* weight[c]];
//   shift = -mean * scale [+ bias[c]];
//   y = bf16(bf16(x * bf16(scale)) + bf16(shift)), then none, ReLU, or
//   LeakyReLU with `slope` (a bf16 value): bf16(y * slope) where y <= 0.
// A 1x1 plane gives bf16(bias[c]) (or 0), then the activation.
//
// What bounds it on the card: bytes. One read and one write of a bf16
// plane is 4 bytes an element, against ~10 float32 operations: about 2.5
// operations a byte, far below the card's ~20 float32 operations a byte.
// Design:
// - Every plane of the model fits on chip (at most 72 x 128 = 9,216 values,
//   18 KB), so a plane is read once into registers, reduced, and written
//   from the same registers: exactly one read and one write of device
//   memory an element.
// - 16-byte vector loads and stores (8 bf16 values). The threads that share
//   a plane take its vectors round-robin, so neighbouring threads read
//   neighbouring addresses; each holds up to kMaxVecs vectors, all loads
//   issued before the first use.
// - The wrapper picks, from HW alone, how many threads share a plane:
//   up to 1,024 values (HW <= 32 * kMaxVecs * 8), a group of 1-32 lanes of
//   a warp, many planes to a CTA, reduced with shuffles and no shared
//   memory (instance_norm_kernel_group); above it, a CTA of 64-1,024
//   threads a plane, reduced with shuffles and one shared-memory step
//   (instance_norm_kernel_block). Every thread of a group or CTA ends with
//   the same sums, summed in the same order, so none needs a broadcast.
// - Any other plane (HW not a multiple of 8, an unaligned tensor, a plane
//   over 32,768 values, a 1x1 map) takes instance_norm_kernel_scalar: a
//   warp a plane, scalar loads, and a second read of the plane for the
//   apply. The model meets it only at 1x1 maps.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kGroupThreads = 256;    // CTA of the group kernel
constexpr int kScalarThreads = 256;   // CTA of the scalar kernel: a warp a plane
constexpr int kMaxBlockThreads = 1024;
constexpr int kMaxVecs = 4;           // 16-byte vectors a thread holds
constexpr int kVec = 8;               // bf16 values a vector

enum Act { kNone = 0, kRelu = 1, kLeaky = 2 };

struct Params {
  const float* weight;  // (channels,) float32 or null
  const float* bias;    // (channels,) float32 or null
  int channels;
  float inv_hw;         // the factor of the plain version's mean
  float eps;
  int act;
  float slope;          // LeakyReLU's negative slope, a bf16 value
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The bf16 pair packed in a 32-bit word, as floats.
__device__ __forceinline__ float lo_of(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_of(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ void accumulate(uint32_t u, float& sum,
                                           float& sumsq) {
  const float a = lo_of(u), b = hi_of(u);
  // A bf16 value's square is exact in float32, so a fused multiply-add
  // rounds the sum once, as a separate add would.
  sum += a;
  sumsq = fmaf(a, a, sumsq);
  sum += b;
  sumsq = fmaf(b, b, sumsq);
}

__device__ __forceinline__ void accumulate(const uint4& v, float& sum,
                                           float& sumsq) {
  accumulate(v.x, sum, sumsq);
  accumulate(v.y, sum, sumsq);
  accumulate(v.z, sum, sumsq);
  accumulate(v.w, sum, sumsq);
}

// The plane's bf16 scale and shift from its float32 sums, with the plain
// version's operations and roundings.
__device__ __forceinline__ void scale_shift(float sum, float sumsq, int c,
                                            const Params& p, float& scale,
                                            float& shift) {
  const float mean = __fmul_rn(sum, p.inv_hw);
  const float ex2 = __fmul_rn(sumsq, p.inv_hw);
  float var = __fsub_rn(ex2, __fmul_rn(mean, mean));
  var = var < 0.f ? 0.f : var;  // clamp(min=0), which keeps a NaN
  float s = rsqrtf(__fadd_rn(var, p.eps));
  if (p.weight != nullptr) s = __fmul_rn(s, p.weight[c]);
  float sh = __fmul_rn(-mean, s);
  if (p.bias != nullptr) sh = __fadd_rn(sh, p.bias[c]);
  scale = round_bf16(s);
  shift = round_bf16(sh);
}

__device__ __forceinline__ float activate(float y, const Params& p) {
  if (p.act == kRelu) return y < 0.f ? 0.f : y;
  if (p.act == kLeaky) return y > 0.f ? y : round_bf16(__fmul_rn(y, p.slope));
  return y;
}

// One element: two bf16 roundings, as x * scale + shift runs in bf16, then
// the activation. The result is a bf16 value held in a float.
__device__ __forceinline__ float apply(float x, float scale, float shift,
                                       const Params& p) {
  const float y = round_bf16(__fmul_rn(x, scale));
  return activate(round_bf16(__fadd_rn(y, shift)), p);
}

__device__ __forceinline__ uint32_t apply(uint32_t u, float scale,
                                          float shift, const Params& p) {
  const float a = apply(lo_of(u), scale, shift, p);
  const float b = apply(hi_of(u), scale, shift, p);
  // Both are bf16 values: their top halves are their bf16 bits.
  return (__float_as_uint(b) & 0xffff0000u) | (__float_as_uint(a) >> 16);
}

__device__ __forceinline__ uint4 apply(const uint4& v, float scale,
                                       float shift, const Params& p) {
  return make_uint4(apply(v.x, scale, shift, p), apply(v.y, scale, shift, p),
                    apply(v.z, scale, shift, p), apply(v.w, scale, shift, p));
}

// Sums over the `lanes` lanes (a power of two, at most 32) of an aligned
// group of a warp; every lane of the warp takes part.
__device__ __forceinline__ void group_sum(float& sum, float& sumsq,
                                          int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sumsq += __shfl_xor_sync(0xffffffffu, sumsq, off);
  }
}

// Planes of up to 32 * V vectors: a group of 2^lanes_log2 lanes a plane,
// each lane V vectors (lane, lane + lanes, ...), kGroupThreads threads a
// CTA.
template <int V>
__global__ void __launch_bounds__(kGroupThreads)
instance_norm_kernel_group(const uint4* __restrict__ x,
                           uint4* __restrict__ y, int planes, int nvec,
                           int lanes_log2, Params p) {
  const int lanes = 1 << lanes_log2;
  const long long t =
      static_cast<long long>(blockIdx.x) * kGroupThreads + threadIdx.x;
  const long long plane = t >> lanes_log2;
  const int lane = static_cast<int>(t & (lanes - 1));
  const bool live = plane < planes;
  const uint4* src = x + plane * nvec;
  uint4 v[V];
  float sum = 0.f, sumsq = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int k = lane + i * lanes;
    v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (live && k < nvec) v[i] = __ldg(src + k);
  }
#pragma unroll
  for (int i = 0; i < V; ++i) accumulate(v[i], sum, sumsq);
  group_sum(sum, sumsq, lanes);
  if (!live) return;
  float scale, shift;
  scale_shift(sum, sumsq, static_cast<int>(plane % p.channels), p, scale,
              shift);
  uint4* dst = y + plane * nvec;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int k = lane + i * lanes;
    if (k < nvec) dst[k] = apply(v[i], scale, shift, p);
  }
}

// Larger planes: a CTA of blockDim.x (a multiple of 32) threads a plane,
// each V vectors.
template <int V>
__global__ void __launch_bounds__(kMaxBlockThreads)
instance_norm_kernel_block(const uint4* __restrict__ x,
                           uint4* __restrict__ y, int nvec, Params p) {
  __shared__ float2 partial[kMaxBlockThreads / 32];
  const long long plane = blockIdx.x;
  const int threads = blockDim.x;
  const uint4* src = x + plane * nvec;
  uint4 v[V];
  float sum = 0.f, sumsq = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int k = threadIdx.x + i * threads;
    v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (k < nvec) v[i] = __ldg(src + k);
  }
#pragma unroll
  for (int i = 0; i < V; ++i) accumulate(v[i], sum, sumsq);
  group_sum(sum, sumsq, 32);
  if ((threadIdx.x & 31) == 0)
    partial[threadIdx.x >> 5] = make_float2(sum, sumsq);
  __syncthreads();
  // Every thread sums the warps' partials in the same order.
  sum = 0.f;
  sumsq = 0.f;
  for (int w = 0; w < threads / 32; ++w) {
    sum += partial[w].x;
    sumsq += partial[w].y;
  }
  float scale, shift;
  scale_shift(sum, sumsq, static_cast<int>(plane % p.channels), p, scale,
              shift);
  uint4* dst = y + plane * nvec;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int k = threadIdx.x + i * threads;
    if (k < nvec) dst[k] = apply(v[i], scale, shift, p);
  }
}

// Any plane: a warp a plane, scalar loads, the plane read twice.
__global__ void __launch_bounds__(kScalarThreads)
instance_norm_kernel_scalar(const __nv_bfloat16* __restrict__ x,
                            __nv_bfloat16* __restrict__ y, int planes,
                            int hw, Params p) {
  const int lane = threadIdx.x & 31;
  const long long plane =
      static_cast<long long>(blockIdx.x) * (kScalarThreads / 32) +
      (threadIdx.x >> 5);
  if (plane >= planes) return;  // the whole warp
  const int c = static_cast<int>(plane % p.channels);
  const __nv_bfloat16* src = x + plane * hw;
  __nv_bfloat16* dst = y + plane * hw;
  if (hw == 1) {
    // A 1x1 map normalises to 0, then the bias, whatever x holds.
    if (lane == 0) {
      const float b = p.bias != nullptr ? round_bf16(p.bias[c]) : 0.f;
      dst[0] = __float2bfloat16_rn(activate(b, p));
    }
    return;
  }
  float sum = 0.f, sumsq = 0.f;
  for (int k = lane; k < hw; k += 32) {
    const float a = __bfloat162float(src[k]);
    sum += a;
    sumsq = fmaf(a, a, sumsq);
  }
  group_sum(sum, sumsq, 32);
  float scale, shift;
  scale_shift(sum, sumsq, c, p, scale, shift);
  for (int k = lane; k < hw; k += 32)
    dst[k] = __float2bfloat16_rn(
        apply(__bfloat162float(src[k]), scale, shift, p));
}

bool misaligned(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) != 0;
}

template <int V>
void launch_group(const void* x, void* y, int planes, int nvec,
                  int lanes_log2, int ctas, const Params& p,
                  cudaStream_t stream) {
  instance_norm_kernel_group<V><<<ctas, kGroupThreads, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), planes, nvec,
      lanes_log2, p);
}

template <int V>
void launch_block(const void* x, void* y, int planes, int nvec, int threads,
                  const Params& p, cudaStream_t stream) {
  instance_norm_kernel_block<V><<<planes, threads, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), nvec, p);
}

}  // namespace

extern "C" {

// x, y: (planes, hw) bf16, contiguous, plane p of channel p % channels;
// weight, bias: (channels,) float32 or null. lanes: threads a plane; vecs:
// 16-byte vectors a thread (1..4), or 0 for the scalar path (a warp a
// plane). With vecs > 0: hw % 8 == 0, x and y 16-byte aligned,
// lanes * vecs * 8 >= hw, and lanes a power of two up to 32 (a group of a
// warp) or a multiple of 32 up to 1024 (a CTA). act: 0 none, 1 ReLU,
// 2 LeakyReLU with `slope`.
int eve_instance_norm(const void* x, void* y, const void* weight,
                      const void* bias, int planes, int channels, int hw,
                      int lanes, int vecs, float inv_hw, float eps, int act,
                      float slope, int device, void* stream) {
  if (planes <= 0) return 0;
  if (channels <= 0 || planes % channels != 0 || hw <= 0 || act < kNone ||
      act > kLeaky || vecs < 0 || vecs > kMaxVecs)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const float*>(weight),
                 static_cast<const float*>(bias), channels, inv_hw, eps, act,
                 slope};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vecs == 0) {
    const int ctas = static_cast<int>(
        (static_cast<long long>(planes) + kScalarThreads / 32 - 1) /
        (kScalarThreads / 32));
    instance_norm_kernel_scalar<<<ctas, kScalarThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        planes, hw, p);
    return static_cast<int>(cudaGetLastError());
  }
  if (hw % kVec != 0 || misaligned(x) || misaligned(y) || lanes < 1 ||
      static_cast<long long>(lanes) * vecs * kVec < hw)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nvec = hw / kVec;
  if (lanes <= 32) {
    if ((lanes & (lanes - 1)) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const long long threads = static_cast<long long>(planes) * lanes;
    const long long ctas = (threads + kGroupThreads - 1) / kGroupThreads;
    if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const int grid = static_cast<int>(ctas);
    int lanes_log2 = 0;
    while ((1 << lanes_log2) < lanes) ++lanes_log2;
    switch (vecs) {
      case 1: launch_group<1>(x, y, planes, nvec, lanes_log2, grid, p, s); break;
      case 2: launch_group<2>(x, y, planes, nvec, lanes_log2, grid, p, s); break;
      case 3: launch_group<3>(x, y, planes, nvec, lanes_log2, grid, p, s); break;
      default: launch_group<4>(x, y, planes, nvec, lanes_log2, grid, p, s);
    }
  } else {
    if (lanes % 32 != 0 || lanes > kMaxBlockThreads)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (vecs) {
      case 1: launch_block<1>(x, y, planes, nvec, lanes, p, s); break;
      case 2: launch_block<2>(x, y, planes, nvec, lanes, p, s); break;
      case 3: launch_block<3>(x, y, planes, nvec, lanes, p, s); break;
      default: launch_block<4>(x, y, planes, nvec, lanes, p, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
