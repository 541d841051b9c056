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
// Two kernels compute it, one for each layout the networks make:
// - instance_norm_kernel_nhwc (below) takes every norm of the bf16 forward
//   on the card, which runs channels-last: bound by bytes (one read and one
//   write of a bf16 value, 4 bytes an element, against ~10 float32
//   operations: about 2.5 operations a byte, far below the card's ~20).
// - instance_norm_kernel_scalar takes any other contiguous (planes, hw)
//   tensor, of any shape or alignment: a warp a plane, scalar loads, and a
//   second read of the plane for the apply. The shipped models meet it only
//   at 1x1 maps (ResNet-18's layer4 at small eyes); a direct NCHW caller, a
//   channel count that is not a multiple of 8 and a map too large for a
//   cluster of the NHWC kernel take it too, at a lower rate.
//
// ---------------------------------------------------------------------------
// The channels-last kernel: instance_norm_kernel_nhwc.
//
// The bf16 EVE forward runs channels-last on the card (cuDNN's bf16
// convolutions are NHWC kernels), so its norms get (N, H, W, C) storage. For
// each sample x is then a row-major (HW, C) matrix, and a plane's statistics
// are a column's sums. The arithmetic and roundings above; only the order
// of a column's float32 sums differs from the plain version's. Design:
// - A CTA takes a slab of one sample: a tile of CT channels (the wrapper
//   picks 32 or more where C allows: rows of 64 bytes or more, since on the
//   card 32-byte rows ran at ~70% of the bytes bound and 16-byte ones under
//   40%) over a run of rows. One thread loads the slab into shared memory
//   as TMA 2-D boxes (up to 256 rows of CT channels), each on its own
//   mbarrier, so the sums start on the first box to land; the threads
//   compute no addresses of device memory.
// - The wrapper keeps a slab near 64 KB, so that three CTAs share an SM
//   and one's loads overlap another's apply and stores. Where a tile's HW
//   rows make more, the rows split across a thread-block cluster of up to
//   8 CTAs (RefineNet's 72 x 128 maps, EyeNet's 64 x 64 stem); each sums
//   its own rows and stores its partial column sums into every CTA of the
//   cluster over distributed shared memory before one cluster barrier,
//   then adds its own copies in rank order, so all hold the same sums and
//   none reads a peer after the barrier (pulling the partials instead
//   needed a second barrier before exit, which cost up to a tenth of the
//   rate). One CTA per SM looping over the work (persistent, a ring of
//   slabs) ran at half the rate: the shared-memory passes need more warps
//   than one CTA holds.
// - Column sums: a thread takes one 16-byte vector column (8 channels) and
//   every (256 / vectors a row)-th row of the slab; shuffles, then one
//   shared-memory step, add the threads of a column.
// - The apply runs in place in shared memory, each pair of channels
//   rounded by one packed conversion, and each box leaves by TMA as soon
//   as it is done: one read and one write of device memory an element.
//   Rows past HW in the last box are zeros on the load (the sums skip
//   them) and are not written on the store.
// ---------------------------------------------------------------------------

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <limits.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kScalarThreads = 256;  // CTA of the scalar kernel: a warp a plane
constexpr int kVec = 8;              // bf16 values a 16-byte vector

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

// Sums over the lanes of a warp.
__device__ __forceinline__ void warp_sum(float& sum, float& sumsq) {
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sumsq += __shfl_xor_sync(0xffffffffu, sumsq, off);
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
    // A bf16 value's square is exact in float32, so a fused multiply-add
    // rounds the sum once, as a separate add would.
    sumsq = fmaf(a, a, sumsq);
  }
  warp_sum(sum, sumsq);
  float scale, shift;
  scale_shift(sum, sumsq, c, p, scale, shift);
  for (int k = lane; k < hw; k += 32)
    dst[k] = __float2bfloat16_rn(
        apply(__bfloat162float(src[k]), scale, shift, p));
}

// ---------------------------------------------------------------------------
// Channels-last
// ---------------------------------------------------------------------------

constexpr int kNhwcThreads = 256;
constexpr int kNhwcWarps = kNhwcThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kMaxClusterTile = 32;  // the widest tile a cluster splits
constexpr int kMaxBoxRows = 256;
constexpr int kMaxBoxes = 40;   // boxes of a CTA's slab
constexpr int kSmemAlign = 128;  // a TMA box's shared-memory address

// A launch's tiling of a sample's (HW, C) matrix.
struct NhwcTiling {
  int hw;        // rows of a sample
  int rows;      // rows a CTA: boxes * box_rows
  int box_rows;  // rows a TMA box, a multiple of 8, at most 256
  int tiles;     // channel tiles: C / CT
  int cluster;   // CTAs sharing a tile's rows; rank r holds rows
                 // [r * rows, (r + 1) * rows)
};

__device__ __forceinline__ void tma_load_3d(void* smem_dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(eve::smem_u32(smem_dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(eve::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* smem_src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(eve::smem_u32(smem_src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The 8 channels of a vector into their sums.
__device__ __forceinline__ void accumulate8(const uint4& v, float* sum,
                                            float* sumsq) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = lo_of(w[i]), b = hi_of(w[i]);
    sum[2 * i] += a;
    sumsq[2 * i] = fmaf(a, a, sumsq[2 * i]);
    sum[2 * i + 1] += b;
    sumsq[2 * i + 1] = fmaf(b, b, sumsq[2 * i + 1]);
  }
}

// apply() on a packed pair of channels with the pair's own scales and
// shifts: the same roundings, each pair rounded by one conversion.
__device__ __forceinline__ uint32_t apply_pair(uint32_t u, float scale_lo,
                                               float shift_lo, float scale_hi,
                                               float shift_hi,
                                               const Params& p) {
  __nv_bfloat162 y = __floats2bfloat162_rn(__fmul_rn(lo_of(u), scale_lo),
                                           __fmul_rn(hi_of(u), scale_hi));
  y = __floats2bfloat162_rn(__fadd_rn(__low2float(y), shift_lo),
                            __fadd_rn(__high2float(y), shift_hi));
  if (p.act != kNone) {
    // The activation of a bf16 value, rounded by the conversion (exact
    // for ReLU; LeakyReLU's product rounded once, as apply() rounds it).
    float a = __low2float(y), b = __high2float(y);
    if (p.act == kRelu) {
      a = a < 0.f ? 0.f : a;
      b = b < 0.f ? 0.f : b;
    } else {
      a = a > 0.f ? a : __fmul_rn(a, p.slope);
      b = b > 0.f ? b : __fmul_rn(b, p.slope);
    }
    y = __floats2bfloat162_rn(a, b);
  }
  return *reinterpret_cast<uint32_t*>(&y);
}

__device__ __forceinline__ uint4 apply8(const uint4& v, const float* scale,
                                        const float* shift, const Params& p) {
  return make_uint4(
      apply_pair(v.x, scale[0], shift[0], scale[1], shift[1], p),
      apply_pair(v.y, scale[2], shift[2], scale[3], shift[3], p),
      apply_pair(v.z, scale[4], shift[4], scale[5], shift[5], p),
      apply_pair(v.w, scale[6], shift[6], scale[7], shift[7], p));
}

// A CTA: one (rows, CT) slab of sample n's channel tile; blockIdx.x =
// (n * tiles + tile) * cluster + rank, the cluster (cluster, 1, 1).
template <int CT>
__global__ void __launch_bounds__(kNhwcThreads)
instance_norm_kernel_nhwc(const __grid_constant__ CUtensorMap in_map,
                          const __grid_constant__ CUtensorMap out_map,
                          NhwcTiling t, Params p) {
  constexpr int kVecs = CT / kVec;  // 16-byte vectors a row of the slab
  constexpr int kRowStep = kNhwcThreads / kVecs;
  // Slot r: rank r's partial column sums (a cluster's tile is at most
  // kMaxClusterTile channels).
  constexpr int kSlots = CT <= kMaxClusterTile ? kMaxCluster : 1;
  __shared__ float2 s_warp[kNhwcWarps][CT];  // (sum, sum of squares)
  __shared__ float2 s_part[kSlots][CT];
  __shared__ float2 s_affine[CT];            // (scale, shift)
  __shared__ __align__(8) uint64_t s_box[kMaxBoxes];
  extern __shared__ unsigned char s_dyn[];
  uint4* slab = reinterpret_cast<uint4*>(
      s_dyn + ((kSmemAlign - (eve::smem_u32(s_dyn) & (kSmemAlign - 1))) &
               (kSmemAlign - 1)));

  const int cluster = t.cluster;
  const int rank = static_cast<int>(blockIdx.x % cluster);
  const int unit = static_cast<int>(blockIdx.x / cluster);
  const int c0 = (unit % t.tiles) * CT;
  const int n = unit / t.tiles;
  const int row0 = rank * t.rows;
  const int valid = min(t.rows, t.hw - row0);  // >= 1 (the host checks)
  const int boxes = (valid + t.box_rows - 1) / t.box_rows;
  const int box_vecs = t.box_rows * kVecs;

  // One barrier a box, so the sums start on the first box to land.
  if (threadIdx.x == 0) {
    for (int b = 0; b < boxes; ++b) eve::mbar_init(&s_box[b], 1);
    eve::fence_mbar_init();
    for (int b = 0; b < boxes; ++b) {
      eve::mbar_arrive_expect_tx(&s_box[b], box_vecs * sizeof(uint4));
      tma_load_3d(slab + b * box_vecs, &in_map, c0, row0 + b * t.box_rows,
                  n, &s_box[b]);
    }
  }
  // Its wait, before the first store into a peer, holds until every CTA of
  // the cluster has started (distributed shared memory is only valid
  // then); the CTAs start together, so it costs no straggler's time.
  if (cluster > 1) eve::cluster_arrive_relaxed();
  __syncthreads();

  // Column sums of the valid rows, box by box as they land.
  const int j = threadIdx.x % kVecs;
  const int lane = threadIdx.x & 31;
  float sum[kVec], sumsq[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) sum[i] = sumsq[i] = 0.f;
  for (int b = 0; b < boxes; ++b) {
    eve::mbar_wait(&s_box[b], 0);
    const int end = min(valid, (b + 1) * t.box_rows);
#pragma unroll 4
    for (int r = b * t.box_rows + threadIdx.x / kVecs; r < end;
         r += kRowStep)
      accumulate8(slab[r * kVecs + j], sum, sumsq);
  }
  // The lanes of a warp that share column j: lane % kVecs == j.
#pragma unroll
  for (int off = kVecs; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], off);
      sumsq[i] += __shfl_xor_sync(0xffffffffu, sumsq[i], off);
    }
  }
  if (lane < kVecs) {
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      s_warp[threadIdx.x >> 5][j * kVec + i] = make_float2(sum[i], sumsq[i]);
  }
  __syncthreads();
  const int c = threadIdx.x;
  float2 total = make_float2(0.f, 0.f);
  if (c < CT) {
    for (int w = 0; w < kNhwcWarps; ++w) {
      total.x += s_warp[w][c].x;
      total.y += s_warp[w][c].y;
    }
  }
  if (cluster > 1) {
    // Every CTA stores its partials into slot `rank` of every CTA of the
    // cluster over distributed shared memory; past the barrier each adds
    // its own slots in rank order, the same sums in each, and no CTA
    // touches a peer's memory again, so any may exit when done.
    cg::cluster_group group = cg::this_cluster();
    eve::cluster_wait_acquire();  // every CTA of the cluster has started
    if (c < CT) {
      for (int r = 0; r < cluster; ++r)
        group.map_shared_rank(&s_part[rank][0], r)[c] = total;
    }
    group.sync();  // every partial is in every CTA's slots
    if (c < CT) {
      total = make_float2(0.f, 0.f);
      for (int r = 0; r < cluster; ++r) {
        total.x += s_part[r][c].x;
        total.y += s_part[r][c].y;
      }
    }
  }
  if (c < CT) {
    float scale, shift;
    scale_shift(total.x, total.y, c0 + c, p, scale, shift);
    s_affine[c] = make_float2(scale, shift);
  }
  __syncthreads();

  float scale[kVec], shift[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float2 a = s_affine[j * kVec + i];
    scale[i] = a.x;
    shift[i] = a.y;
  }
  // Apply in place, box by box; each box leaves as soon as it is done.
  for (int b = 0; b < boxes; ++b) {
    const int end = min(valid, (b + 1) * t.box_rows);
#pragma unroll 4
    for (int r = b * t.box_rows + threadIdx.x / kVecs; r < end;
         r += kRowStep) {
      uint4* v = slab + r * kVecs + j;
      *v = apply8(*v, scale, shift, p);
    }
    eve::fence_proxy_async_smem();
    __syncthreads();
    if (threadIdx.x == 0) {
      tma_store_3d(&out_map, slab + b * box_vecs, c0, row0 + b * t.box_rows,
                   n);
      eve::bulk_commit();
    }
  }
  if (threadIdx.x == 0) eve::bulk_wait_read<0>();
}

PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                         12000, cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  return encode;
}

// A (N, HW, C) bf16 tensor's map, boxes of ct channels x box_rows rows.
bool nhwc_map(CUtensorMap* map, const void* base, int n, int hw,
              int channels, int ct, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(channels),
                              static_cast<cuuint64_t>(hw),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(channels) * 2,
      static_cast<cuuint64_t>(channels) * 2 * static_cast<cuuint64_t>(hw)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(ct),
                             static_cast<cuuint32_t>(box_rows), 1u};
  const cuuint32_t unit[3] = {1u, 1u, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int CT>
cudaError_t launch_nhwc(const CUtensorMap& in_map, const CUtensorMap& out_map,
                        const NhwcTiling& t, int ctas, const Params& p,
                        cudaStream_t stream) {
  // Past 48 KB with the static arrays (20 KB at CT = 256), a launch needs
  // the opt-in. It holds for the current device only, so it is made at
  // every launch (about a microsecond), as the heatmap kernels make theirs.
  const int smem = t.rows * CT * 2 + kSmemAlign;
  cudaError_t err = cudaFuncSetAttribute(
      instance_norm_kernel_nhwc<CT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(kNhwcThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(t.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = t.cluster > 1 ? 1 : 0;  // a plain launch for one CTA
  err = cudaLaunchKernelEx(
      &cfg, instance_norm_kernel_nhwc<CT>, in_map, out_map, t, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool misaligned(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) != 0;
}

}  // namespace

extern "C" {

// x, y: (planes, hw) bf16, contiguous, plane p of channel p % channels;
// weight, bias: (channels,) float32 or null. A warp a plane. act: 0 none,
// 1 ReLU, 2 LeakyReLU with `slope`.
int eve_instance_norm(const void* x, void* y, const void* weight,
                      const void* bias, int planes, int channels, int hw,
                      float inv_hw, float eps, int act, float slope,
                      int device, void* stream) {
  if (planes <= 0) return 0;
  if (channels <= 0 || planes % channels != 0 || hw <= 0 || act < kNone ||
      act > kLeaky)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const float*>(weight),
                 static_cast<const float*>(bias), channels, inv_hw, eps, act,
                 slope};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = static_cast<int>(
      (static_cast<long long>(planes) + kScalarThreads / 32 - 1) /
      (kScalarThreads / 32));
  instance_norm_kernel_scalar<<<ctas, kScalarThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
      planes, hw, p);
  return static_cast<int>(cudaGetLastError());
}

// x, y: (n, hw, channels) bf16, contiguous (a channels-last (N, C, H, W)
// tensor's storage), 16-byte aligned; weight, bias: (channels,) float32 or
// null. ct: channels a tile (8, 16, ..., 256, dividing channels); a CTA
// holds box_rows * boxes rows of its tile, and a cluster of `cluster` CTAs
// a sample's hw rows ((cluster - 1) * rows < hw <= cluster * rows).
// inv_hw, eps, act, slope as above.
int eve_instance_norm_nhwc(const void* x, void* y, const void* weight,
                           const void* bias, int n, int channels, int hw,
                           int ct, int cluster, int box_rows, int boxes,
                           float inv_hw, float eps, int act, float slope,
                           int device, void* stream) {
  if (n <= 0) return 0;
  const long long rows = static_cast<long long>(box_rows) * boxes;
  const bool tile_ok = ct >= kVec && ct <= 256 && (ct & (ct - 1)) == 0;
  if (channels <= 0 || !tile_ok || channels % ct != 0 || hw <= 1 ||
      cluster < 1 || cluster > kMaxCluster ||
      (cluster > 1 && ct > kMaxClusterTile) || box_rows < 8 ||
      box_rows > kMaxBoxRows || box_rows % 8 != 0 || boxes < 1 ||
      boxes > kMaxBoxes || (cluster - 1) * rows >= hw ||
      cluster * rows < hw || rows * ct * 2 + kSmemAlign > 227 * 1024 ||
      act < kNone ||
      act > kLeaky || misaligned(x) || misaligned(y))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ctas =
      static_cast<long long>(n) * (channels / ct) * cluster;
  if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap in_map, out_map;
  if (!nhwc_map(&in_map, x, n, hw, channels, ct, box_rows) ||
      !nhwc_map(&out_map, y, n, hw, channels, ct, box_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const float*>(weight),
                 static_cast<const float*>(bias), channels, inv_hw, eps, act,
                 slope};
  const NhwcTiling t{hw, static_cast<int>(rows), box_rows, channels / ct,
                     cluster};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = static_cast<int>(ctas);
  switch (ct) {
    case 8: err = launch_nhwc<8>(in_map, out_map, t, grid, p, s); break;
    case 16: err = launch_nhwc<16>(in_map, out_map, t, grid, p, s); break;
    case 32: err = launch_nhwc<32>(in_map, out_map, t, grid, p, s); break;
    case 64: err = launch_nhwc<64>(in_map, out_map, t, grid, p, s); break;
    case 128: err = launch_nhwc<128>(in_map, out_map, t, grid, p, s); break;
    default: err = launch_nhwc<256>(in_map, out_map, t, grid, p, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
