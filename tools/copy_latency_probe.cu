// Latency of moving one CTA's slice at the heatmap kernels' serving shapes:
// a TMA bulk copy against 256 threads' float4 loads or stores.
//
// Built and driven by tools/copy_latency_probe.py (nvcc, sm_90a, ctypes).
// Every kernel runs 256-thread CTAs, each on its own contiguous slice of
// `slice_bytes` (a multiple of 16, at most 32 KB), and writes one float a
// CTA so that no load is dead code.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../eve_tpu_torch/csrc/hopper_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSliceBytes = 32 * 1024;
constexpr int kMaxQuadsPerThread = kMaxSliceBytes / 16 / kThreads;

__global__ void empty_kernel() {}

// Thread 0 issues one bulk copy of the slice; every thread waits for it.
__global__ void __launch_bounds__(kThreads)
tma_load_kernel(const float4* __restrict__ src, float* __restrict__ out,
                int slice_quads) {
  __shared__ __align__(128) float4 s_buf[kMaxSliceBytes / 16];
  __shared__ __align__(8) uint64_t s_full;
  const float4* slice = src + static_cast<size_t>(blockIdx.x) * slice_quads;
  if (threadIdx.x == 0) {
    eve::mbar_init(&s_full, 1);
    eve::fence_mbar_init();
    const uint32_t bytes = static_cast<uint32_t>(slice_quads) * 16u;
    eve::mbar_arrive_expect_tx(&s_full, bytes);
    eve::bulk_load(s_buf, slice, bytes, &s_full);
  }
  __syncthreads();
  eve::mbar_wait(&s_full, 0);
  if (threadIdx.x == 0) out[blockIdx.x] = s_buf[slice_quads - 1].w;
}

// Every thread loads its float4s of the slice into registers.
__global__ void __launch_bounds__(kThreads)
lsu_load_kernel(const float4* __restrict__ src, float* __restrict__ out,
                int slice_quads) {
  const float4* slice = src + static_cast<size_t>(blockIdx.x) * slice_quads;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxQuadsPerThread; ++j) {
    const int q = threadIdx.x + j * kThreads;
    if (q < slice_quads) acc += slice[q].w;
  }
  if (acc == -1.f) out[blockIdx.x] = acc;  // never: keeps the loads
  if (threadIdx.x == 0) out[blockIdx.x] = 0.f;
}

// Threads fill shared memory; thread 0 stores it with one bulk copy and
// waits until the copy has read it.
__global__ void __launch_bounds__(kThreads)
tma_store_kernel(float4* __restrict__ dst, int slice_quads) {
  __shared__ __align__(128) float4 s_buf[kMaxSliceBytes / 16];
  for (int q = threadIdx.x; q < slice_quads; q += kThreads)
    s_buf[q] = make_float4(1.f, 2.f, 3.f, static_cast<float>(q));
  eve::fence_proxy_async_smem();
  __syncthreads();
  if (threadIdx.x == 0) {
    eve::bulk_store(dst + static_cast<size_t>(blockIdx.x) * slice_quads, s_buf,
                    static_cast<uint32_t>(slice_quads) * 16u);
    eve::bulk_commit();
    eve::bulk_wait_read<0>();
  }
}

// Every thread stores its float4s of the slice.
__global__ void __launch_bounds__(kThreads)
lsu_store_kernel(float4* __restrict__ dst, int slice_quads) {
  float4* slice = dst + static_cast<size_t>(blockIdx.x) * slice_quads;
  for (int q = threadIdx.x; q < slice_quads; q += kThreads)
    slice[q] = make_float4(1.f, 2.f, 3.f, static_cast<float>(q));
}

}  // namespace

extern "C" {

// kind: 0 empty, 1 TMA load, 2 float4 loads, 3 TMA store, 4 float4 stores.
// buf holds ctas * slice_bytes bytes, 16-byte aligned; out ctas floats.
int probe_launch(int kind, void* buf, void* out, int ctas, int slice_bytes,
                 void* stream) {
  if (ctas < 1 || slice_bytes < 16 || slice_bytes > kMaxSliceBytes ||
      slice_bytes % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int quads = slice_bytes / 16;
  float4* b = static_cast<float4*>(buf);
  float* o = static_cast<float*>(out);
  switch (kind) {
    case 0: empty_kernel<<<ctas, kThreads, 0, s>>>(); break;
    case 1: tma_load_kernel<<<ctas, kThreads, 0, s>>>(b, o, quads); break;
    case 2: lsu_load_kernel<<<ctas, kThreads, 0, s>>>(b, o, quads); break;
    case 3: tma_store_kernel<<<ctas, kThreads, 0, s>>>(b, quads); break;
    case 4: lsu_store_kernel<<<ctas, kThreads, 0, s>>>(b, quads); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
