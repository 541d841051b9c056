// Hopper's asynchronous copies and cluster barriers, as inline PTX.
//
// Shared by the kernels under eve_tpu_torch/csrc/ (sm_90a). The build keys
// each library on every file of this directory, so an edit here rebuilds
// every kernel that includes it.
//
// - mbarrier: one 64-bit barrier in shared memory; a thread arrives with
//   the byte count it expects and waits on the phase parity, and the copy
//   engine completes those bytes.
// - Bulk copies (cp.async.bulk, no tensor map): a contiguous run of bytes
//   between device and shared memory. Address and size are multiples of 16
//   bytes. A load completes on an mbarrier; a store belongs to the issuing
//   thread's bulk group, which that thread commits and waits on.
// - Cluster barrier halves and st.async: a CTA pushes 16 bytes into a
//   peer's shared memory and completes them on the peer's mbarrier, so the
//   peer waits on its own barrier instead of the whole cluster.

#pragma once

#include <stdint.h>

namespace eve {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes prior mbarrier.init visible to the async proxy and the cluster.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Spins until the phase with the given parity has completed. A copy that
// never completes (a wrong byte count) traps after ~2^26 polls, seconds
// instead of a hung card, and the launch's stream reports the fault.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls > (1u << 26)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Device -> shared memory; completes `bytes` transaction bytes on `bar`.
__device__ __forceinline__ void bulk_load(void* smem_dst, const void* gmem_src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(smem_dst)),
      "l"(gmem_src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (a bulk store).
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Shared -> device memory, in the issuing thread's current bulk group.
__device__ __forceinline__ void bulk_store(void* gmem_dst, const void* smem_src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::
                   "l"(gmem_dst),
               "r"(smem_u32(smem_src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's bulk groups still read shared
// memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// Cluster barrier halves. A thread that arrives need not wait before it
// exits; a wait returns once every thread of the cluster has arrived.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// The address of `local` (this CTA's shared memory) in CTA `rank` of the
// cluster, as a shared::cluster address.
__device__ __forceinline__ uint32_t cluster_map(const void* local,
                                               uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  return remote;
}

// Writes 16 bytes into another CTA's shared memory and completes them on
// that CTA's mbarrier (both shared::cluster addresses, see cluster_map).
__device__ __forceinline__ void st_async_f4(uint32_t remote, float4 v,
                                            uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(remote),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(remote_bar)
      : "memory");
}

}  // namespace eve
