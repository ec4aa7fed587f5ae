// Bulk copies (TMA, cp.async.bulk) from device memory into shared memory,
// completed on mbarriers in shared memory.  Shared by relay_kernels.cu and
// relay_mxu_kernels.cu; each includes it into its own library.
//
// A copy's source and destination must be 16-byte aligned and its size a
// nonzero multiple of 16 bytes.  One thread issues a copy on a barrier
// initialised for one arrival; every thread that reads the bytes waits on
// the barrier's phase parity (0 for its first use, then alternating).

#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Orders this thread's earlier shared-memory accesses (and, after a block
// barrier, the block's) before its next bulk copy writes shared memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// L2 policy for bytes read once: evict first.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// L2 policy for bytes that neighbouring blocks read again soon (the masks
// of a tile that the tree groups of a batch route in adjacent blocks).
__device__ __forceinline__ uint64_t evict_normal_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// The issuing thread's arrival on `bar`, which then also waits for `bytes`
// more bytes of bulk copies.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// `bytes` from `src` to `dst` as one bulk copy completing on `bar`, whose
// expected bytes already count them (mbar_arrive_expect_tx).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// `bytes` from `src` to `dst` as one bulk copy whose bytes complete on `bar`
// (the issuing thread's arrival).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint64_t policy) {
  mbar_arrive_expect_tx(bar, bytes);
  bulk_copy(dst, src, bytes, bar, policy);
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

}  // namespace
