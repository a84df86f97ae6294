// Bulk copies from global to shared memory (`cp.async.bulk`, the Tensor
// Memory Accelerator) that complete on an mbarrier in shared memory: the
// rings of the streamed decoder kernels (decoder_stream.cuh for the bf16
// forms, mlp_stream_f32.cu for the f32 ones). One thread arms a barrier
// with the bytes it expects and issues the copy; every thread waits on the
// barrier's phase parity.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bulk {

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(b)),
               "r"(1)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects `bytes` of bulk copies
__device__ __forceinline__ void mbar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(saddr(b)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(b)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(b))
      : "memory");
}

// mbarrier.try_wait: true once the phase of `parity` has completed
__device__ __forceinline__ bool mbar_test(uint64_t* b, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(saddr(b)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// the wait for a ring stage's phase that traps after 2 s (a copy that
// never lands: a launch error, never a hang); the second passes'
// (mlp_wgrad.cu, mlp_wgrad_f32.cu) rings
__device__ inline void wait_stage(uint64_t* b, uint32_t parity) {
  if (mbar_test(b, parity)) return;
  const unsigned long long t0 = now_ns();
  while (!mbar_test(b, parity))
    if (now_ns() - t0 > 2000000000ull) __trap();
}

// orders this thread's earlier generic-proxy accesses of shared memory
// before later async-proxy ones (a bulk copy into memory it read)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace bulk
