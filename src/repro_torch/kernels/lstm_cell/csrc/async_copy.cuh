// Hopper (sm_90) bulk asynchronous copies for the LSTM training kernels
// (lstm_sequence.cu's lstm_train_fwd_kernel, lstm_sequence_bwd.cu's
// lstm_bwd_time_kernel), as inline PTX: an mbarrier in shared memory and
// cp.async.bulk from global to shared memory completing on it.  One thread
// starts a whole weight matrix as one copy; the copy engine moves it while
// the block's threads load their inputs, and the threads wait on the
// barrier only where they first read the weights.  Also the helpers both
// kernels share.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lstm {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
  // make the initialised barrier visible to the async proxy
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of transactions to come
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned; completion is counted on `bar` in bytes.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the four lanes of the quad this lane belongs to, for __shfl_*_sync
__device__ __forceinline__ unsigned quad_mask() {
  return 0xFu << ((threadIdx.x & 31) & ~3u);
}

// expf/tanhf, not the fast intrinsics: the port is held to 1e-5 of float32.
__device__ __forceinline__ float sigmoidf(float z) {
  return 1.0f / (1.0f + expf(-z));
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace lstm
