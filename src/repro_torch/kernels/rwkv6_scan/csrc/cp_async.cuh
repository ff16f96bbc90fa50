// cp.async staging for the chunked WKV scan (rwkv6_chunked.cu), sm_80 and
// later: 16-byte copies from global to shared memory that run behind the
// block's work, committed in groups and waited for by group.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wkv {

// cp.async of 16 bytes, global to shared; src_bytes 0 fills the 16 bytes
// with zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's committed groups are in
// flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

}  // namespace wkv
