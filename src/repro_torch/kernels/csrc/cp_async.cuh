// cp.async staging, sm_80 and later: copies from global to shared memory
// that run behind the block's work, committed in groups and waited for by
// group.  The chunked WKV scan (rwkv6_scan/csrc/rwkv6_chunked.cu) and both
// recurrent backwards (rwkv6_scan/csrc/rwkv6_backward.cu, ssm_scan/csrc/
// ssm_backward.cu) stage their tiles with them: every copy of a tile is in
// flight at once, where a loop of loads and stores waits on each load.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace async_copy {

// cp.async of 16 bytes, global to shared; src_bytes 0 fills the 16 bytes
// with zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// cp.async of 4 bytes, global to shared; src_bytes 0 fills them with zero
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// rows [0, rows) x columns [0, width) of a row-major tile into shared
// memory (row stride ss floats) from global memory (row r at
// src + r * gs), zeros where r >= live_rows or c >= live_cols, by `nthr`
// threads; 16-byte copies when `vec` (src, gs, ss and width multiples of 4
// floats, 16-byte aligned), else 4-byte ones.  Not committed.
__device__ __forceinline__ void stage_tile(float* dst, int ss,
                                           const float* src, size_t gs,
                                           int rows, int width,
                                           int live_rows, int live_cols,
                                           bool vec, int tid, int nthr) {
  if (vec) {
    const int w4 = width / 4;
    for (int e = tid; e < rows * w4; e += nthr) {
      const int r = e / w4, c = 4 * (e % w4);
      const bool in = r < live_rows && c < live_cols;
      cp_async16(dst + r * ss + c,
                 in ? src + r * gs + c : src, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < rows * width; e += nthr) {
      const int r = e / width, c = e % width;
      const bool in = r < live_rows && c < live_cols;
      cp_async4(dst + r * ss + c, in ? src + r * gs + c : src, in ? 4 : 0);
    }
  }
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

}  // namespace async_copy
