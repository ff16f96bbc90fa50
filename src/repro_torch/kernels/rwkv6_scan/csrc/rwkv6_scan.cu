// RWKV6 WKV scan for Hopper (sm_90a).  Per (batch, head), head size N:
//
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// from a given state S_0 (zero when none is given), returning every y_t and
// the final state.
//
// It replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6_scan/kernel.py: rwkv6_scan (_wkv_kernel),
// which always starts from a zero state; these kernels take S_0 and so
// carry the model's state through prefill and every decode step.
//
// Layouts are the model's, row-major and contiguous, all float32:
//   r, k, v, w  (B, T, H, N)   read straight at stride H*N between steps,
//                              so nothing is transposed
//   u           (H, N)         the bonus, one per head
//   state0      (B, H, N, N)   S[i][j] at [b][h][i][j]; may be null
//   y           (B, T, H, N)
//   state_out   (B, H, N, N)   may be state0 itself (an in-place update)
//
// Two kernels, one launch a call; the wrapper (kernel.py: kernel_for) picks
// by T:
//   * rwkv6_decode_kernel (rwkv6_decode.cu), T <= kernel.DECODE_MAX_T:
//     every decode step.  The bytes of the state bound it; each state
//     column is split across lanes with 16-byte accesses.
//   * rwkv6_chunked_kernel (rwkv6_chunked.cu), longer T: every prefill.
//     The chunked WKV form, whose three products a chunk run on the tensor
//     cores in 3xTF32, its decays as running products of w.
//
// What bounds them: at the served prefill (B, T, H, N) = (4, 512, 40, 64)
// the bytes (r, k, v, w and y once, the final state out, ~107 MB) take
// 32 us at 3.35 TB/s; the chunked form's products in chunks of 16 (r~ S,
// A V, k~^T V: 1.5 GFLOP, 4.5 in 3xTF32) take 9 us at the dense TF32 rate
// of 495 TFLOP/s, its pairwise term A (~39 M products of w and as many
// FMAs a pass) ~1 us of float32; the recurrence itself on the CUDA cores
// (5 B T H N^2 = 1.7 GFLOP) would be bound at 25 us.  At a decode step the
// 5.2 MB of state in and out take 1.6 us.  Plain IEEE float32 outside the
// products (no fast math); no atomics, so reruns are bit-identical.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

cudaError_t rwkv6_chunked_launch(const float* r, const float* k,
                                 const float* v, const float* w,
                                 const float* u, const float* state0,
                                 float* y, float* state_out, int B, int T,
                                 int H, int N, bool vec, cudaStream_t stream);
cudaError_t rwkv6_decode_launch(const float* r, const float* k,
                                const float* v, const float* w,
                                const float* u, const float* state0, float* y,
                                float* state_out, int B, int T, int H, int N,
                                bool vec, cudaStream_t stream);

namespace {

constexpr int kMaxN = 64;        // the largest head size the kernels take
constexpr int kMaxGrid = 65535;  // H and B are grid dims y and z

}  // namespace

// The C entry point: launches kernel `kernel` (0 the chunked kernel, 1 the
// decode kernel) on `stream` and returns the CUDA error of the launch (0 on
// success).  T >= 1, 1 <= N <= 64, 1 <= B, H <= 65535.
extern "C" int rwkv6_scan_forward(const float* r, const float* k,
                                  const float* v, const float* w,
                                  const float* u, const float* state0,
                                  float* y, float* state_out, int B, int T,
                                  int H, int N, int kernel,
                                  cudaStream_t stream) {
  if (B < 1 || T < 1 || H < 1 || N < 1 || N > kMaxN || B > kMaxGrid ||
      H > kMaxGrid || (kernel != 0 && kernel != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using tf32x3::aligned16;
  const bool vec = N % 4 == 0 && aligned16(r) && aligned16(k) &&
                   aligned16(v) && aligned16(w);
  cudaError_t err;
  if (kernel == 0) {
    err = rwkv6_chunked_launch(r, k, v, w, u, state0, y, state_out, B, T, H,
                               N, vec, stream);
  } else {
    const bool dvec = vec && aligned16(u) && aligned16(y) &&
                      (state0 == nullptr || aligned16(state0)) &&
                      aligned16(state_out);
    err = rwkv6_decode_launch(r, k, v, w, u, state0, y, state_out, B, T, H,
                              N, dvec, stream);
  }
  return static_cast<int>(err);
}
