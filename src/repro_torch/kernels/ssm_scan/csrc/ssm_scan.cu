// Mamba2 selective scan for Hopper (sm_90a).  Per (batch, head), head dim P,
// state dim N, with a scalar decay a and a scalar skip d per head:
//
//   h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) b_t^T      (P x N)
//   y_t = h_t c_t + d x_t
//
// from a given state h_0 (zero when none is given), returning every y_t and
// the final state.
//
// It replaces the Pallas TPU kernel
//   src/repro/kernels/ssm_scan/kernel.py: ssm_scan (_ssm_kernel),
// which always starts from a zero state and takes b and c per (batch, head)
// row, broadcast there by ops.selective_scan; these kernels take h_0, so
// they carry the model's state through prefill and every decode step, and
// read the one group's b and c once per batch row, for every head.
//
// Layouts are the model's, row-major and contiguous, all float32:
//   x           (B, T, H, P)
//   b, c        (B, T, N)      shared by the H heads of a batch row
//   dt          (B, T, H)      the softplus step, > 0
//   a, d        (H,)           the decay (< 0) and the skip, one per head
//   state0      (B, H, P, N)   h[p][n] at [b][h][p][n]; may be null
//   y           (B, T, H, P)
//   state_out   (B, H, P, N)   may be state0 itself (an in-place update)
//
// Two kernels, one launch a call; the wrapper (kernel.py: kernel_for) picks
// by T:
//   * ssm_decode_kernel (ssm_decode.cu), T <= kernel.DECODE_MAX_T: every
//     decode step.  The bytes of the state bound it; each state row is split
//     across lanes with 16-byte accesses.
//   * ssm_chunked_kernel (ssm_chunked.cu), longer T: every prefill.  The
//     chunked SSD form, whose three 64 x 64 x 64 products a chunk run on the
//     tensor cores in 3xTF32.
//
// What bounds them: at the served prefill (B, T, H, P, N) = (4, 512, 64, 64,
// 64) the bytes of x, y, b, c, dt and the final state (73 MB) take 22 us at
// 3.35 TB/s; the chunked form's products, 3.2 GFLOP (9.7 in 3xTF32), take
// 20 us at the dense TF32 rate of 495 TFLOP/s; the recurrence itself on the
// CUDA cores (2.7 GFLOP of float32) would be bound at 40 us.  At a
// decode step the 8.4 MB of state in and out take 2.5 us.  Plain IEEE
// float32 outside the products (expf, no fast math); no atomics, so reruns
// are bit-identical.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

cudaError_t ssm_chunked_launch(const float* x, const float* b, const float* c,
                               const float* dt, const float* a,
                               const float* d, const float* state0, float* y,
                               float* state_out, int B, int T, int H, int P,
                               int N, bool vec, cudaStream_t stream);
cudaError_t ssm_decode_launch(const float* x, const float* b, const float* c,
                              const float* dt, const float* a, const float* d,
                              const float* state0, float* y, float* state_out,
                              int B, int T, int H, int P, int N, bool vec,
                              cudaStream_t stream);

namespace {

constexpr int kMaxP = 64;   // the largest head dim the kernels take
constexpr int kMaxN = 64;   // the largest state dim the kernels take
constexpr int kMaxGrid = 65535;  // H and B are grid dims y and z

}  // namespace

// The C entry point: launches kernel `kernel` (0 the chunked kernel, 1 the
// decode kernel) on `stream` and returns the CUDA error of the launch (0 on
// success).  T >= 1, 1 <= P, N <= 64, 1 <= B, H <= 65535.
extern "C" int ssm_scan_forward(const float* x, const float* b,
                                const float* c, const float* dt,
                                const float* a, const float* d,
                                const float* state0, float* y,
                                float* state_out, int B, int T, int H, int P,
                                int N, int kernel, cudaStream_t stream) {
  if (B < 1 || T < 1 || H < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      B > kMaxGrid || H > kMaxGrid || (kernel != 0 && kernel != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (kernel == 0) {
    const bool vec = tf32x3::aligned16(x) && tf32x3::aligned16(b) &&
                     tf32x3::aligned16(c) && P % 4 == 0 && N % 4 == 0;
    err = ssm_chunked_launch(x, b, c, dt, a, d, state0, y, state_out, B, T,
                             H, P, N, vec, stream);
  } else {
    const bool vec = tf32x3::aligned16(b) && tf32x3::aligned16(c) &&
                     (state0 == nullptr || tf32x3::aligned16(state0)) &&
                     tf32x3::aligned16(state_out) && N % 4 == 0;
    err = ssm_decode_launch(x, b, c, dt, a, d, state0, y, state_out, B, T, H,
                            P, N, vec, stream);
  }
  return static_cast<int>(err);
}
