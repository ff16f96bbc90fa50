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
// which always starts from a zero state; this kernel takes S_0 and so
// carries the model's state through prefill and every decode step.
//
// Layouts are the model's, row-major and contiguous, all float32:
//   r, k, v, w  (B, T, H, N)   read straight at stride H*N between steps,
//                              so nothing is transposed
//   u           (H, N)         the bonus, one per head
//   state0      (B, H, N, N)   S[i][j] at [b][h][i][j]; may be null
//   y           (B, T, H, N)
//   state_out   (B, H, N, N)   may be state0 itself (an in-place update)
//
// Design: one block per (b, h), N threads.  The Pallas kernel's sequential
// chunk grid and its VMEM scratch state become a loop over T inside the
// block: thread j keeps column j of S, S[:, j], in N registers from the
// first step to the last.  Each chunk of kChunk steps is staged in shared
// memory first, every thread loading its own element of r, k, w (packed
// with u into one float4, so the inner loop reads one broadcast 16-byte
// word per i) and v; then every thread steps its column through the chunk:
//   y_j  = sum_i r_i (S[i][j] + u_i k_i v_j)
//   S[i][j] = w_i S[i][j] + k_i v_j
// with two partial sums against the dependent chain.  Two barriers a chunk,
// none inside it.  Each thread reads its column of state0 before it writes
// its column of state_out, and no other thread touches that column, so the
// two may alias.  No atomics: a rerun is bit-identical.
//
// What bounds it: at the served prefill (B, T, H, N) = (4, 512, 40, 64)
// the bytes (r, k, v, w and y once, the final state out, ~107 MB, 32 us at
// 3.35 TB/s) set the bound; the 5 B T H N^2 float32 operations (r S summed,
// w S + k v; the bonus factors as v_j sum_i r_i u_i k_i, O(N) a step) take
// 1.7 GFLOP, 25 us at 67 TFLOP/s.  At a decode step (T = 1) the 5.2 MB of
// state in and out.  This first design runs the recurrence on the CUDA cores with
// B*H blocks of N threads (160 blocks of 2 warps at the served shape), so
// the serial chain over T and the low occupancy, not the bytes, set its
// time; the tensor-core chunked form, TMA staging of the step tiles and a
// split over rows at decode are later work.  Plain IEEE float32 (no fast
// math); the sums run in another order than the plain version's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;  // time steps staged in shared memory at once
constexpr int kMaxN = 64;   // the largest head size the kernel takes

// NC: the register capacity of a column, the power of two >= N
template <int NC>
__global__ void __launch_bounds__(NC)
rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* state0,
                  float* __restrict__ y, float* state_out, int T, int H,
                  int N) {
  __shared__ float4 rkwu[kChunk][NC];  // (r_i, k_i, w_i, u_i) of each step
  __shared__ float vs[kChunk][NC];
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int j = threadIdx.x;  // the state column this thread owns, j < N

  const size_t state_base = static_cast<size_t>(bh) * N * N;
  float s[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    s[i] = (i < N && state0 != nullptr)
               ? state0[state_base + static_cast<size_t>(i) * N + j]
               : 0.0f;
  }
  const float uj = u[h * N + j];

  const size_t step = static_cast<size_t>(H) * N;  // stride between steps
  const size_t col = static_cast<size_t>(b) * T * step +
                     static_cast<size_t>(h) * N + j;  // (b, 0, h, j)
  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int steps = min(kChunk, T - t0);
    for (int c = 0; c < steps; ++c) {
      const size_t at = col + static_cast<size_t>(t0 + c) * step;
      rkwu[c][j] = make_float4(r[at], k[at], w[at], uj);
      vs[c][j] = v[at];
    }
    __syncthreads();
    for (int c = 0; c < steps; ++c) {
      const float vj = vs[c][j];
      float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        if (i < N) {
          const float4 q = rkwu[c][i];  // the same word for every thread
          const float kv = q.y * vj;
          const float term = q.x * (s[i] + q.w * kv);
          if (i & 1) {
            acc1 += term;
          } else {
            acc0 += term;
          }
          s[i] = q.z * s[i] + kv;
        }
      }
      y[col + static_cast<size_t>(t0 + c) * step] = acc0 + acc1;
    }
    __syncthreads();  // the chunk is read by all before the next overwrites
  }

#pragma unroll
  for (int i = 0; i < NC; ++i) {
    if (i < N) state_out[state_base + static_cast<size_t>(i) * N + j] = s[i];
  }
}

template <int NC>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* state0,
                   float* y, float* state_out, int B, int T, int H, int N,
                   cudaStream_t stream) {
  rwkv6_scan_kernel<NC><<<B * H, N, 0, stream>>>(r, k, v, w, u, state0, y,
                                                 state_out, T, H, N);
  return cudaGetLastError();
}

}  // namespace

// The C entry point: launches on ``stream`` and returns the CUDA error of
// the launch (0 on success).  T >= 1, 1 <= N <= 64, B * H blocks.
extern "C" int rwkv6_scan_forward(const float* r, const float* k,
                                  const float* v, const float* w,
                                  const float* u, const float* state0,
                                  float* y, float* state_out, int B, int T,
                                  int H, int N, cudaStream_t stream) {
  if (B < 1 || T < 1 || H < 1 || N < 1 || N > kMaxN ||
      static_cast<long long>(B) * H > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (N <= 8) {
    err = launch<8>(r, k, v, w, u, state0, y, state_out, B, T, H, N, stream);
  } else if (N <= 16) {
    err = launch<16>(r, k, v, w, u, state0, y, state_out, B, T, H, N, stream);
  } else if (N <= 32) {
    err = launch<32>(r, k, v, w, u, state0, y, state_out, B, T, H, N, stream);
  } else {
    err = launch<64>(r, k, v, w, u, state0, y, state_out, B, T, H, N, stream);
  }
  return static_cast<int>(err);
}
