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
// row, broadcast there by ops.selective_scan; this kernel takes h_0, so it
// carries the model's state through prefill and every decode step, and
// reads the one group's b and c once per batch row, for every head.
//
// Layouts are the model's, row-major and contiguous, all float32:
//   x           (B, T, H, P)   read straight at stride H*P between steps
//   b, c        (B, T, N)      shared by the H heads of a batch row
//   dt          (B, T, H)      the softplus step, > 0
//   a, d        (H,)           the decay (< 0) and the skip, one per head
//   state0      (B, H, P, N)   h[p][n] at [b][h][p][n]; may be null
//   y           (B, T, H, P)
//   state_out   (B, H, P, N)   may be state0 itself (an in-place update)
//
// Design: one block per (b, h), P threads.  The Pallas kernel's sequential
// chunk grid and its VMEM scratch state become a loop over T inside the
// block: thread p keeps row p of h, h[p][:], in N registers from the first
// step to the last.  Each chunk of kChunk steps is staged in shared memory
// first: b and c (steps * N contiguous floats each, loaded by all threads
// together), dt and the step's decay exp(dt a), computed once per step for
// the block, and each thread's own x.  Then every thread steps its row
// through the chunk:
//   u = dt x_p;  h[p][n] = decay h[p][n] + u b_n;  y_p = sum_n h[p][n] c_n + d x_p
// with two partial sums against the dependent chain.  Two barriers a chunk,
// none inside it.  The block's state, P * N contiguous floats, is read and
// written through shared memory (rows padded against bank conflicts), so
// neighbouring threads touch neighbouring addresses; every read of state0
// is done before the first barrier, and every write of state_out after the
// last, so the two may alias.  No atomics: a rerun is bit-identical.
//
// What bounds it: at the served prefill (B, T, H, P, N) = (4, 512, 64, 64,
// 64) the 5 B T H P N float32 operations (decay h + u b, a multiply and an
// FMA; h c summed, an FMA), 2.7 GFLOP, take 40 us at 67 TFLOP/s, against
// 22 us for the bytes (x and y 33.5 MB each, b, c, dt, the final state;
// 73 MB at 3.35 TB/s).  At a decode step (T = 1) the 8.4 MB of state in
// and out set it, 2.5 us.  This first design runs the recurrence on the
// CUDA cores with B*H blocks of P threads (256 blocks of 2 warps at the
// served shape), so the serial chain over T and the low occupancy, not the
// operations, set its time; the tensor-core chunked SSD form, TMA staging of
// the step tiles and a split of N across threads at decode are later work.
// Plain IEEE float32 (expf, no fast math); the sums run in another order
// than the plain version's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;  // time steps staged in shared memory at once
constexpr int kMaxP = 64;   // the largest head dim the kernel takes
constexpr int kMaxN = 64;   // the largest state dim the kernel takes

// NC: the register capacity of a state row, the power of two >= N
template <int NC>
__global__ void __launch_bounds__(kMaxP)
ssm_scan_kernel(const float* __restrict__ x, const float* __restrict__ b,
                const float* __restrict__ c, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ d,
                const float* state0, float* __restrict__ y, float* state_out,
                int T, int H, int P, int N) {
  __shared__ __align__(16) float bs[kChunk][NC];
  __shared__ __align__(16) float cs[kChunk][NC];
  __shared__ float xs[kChunk][kMaxP];
  __shared__ float dts[kChunk];
  __shared__ float decays[kChunk];
  __shared__ float hs[kMaxP][NC + 1];  // the (P, N) state, rows padded
  const int bh = blockIdx.x;
  const int bb = bh / H;
  const int hh = bh - bb * H;
  const int p = threadIdx.x;  // the state row this thread owns, p < P
  const float ah = a[hh];
  const float dh = d[hh];

  // the block's state is P*N contiguous floats: read and written through
  // shared memory, neighbouring threads on neighbouring addresses
  const size_t state_base = static_cast<size_t>(bh) * P * N;
  float h[NC];
  if (state0 != nullptr) {
    for (int i = p; i < P * N; i += P) {
      const int r = i / N;
      hs[r][i - r * N] = state0[state_base + i];
    }
    __syncthreads();
  }
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    h[n] = (n < N && state0 != nullptr) ? hs[p][n] : 0.0f;
  }

  const size_t bc_base = static_cast<size_t>(bb) * T * N;       // (bb, 0, 0)
  const size_t dt_base = static_cast<size_t>(bb) * T * H + hh;  // (bb, 0, hh)
  const size_t step = static_cast<size_t>(H) * P;  // x, y stride between steps
  const size_t col = static_cast<size_t>(bb) * T * step +
                     static_cast<size_t>(hh) * P + p;  // (bb, 0, hh, p)
  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int steps = min(kChunk, T - t0);
    const size_t at = bc_base + static_cast<size_t>(t0) * N;
    for (int i = p; i < steps * N; i += P) {
      const int s = i / N;
      const int n = i - s * N;
      bs[s][n] = b[at + i];
      cs[s][n] = c[at + i];
    }
    for (int s = p; s < steps; s += P) {
      const float v = dt[dt_base + static_cast<size_t>(t0 + s) * H];
      dts[s] = v;
      decays[s] = expf(v * ah);
    }
    for (int s = 0; s < steps; ++s) {
      xs[s][p] = x[col + static_cast<size_t>(t0 + s) * step];
    }
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      const float xv = xs[s][p];
      const float u = dts[s] * xv;
      const float decay = decays[s];
      float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        if (n < N) {
          h[n] = decay * h[n] + u * bs[s][n];  // the same word for all threads
          const float term = h[n] * cs[s][n];
          if (n & 1) {
            acc1 += term;
          } else {
            acc0 += term;
          }
        }
      }
      y[col + static_cast<size_t>(t0 + s) * step] = (acc0 + acc1) + dh * xv;
    }
    __syncthreads();  // the chunk is read by all before the next overwrites
  }

#pragma unroll
  for (int n = 0; n < NC; ++n) {
    if (n < N) hs[p][n] = h[n];
  }
  __syncthreads();
  for (int i = p; i < P * N; i += P) {
    const int r = i / N;
    state_out[state_base + i] = hs[r][i - r * N];
  }
}

template <int NC>
cudaError_t launch(const float* x, const float* b, const float* c,
                   const float* dt, const float* a, const float* d,
                   const float* state0, float* y, float* state_out, int B,
                   int T, int H, int P, int N, cudaStream_t stream) {
  ssm_scan_kernel<NC><<<B * H, P, 0, stream>>>(x, b, c, dt, a, d, state0, y,
                                               state_out, T, H, P, N);
  return cudaGetLastError();
}

}  // namespace

// The C entry point: launches on ``stream`` and returns the CUDA error of
// the launch (0 on success).  T >= 1, 1 <= P, N <= 64, B * H blocks.
extern "C" int ssm_scan_forward(const float* x, const float* b,
                                const float* c, const float* dt,
                                const float* a, const float* d,
                                const float* state0, float* y,
                                float* state_out, int B, int T, int H, int P,
                                int N, cudaStream_t stream) {
  if (B < 1 || T < 1 || H < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      static_cast<long long>(B) * H > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (N <= 8) {
    err = launch<8>(x, b, c, dt, a, d, state0, y, state_out, B, T, H, P, N,
                    stream);
  } else if (N <= 16) {
    err = launch<16>(x, b, c, dt, a, d, state0, y, state_out, B, T, H, P, N,
                     stream);
  } else if (N <= 32) {
    err = launch<32>(x, b, c, dt, a, d, state0, y, state_out, B, T, H, P, N,
                     stream);
  } else {
    err = launch<64>(x, b, c, dt, a, d, state0, y, state_out, B, T, H, P, N,
                     stream);
  }
  return static_cast<int>(err);
}
