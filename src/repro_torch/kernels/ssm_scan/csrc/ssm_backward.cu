// The selective scan's backward for Hopper (sm_90a): the gradients of the
// recurrence of ssm_scan.cu,
//
//   h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) b_t^T      (P x N)
//   y_t = h_t c_t + d x_t
//
// with respect to x, b, c, dt, a, d and h_0, given dy and the final state's
// gradient dh_T (zero when none is given).  Per (batch, head), with
// e_t = exp(dt_t a) and G_t = dL/dh_t, walking t from T down to 1:
//
//   G_t    = dy_t c_t^T + e_{t+1} G_{t+1}          (G_T gets dh_T too)
//   dx_t   = dt_t G_t b_t + d dy_t
//   db_t  += dt_t G_t^T x_t                         (summed over heads)
//   dc_t  += h_t^T dy_t                             (summed over heads)
//   ddt_t  = sum G_t . (a e_t h_{t-1} + x_t b_t^T)
//   da    += dt_t e_t sum G_t . h_{t-1}
//   dd    += sum dy_t . x_t
//   dh_0   = e_1 G_1
//
// The JAX package has no kernel for this: its gradient is XLA's, through
// the scan (src/repro/models/ssm.py: ssd_stepwise).  This kernel is the
// backward of the port's #8 (src/repro/kernels/ssm_scan/kernel.py:
// ssm_scan), as flash_backward.cu is #6's.
//
// Layouts are the forward's, all float32: x, dy, dx (B, T, H, P); b, c
// (B, T, N); dt, ddt (B, T, H); a, d (H,); state0, dstate, dstate0
// (B, H, P, N), each may be null (zero in, not written out).  The sums over
// heads and over batch rows come back as each block's partials, which the
// wrapper sums in a fixed order: db_part and dc_part (B, T, H, N), da_part
// and dd_part (B, H).  No atomics: reruns are bit-identical.
//
// The reverse sweep needs h_{t-1}, which it cannot get from h_t (e may
// round to 0).  Per-step states cost B H T P N floats (2.15 GB at the
// training shape (4, 512, 64, 64, 64)), so the kernel keeps none from the
// forward: pass 1 runs the recurrence forward and writes the state every
// kChunk steps to a scratch buffer (B H ceil(T/kChunk) P N floats, 134 MB
// at that shape), and pass 2 walks the chunks backward: it reloads a
// chunk's boundary state, runs the recurrence forward again to each group
// of kSub steps, keeping their h_{t-1} in shared memory, and takes those
// kSub steps in reverse.
//
// One block of 256 threads per (batch, head) holds the whole state padded
// to 64 x 64, h and G in registers: thread tid owns row p = tid / 4 and the
// 16 columns n = 4 c + tid % 4.  G_t b_t and sum_n G . h_{t-1} are sums
// over n: 16 FMAs in the thread, then the row's 4 lanes by xor shuffles.
// db and dc are sums over p: each warp's 8 rows by a reduce-scatter of
// shuffles, then the 8 warps' sums in warp order by 128 threads through
// shared memory; ddt and da sum the rows' values by one warp each.  A state
// past P or N stays zero: its inputs load as 0.
//
// What bounds it: at the training shape the operations (~17 flops a state
// element and step: the recurrence run again, h_t again, two row sums, two
// column sums, G's two updates, 9.1 GFLOP) take 136 us at 67 TFLOP/s of
// float32; the bytes (x, dy, dx, the column partials, b, c, dt, ~170 MB)
// 51 us at 3.35 TB/s.  This kernel is far from both: each reverse step is
// a chain of shuffles and one block barrier over 8 warps, so latency
// bounds it, at two blocks an SM (~90 KB of shared memory each).  The
// chunked SSD form on the tensor cores is the later design.  Plain IEEE
// float32 with expf (no fast math).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDim = 64;      // the state padded to kDim x kDim
constexpr int kCols = 16;     // state columns a thread
constexpr int kChunk = 16;    // steps between two boundary states
constexpr int kSub = 4;       // steps whose h_{t-1} shared memory holds
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum { kX, kDy, kB, kC, kVectors };

struct Smem {
  // h_{t-1} of kSub steps, each thread's 16 values at [s][c][tid]
  float state[kSub][kCols][kThreads];
  // the chunk's x, dy (P), b, c (N), zero past P, N and T
  float in[kChunk][kVectors][kDim];
  // the chunk's dt and e = exp(dt a), zero and one past T
  float dt[kChunk];
  float e[kChunk];
  // db's and dc's per-warp column sums, two steps in flight
  float red[2][2][kWarps][kDim];
  // each row's terms of ddt and da, two steps in flight
  float rows[2][2][kDim];
};

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  x += __shfl_xor_sync(kFull, x, 2);
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// The sums over a warp's 8 rows of the 16 column values v[c] (column
// 4 c + q of the lane's row): a reduce-scatter over lane bits 4, 3, 2.
// Returns with v[0] and v[1] the sums of columns 4 c' + q for c' = 2 rw and
// 2 rw + 1, rw = lane / 4.
__device__ __forceinline__ void col_sums(float (&v)[kCols], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float keep = b4 ? v[c + 8] : v[c];
    const float send = b4 ? v[c] : v[c + 8];
    v[c] = keep + __shfl_xor_sync(kFull, send, 16);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float keep = b3 ? v[c + 4] : v[c];
    const float send = b3 ? v[c] : v[c + 4];
    v[c] = keep + __shfl_xor_sync(kFull, send, 8);
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float keep = b2 ? v[c + 2] : v[c];
    const float send = b2 ? v[c] : v[c + 2];
    v[c] = keep + __shfl_xor_sync(kFull, send, 4);
  }
}

// Loads steps t0 .. t0 + n - 1 of x, dy, b, c, dt and e into shared memory
// (dy only when `with_dy`), then waits for the block.
__device__ void load_chunk(Smem& sm, const float* __restrict__ x,
                           const float* __restrict__ dy,
                           const float* __restrict__ b,
                           const float* __restrict__ c,
                           const float* __restrict__ dt, float ah,
                           bool with_dy, int bb, int hh, int t0, int n,
                           int T, int H, int P, int N) {
  for (int idx = threadIdx.x; idx < kChunk * kVectors * kDim;
       idx += kThreads) {
    const int s = idx / (kVectors * kDim), a = idx / kDim % kVectors,
              e = idx % kDim;
    if (a == kDy && !with_dy) continue;
    const size_t bt = static_cast<size_t>(bb) * T + t0 + s;
    float val = 0.0f;
    if (s < n) {
      if (a == kX || a == kDy) {
        if (e < P) val = (a == kX ? x : dy)[(bt * H + hh) * P + e];
      } else if (e < N) {
        val = (a == kB ? b : c)[bt * N + e];
      }
    }
    sm.in[s][a][e] = val;
  }
  for (int s = threadIdx.x; s < kChunk; s += kThreads) {
    const float dts =
        s < n ? dt[(static_cast<size_t>(bb) * T + t0 + s) * H + hh] : 0.0f;
    sm.dt[s] = dts;
    sm.e[s] = expf(dts * ah);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 2)
ssm_bwd_kernel(const float* __restrict__ x, const float* __restrict__ b,
               const float* __restrict__ c, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ d,
               const float* __restrict__ state0,
               const float* __restrict__ dy,
               const float* __restrict__ dstate, float* __restrict__ dx,
               float* __restrict__ db_part, float* __restrict__ dc_part,
               float* __restrict__ ddt, float* __restrict__ da_part,
               float* __restrict__ dd_part, float* __restrict__ dstate0,
               float* __restrict__ bounds, int T, int H, int P, int N) {
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int hh = blockIdx.x, bb = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = tid & 3, p = tid >> 2;
  const bool row_in = p < P;
  const size_t bh = static_cast<size_t>(bb) * H + hh;
  const int chunks = (T + kChunk - 1) / kChunk;
  const float ah = a[hh], dh = d[hh];
  // this thread's boundary states: [chunk][c][tid] of its block's scratch
  float* my_bounds = bounds + bh * chunks * kCols * kThreads + tid;

  // pass 1: the recurrence forward, the state before each chunk kept
  float S[kCols];
#pragma unroll
  for (int cc = 0; cc < kCols; ++cc) {
    const int n = 4 * cc + q;
    S[cc] = (state0 != nullptr && row_in && n < N)
                ? state0[(bh * P + p) * N + n] : 0.0f;
  }
  for (int ch = 0; ch < chunks; ++ch) {
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
      my_bounds[(static_cast<size_t>(ch) * kCols + cc) * kThreads] = S[cc];
    if (ch == chunks - 1) break;  // the last chunk's end is not needed
    load_chunk(sm, x, dy, b, c, dt, ah, false, bb, hh, ch * kChunk, kChunk,
               T, H, P, N);
    for (int s = 0; s < kChunk; ++s) {
      const float es = sm.e[s], u = sm.dt[s] * sm.in[s][kX][p];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc)
        S[cc] = es * S[cc] + u * sm.in[s][kB][4 * cc + q];
    }
    __syncthreads();  // every thread is done with the chunk's inputs
  }

  // pass 2: the chunks backward; G holds dL/dh_t from the steps after t
  float G[kCols];
#pragma unroll
  for (int cc = 0; cc < kCols; ++cc) {
    const int n = 4 * cc + q;
    G[cc] = (dstate != nullptr && row_in && n < N)
                ? dstate[(bh * P + p) * N + n] : 0.0f;
  }
  float dd_acc = 0.0f, da_acc = 0.0f;
  int buf = 0;
  for (int ch = chunks - 1; ch >= 0; --ch) {
    const int t0 = ch * kChunk, n_steps = min(kChunk, T - t0);
    load_chunk(sm, x, dy, b, c, dt, ah, true, bb, hh, t0, n_steps, T, H, P,
               N);
    for (int s0 = (n_steps - 1) / kSub * kSub; s0 >= 0; s0 -= kSub) {
      const int m = min(kSub, n_steps - s0);
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc)
        S[cc] = my_bounds[(static_cast<size_t>(ch) * kCols + cc) * kThreads];
      for (int s = 0; s < s0 + m; ++s) {
        if (s >= s0) {
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc)
            sm.state[s - s0][cc][tid] = S[cc];
        }
        const float es = sm.e[s], u = sm.dt[s] * sm.in[s][kX][p];
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          S[cc] = es * S[cc] + u * sm.in[s][kB][4 * cc + q];
      }
      for (int s = s0 + m - 1; s >= s0; --s) {
        const float es = sm.e[s], dts = sm.dt[s];
        const float xp = sm.in[s][kX][p], dyp = sm.in[s][kDy][p];
        const float u = dts * xp;
        float gb = 0.0f, gh = 0.0f;
        float dbv[kCols], dcv[kCols];
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          const float hp = sm.state[s - s0][cc][tid];
          const float bn = sm.in[s][kB][4 * cc + q];
          const float cn = sm.in[s][kC][4 * cc + q];
          G[cc] = fmaf(dyp, cn, G[cc]);             // G_t
          const float ht = es * hp + u * bn;        // h_t, as the forward
          gb = fmaf(G[cc], bn, gb);
          gh = fmaf(G[cc], hp, gh);
          dbv[cc] = G[cc] * u;
          dcv[cc] = ht * dyp;
          G[cc] *= es;                              // e_t G_t
        }
        gb = row_sum(gb);
        gh = row_sum(gh);
        dd_acc = fmaf(dyp, xp, dd_acc);
        col_sums(dbv, lane);
        col_sums(dcv, lane);
        const int rw = lane >> 2;
        sm.red[buf][0][warp][8 * rw + q] = dbv[0];
        sm.red[buf][0][warp][8 * rw + 4 + q] = dbv[1];
        sm.red[buf][1][warp][8 * rw + q] = dcv[0];
        sm.red[buf][1][warp][8 * rw + 4 + q] = dcv[1];
        const size_t bt = static_cast<size_t>(bb) * T + t0 + s;
        if (q == 0) {
          sm.rows[buf][0][p] = fmaf(ah * es, gh, xp * gb);  // ddt's
          sm.rows[buf][1][p] = dts * es * gh;                // da's
          if (row_in) dx[(bt * H + hh) * P + p] = fmaf(dts, gb, dh * dyp);
        }
        __syncthreads();
        if (tid < 2 * kDim) {
          const int which = tid / kDim, n = tid % kDim;
          if (n < N) {
            float acc = sm.red[buf][which][0][n];
#pragma unroll
            for (int wp = 1; wp < kWarps; ++wp)
              acc += sm.red[buf][which][wp][n];
            (which == 0 ? db_part : dc_part)[(bt * H + hh) * N + n] = acc;
          }
        } else if (warp == 4 || warp == 5) {
          const float* vals = sm.rows[buf][warp - 4];
          const float sum = warp_sum(vals[lane] + vals[lane + 32]);
          if (warp == 4 && lane == 0) ddt[bt * H + hh] = sum;
          if (warp == 5) da_acc += sum;
        }
        buf ^= 1;
      }
    }
  }
  // dd: the rows' sums over t, added by one warp
  if (q == 0) sm.rows[buf][0][p] = row_in ? dd_acc : 0.0f;
  __syncthreads();
  if (warp == 0) {
    const float sum = warp_sum(sm.rows[buf][0][lane]
                               + sm.rows[buf][0][lane + 32]);
    if (lane == 0) dd_part[bh] = sum;
  }
  if (warp == 5 && lane == 0) da_part[bh] = da_acc;
  if (dstate0 != nullptr && row_in) {
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int n = 4 * cc + q;
      if (n < N) dstate0[(bh * P + p) * N + n] = G[cc];
    }
  }
}

}  // namespace

// The C entry point: launches the backward on `stream` and returns the CUDA
// error of the launch (0 on success).  T >= 1, 1 <= P, N <= 64,
// 1 <= B, H <= 65535; `bounds` holds B H ceil(T / 16) 4096 floats.
extern "C" int ssm_scan_backward(const float* x, const float* b,
                                 const float* c, const float* dt,
                                 const float* a, const float* d,
                                 const float* state0, const float* dy,
                                 const float* dstate, float* dx,
                                 float* db_part, float* dc_part, float* ddt,
                                 float* da_part, float* dd_part,
                                 float* dstate0, float* bounds, int B, int T,
                                 int H, int P, int N, cudaStream_t stream) {
  if (B < 1 || T < 1 || H < 1 || P < 1 || N < 1 || P > kDim || N > kDim ||
      B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bytes = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      ssm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the whole carveout to shared memory: two blocks an SM
  err = cudaFuncSetAttribute(ssm_bwd_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssm_bwd_kernel<<<dim3(H, B), kThreads, bytes, stream>>>(
      x, b, c, dt, a, d, state0, dy, dstate, dx, db_part, dc_part, ddt,
      da_part, dd_part, dstate0, bounds, T, H, P, N);
  return static_cast<int>(cudaGetLastError());
}
