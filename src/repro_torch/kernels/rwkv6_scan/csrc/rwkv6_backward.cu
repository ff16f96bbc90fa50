// The WKV scan's backward for Hopper (sm_90a): the gradients of the
// recurrence of rwkv6_scan.cu,
//
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// with respect to r, k, v, w, u and S_0, given dy and the final state's
// gradient dS_T (zero when none is given).  Per (batch, head), with
// G_t = dL/dS_t, walking t from T down to 1:
//
//   dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t
//   dk_t = u . r_t (v_t . dy_t) + G_t v_t
//   dv_t = (r_t . (u . k_t)) dy_t + G_t^T k_t
//   dw_t = rowsum(G_t . S_{t-1})
//   du  += r_t . k_t (v_t . dy_t)
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T,      dS_0 = G_0
//
// The JAX package has no kernel for this: its gradient is XLA's, through
// the scan (src/repro/models/rwkv.py: wkv_stepwise).  This kernel is the
// backward of the port's #7 (src/repro/kernels/rwkv6_scan/kernel.py:
// rwkv6_scan), as flash_backward.cu is #6's.
//
// Layouts are the forward's, all float32: r, k, v, w, dy and dr, dk, dv, dw
// (B, T, H, N); u (H, N); state0, dstate and dstate0 (B, H, N, N), each may
// be null (zero in, not written out); du_part (B, H, N), each block's du,
// which the wrapper sums over B in a fixed order.  No atomics: reruns are
// bit-identical.
//
// The reverse sweep needs S_{t-1}, which it cannot get from S_t (w may be
// 0).  Per-step states cost B H T N^2 floats (1.34 GB at the training shape
// (4, 512, 40, 64)), so the kernel keeps none from the forward: pass 1 runs
// the recurrence forward and writes the state every kChunk steps to a
// scratch buffer (B H ceil(T/kChunk) N^2 floats, 84 MB at that shape),
// and pass 2 walks the chunks backward: it reloads a chunk's boundary state,
// runs the recurrence forward again to each group of kSub steps, keeping
// their S_{t-1} in shared memory, and takes those kSub steps in reverse.
//
// One block of 256 threads per (batch, head) holds the whole state padded
// to 64 x 64, S and G in registers: thread tid owns row i = tid / 4 and the
// 16 columns j = 4 c + tid % 4.  dr, dk and dw are sums over j: 16 FMAs in
// the thread, then the row's 4 lanes by xor shuffles.  dv is a sum over i:
// each warp's 8 rows by a reduce-scatter of shuffles (xor 16, 8, 4, leaving
// each lane two columns' sums), then the 8 warps' sums in warp order by 64
// threads through shared memory.  A state past N (rows or columns) stays
// zero: its inputs load as 0.
//
// What bounds it: at the training shape the bytes (r, k, v, w, dy in, dr,
// dk, dv, dw out, ~190 MB) take 57 us at 3.35 TB/s; the operations (~14
// flops a state element and step: the recurrence run again, the three row
// sums, the column sum and G's update, 4.7 GFLOP) take 70 us at 67 TFLOP/s
// of float32.  This kernel is far from both: each reverse step is a chain
// of shuffles and one block barrier over 8 warps, so latency bounds it, at
// two blocks an SM (88 KB of shared memory each).  The chunked matrix form
// on the tensor cores is the later design.  Plain IEEE float32 (no fast
// math).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDim = 64;      // the state padded to kDim x kDim
constexpr int kCols = 16;     // state columns a thread
constexpr int kChunk = 16;    // steps between two boundary states
constexpr int kSub = 4;       // steps whose S_{t-1} shared memory holds
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum { kR, kK, kV, kW, kDy, kInputs };

struct Smem {
  // S_{t-1} of kSub steps, each thread's 16 values at [s][c][tid]
  float state[kSub][kCols][kThreads];
  // the chunk's r, k, v, w, dy, zero past N and past T
  float in[kChunk][kInputs][kDim];
  // dv's per-warp column sums, two steps in flight
  float red[2][kWarps][kDim];
};

// The sum of x over the 4 lanes of a row (lanes tid % 4 = 0..3), the same
// in all four.
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  x += __shfl_xor_sync(kFull, x, 2);
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

// Loads steps t0 .. t0 + n - 1 of the inputs `which` names into sm.in
// (zeros past N and past n), then waits for the block.
__device__ void load_chunk(Smem& sm, const float* const (&src)[kInputs],
                           unsigned which, int bb, int hh, int t0, int n,
                           int T, int H, int N) {
  for (int idx = threadIdx.x; idx < kChunk * kInputs * kDim;
       idx += kThreads) {
    const int s = idx / (kInputs * kDim), a = idx / kDim % kInputs,
              e = idx % kDim;
    if (!(which >> a & 1u)) continue;
    float val = 0.0f;
    if (s < n && e < N)
      val = src[a][((static_cast<size_t>(bb) * T + t0 + s) * H + hh) * N + e];
    sm.in[s][a][e] = val;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 2)
rwkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u,
                 const float* __restrict__ state0,
                 const float* __restrict__ dy,
                 const float* __restrict__ dstate,
                 float* __restrict__ dr, float* __restrict__ dk,
                 float* __restrict__ dv, float* __restrict__ dw,
                 float* __restrict__ du_part, float* __restrict__ dstate0,
                 float* __restrict__ bounds, int T, int H, int N) {
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int hh = blockIdx.x, bb = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = tid & 3, i = tid >> 2;
  const bool row_in = i < N;
  const size_t bh = static_cast<size_t>(bb) * H + hh;
  const int chunks = (T + kChunk - 1) / kChunk;
  const float* const src[kInputs] = {r, k, v, w, dy};
  // this thread's boundary states: [chunk][c][tid] of its block's scratch
  float* my_bounds = bounds + bh * chunks * kCols * kThreads + tid;

  // pass 1: the recurrence forward, the state before each chunk kept
  float S[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int j = 4 * c + q;
    S[c] = (state0 != nullptr && row_in && j < N)
               ? state0[(bh * N + i) * N + j] : 0.0f;
  }
  for (int ch = 0; ch < chunks; ++ch) {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      my_bounds[(static_cast<size_t>(ch) * kCols + c) * kThreads] = S[c];
    if (ch == chunks - 1) break;  // the last chunk's end is not needed
    load_chunk(sm, src, 1u << kK | 1u << kV | 1u << kW, bb, hh,
               ch * kChunk, kChunk, T, H, N);
    for (int s = 0; s < kChunk; ++s) {
      const float ki = sm.in[s][kK][i], wi = sm.in[s][kW][i];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        S[c] = wi * S[c] + ki * sm.in[s][kV][4 * c + q];
    }
    __syncthreads();  // every thread is done with sm.in
  }

  // pass 2: the chunks backward
  float G[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int j = 4 * c + q;
    G[c] = (dstate != nullptr && row_in && j < N)
               ? dstate[(bh * N + i) * N + j] : 0.0f;
  }
  const float ui = row_in ? u[static_cast<size_t>(hh) * N + i] : 0.0f;
  float du_acc = 0.0f;
  int buf = 0;
  for (int ch = chunks - 1; ch >= 0; --ch) {
    const int t0 = ch * kChunk, n = min(kChunk, T - t0);
    load_chunk(sm, src, (1u << kInputs) - 1, bb, hh, t0, n, T, H, N);
    for (int s0 = (n - 1) / kSub * kSub; s0 >= 0; s0 -= kSub) {
      const int m = min(kSub, n - s0);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        S[c] = my_bounds[(static_cast<size_t>(ch) * kCols + c) * kThreads];
      for (int s = 0; s < s0 + m; ++s) {
        if (s >= s0) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) sm.state[s - s0][c][tid] = S[c];
        }
        const float ki = sm.in[s][kK][i], wi = sm.in[s][kW][i];
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          S[c] = wi * S[c] + ki * sm.in[s][kV][4 * c + q];
      }
      for (int s = s0 + m - 1; s >= s0; --s) {
        const float ri = sm.in[s][kR][i], ki = sm.in[s][kK][i],
                    wi = sm.in[s][kW][i];
        float sdy = 0.0f, gv = 0.0f, vdy = 0.0f, gs = 0.0f;
        float col[kCols];
        const float urk = ui * ri * ki;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float sp = sm.state[s - s0][c][tid];
          const float vj = sm.in[s][kV][4 * c + q];
          const float dyj = sm.in[s][kDy][4 * c + q];
          sdy = fmaf(sp, dyj, sdy);
          gv = fmaf(G[c], vj, gv);
          vdy = fmaf(vj, dyj, vdy);
          gs = fmaf(G[c], sp, gs);
          col[c] = fmaf(G[c], ki, urk * dyj);
          G[c] = fmaf(wi, G[c], ri * dyj);  // G_{t-1}
        }
        sdy = row_sum(sdy);
        gv = row_sum(gv);
        vdy = row_sum(vdy);
        gs = row_sum(gs);
        du_acc = fmaf(ri * ki, vdy, du_acc);
        col_sums(col, lane);
        const int rw = lane >> 2;
        sm.red[buf][warp][8 * rw + q] = col[0];
        sm.red[buf][warp][8 * rw + 4 + q] = col[1];
        const size_t row = ((static_cast<size_t>(bb) * T + t0 + s) * H + hh)
                           * N;
        if (q == 0 && row_in) {
          dr[row + i] = fmaf(ui * ki, vdy, sdy);
          dk[row + i] = fmaf(ui * ri, vdy, gv);
          dw[row + i] = gs;
        }
        __syncthreads();
        if (tid < N) {
          float acc = sm.red[buf][0][tid];
#pragma unroll
          for (int wp = 1; wp < kWarps; ++wp) acc += sm.red[buf][wp][tid];
          dv[row + tid] = acc;
        }
        buf ^= 1;
      }
    }
  }
  if (q == 0 && row_in) du_part[bh * N + i] = du_acc;
  if (dstate0 != nullptr && row_in) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = 4 * c + q;
      if (j < N) dstate0[(bh * N + i) * N + j] = G[c];
    }
  }
}

}  // namespace

// The C entry point: launches the backward on `stream` and returns the CUDA
// error of the launch (0 on success).  T >= 1, 1 <= N <= 64,
// 1 <= B, H <= 65535; `bounds` holds B H ceil(T / 16) 4096 floats.
extern "C" int rwkv6_scan_backward(const float* r, const float* k,
                                   const float* v, const float* w,
                                   const float* u, const float* state0,
                                   const float* dy, const float* dstate,
                                   float* dr, float* dk, float* dv, float* dw,
                                   float* du_part, float* dstate0,
                                   float* bounds, int B, int T, int H, int N,
                                   cudaStream_t stream) {
  if (B < 1 || T < 1 || H < 1 || N < 1 || N > kDim || B > 65535 ||
      H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bytes = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the whole carveout to shared memory: two blocks an SM
  err = cudaFuncSetAttribute(rwkv6_bwd_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv6_bwd_kernel<<<dim3(H, B), kThreads, bytes, stream>>>(
      r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw, du_part, dstate0,
      bounds, T, H, N);
  return static_cast<int>(cudaGetLastError());
}
