// One fused LSTM step for Hopper (sm_90a), one kernel a weight path:
//   lstm_cell_kernel           K = F + H <= 64: the weight column in registers
//   lstm_cell_kernel_streamed  K > 64: the weight column streamed from L2
// each x (B,F), h (B,H), c (B,H) -> h' (B,H), c' (B,H).
//
// They replace the Pallas TPU kernel
//   src/repro/kernels/lstm_cell/kernel.py: lstm_cell (_cell_kernel).
//
// Layouts are the reference's, row-major and contiguous:
//   x (B,F), h (B,H), c (B,H)  float32 or bfloat16, each independently
//   wx (F,4H), wh (H,4H), b (4H)  float32 (the wrapper casts bfloat16
//     weights once, which is exact), gates along the columns in the order
//     i, f, g, o
//   h' (B,H) in h's type, c' (B,H) in c's type.
// Compute is float32: z = x.wx + h.wh + b, i, f, o = sigmoid, g = tanh,
// c' = f*c + i*g with c read as float32, h' = o*tanh(c').
//
// What bounds it: at the paper's shape (B=250, F=5, H=40) one step moves
// ~194 KB (x, h, c, the weights, h', c' in float32) and does 3.6 MFLOP,
// 0.058 us at the card's memory rate, so the latency of its one chain of
// dependent steps (the launch, one round trip to global memory, one
// barrier, K FMAs, the activations, one store) sets its time.  At H = 512
// and beyond it becomes a float32 product of B x (F+H) by (F+H) x 4H on
// the CUDA cores, whose weights every row tile reads again from L2.
//
// The design (the tiling comes from the wrapper, kernel.cell_tiling, and is
// checked here):
//   * a block owns R batch rows and U hidden units, 4U threads; thread p
//     owns gate q = p % 4 of unit j = p / 4 of its tile, i.e. column
//     q*H + j of [wx ; wh], for all R rows, so it keeps R accumulators and
//     every weight it loads serves R rows.  The four gates of a unit sit on
//     a quad of lanes and meet through __shfl_sync, as in
//     lstm_sequence.cu's recurrence: no exchange through shared memory;
//     one lane of the quad writes c', another h'.  U = H where 4H <= 512
//     (at H = 40, 160 threads, five full warps, no idle lane); above that
//     the units are cut into equal tiles of at most 128 across grid.y.
//     R is the fewest of 1, 2, 4, 8 that keeps the grid within two blocks
//     an SM where the column sits in registers (the step is latency-bound
//     and more blocks in flight hide it; at B = 250, H = 40: R = 1, 250
//     blocks, measured faster than R = 2 and 4), and within one wave where
//     it streams (every row tile reads all the weights again; at H = 512:
//     R = 8).  The old kernel ran 64 blocks of 256 threads, lanes without a
//     unit in half of them;
//   * one pass over K, one barrier: the block stages its R rows of [x | h]
//     in shared memory with plain loads (an x row of F = 5 floats is not
//     16-byte aligned) and meets one __syncthreads; where K <= kRegK each
//     thread has meanwhile loaded its whole weight column into registers,
//     every load issued before the first FMA, so the step makes one round
//     trip to global memory, not one a chunk behind four barriers.  The
//     column is a pointer walk with no branch (address arithmetic for each
//     weight behind a branch on k < F put a dozen dependent instructions
//     in front of each load).  Where K > kRegK the column streams from L2
//     kStream weights at a time, the next group's loads issued before the
//     current group's FMAs, and [x | h] is staged kStageFloats / R columns
//     at a time (one pass for K up to 1,536 at R = 8), so any H and F
//     launch.  A row of [x | h] is read from shared memory 16 bytes at a
//     time, not one 4-byte read a FMA;
//   * the sum has one fixed order, x.wx then h.wh, k ascending, then + b,
//     with no atomics: reruns are bit-identical, and the order is the old
//     kernel's.
// Tails are guarded: a row >= B or a unit >= H stages zeros and stores
// nothing, but reaches the barrier and the quad's shuffles.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <algorithm>

#include "async_copy.cuh"  // lstm::quad_mask, lstm::sigmoidf

namespace {

// a block's threads: 4U, U <= 128 units (kernel.CELL_MAX_UNITS)
constexpr int kMaxThreads = 512;
// the longest weight column a thread holds in registers (kernel.CELL_REG_K)
constexpr int kRegK = 64;
// weights a thread loads ahead of their FMAs where the column streams
constexpr int kStream = 16;
// floats of [x | h] a block stages at a time (48 KB, no opt-in needed)
constexpr int kStageFloats = 12288;
static_assert(kStageFloats / 8 % kStream == 0, "chunks of whole groups");

// element i of a float32 (bf16 false) or bfloat16 (bf16 true) array
__device__ __forceinline__ float load_any(const void* p, long long i,
                                          bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : __ldg(static_cast<const float*>(p) + i);
}
__device__ __forceinline__ void store_any(void* p, long long i, float v,
                                          bool bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

// N weights of one column of [wx ; wh] from row k on (0 from row `end`
// on), a pointer walk with no branch: `p` points at row k's weight and
// moves G floats a row, from wx's last row (F - 1) to `wh_col`, wh's first.
// On return it points at row k + N's.
template <int N>
__device__ __forceinline__ void load_column(float (&w)[N], const float*& p,
                                            int k, int end, int F,
                                            const float* wh_col, long long G) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    w[i] = k + i < end ? __ldg(p) : 0.0f;
    p = k + i + 1 == F ? wh_col : p + G;
  }
}

// Columns [k0, k0 + n) of the block's R rows of [x | h] into s_xh, row r
// at s_xh + r * ld (ld a multiple of 4, so that a row reads 16 bytes at a
// time): a thread a column, its R rows' loads in flight together.
template <int R>
__device__ __forceinline__ void stage_rows(float* s_xh, int ld, const void* x,
                                           const void* h, long long row0,
                                           int B, int F, int H, int k0, int n,
                                           int dtypes) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int k = k0 + i;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = row0 + r;
      float v = 0.0f;
      if (row < B)
        v = k < F ? load_any(x, row * F + k, dtypes & 1)
                  : load_any(h, row * H + (k - F), dtypes & 2);
      s_xh[r * ld + i] = v;
    }
  }
}

__host__ __device__ __forceinline__ int round_up4(int n) {
  return (n + 3) & ~3;
}

// acc[r] += the products of columns k .. k + 3 of row r of s_xh (a 16-byte
// read) with w0 .. w3, in that order, the first `left` of them.
template <int R>
__device__ __forceinline__ void fma4(float (&acc)[R], const float* s_xh,
                                     int ld, int k, float w0, float w1,
                                     float w2, float w3, int left) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float4 v = *reinterpret_cast<const float4*>(s_xh + r * ld + k);
    acc[r] = fmaf(v.x, w0, acc[r]);
    if (left > 1) acc[r] = fmaf(v.y, w1, acc[r]);
    if (left > 2) acc[r] = fmaf(v.z, w2, acc[r]);
    if (left > 3) acc[r] = fmaf(v.w, w3, acc[r]);
  }
}

// One step of the block's R rows and its tile of units (the design note
// above).  kRegW: the weight column in registers (K <= kRegK), else
// streamed from L2.
template <int R, bool kRegW>
__device__ __forceinline__ void cell_step(
    const void* __restrict__ x, const void* __restrict__ h,
    const void* __restrict__ c, const float* __restrict__ wx,
    const float* __restrict__ wh, const float* __restrict__ b,
    void* __restrict__ h_out, void* __restrict__ c_out, int B, int F, int H,
    int units, int dtypes) {
  // (R, a chunk of K, padded to ld): rows of [x | h]
  extern __shared__ __align__(16) float s_xh[];

  const int q = threadIdx.x & 3;
  const int j = blockIdx.y * units + (threadIdx.x >> 2);
  // the last unit tile may run past H: such a lane reads column 0 and
  // stores nothing
  const bool live = j < H;
  const int col = live ? q * H + j : 0;
  const long long G = 4LL * H;
  const int K = F + H;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;

  // the loads that do not wait for the barrier, all issued first
  const float bias = __ldg(b + col);
  float c_old[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    c_old[r] = live && row0 + r < B
                   ? load_any(c, (row0 + r) * H + j, dtypes & 4)
                   : 0.0f;
  const float* wh_col = wh + col;
  const float* p = F > 0 ? wx + col : wh_col;  // row 0 of the column

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;

  if constexpr (kRegW) {
    // the whole column in registers while the rows are staged
    float w[kRegK];
    load_column(w, p, 0, K, F, wh_col, G);
    const int ld = round_up4(K);
    stage_rows<R>(s_xh, ld, x, h, row0, B, F, H, 0, K, dtypes);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRegK; k += 4) {
      if (k < K) fma4<R>(acc, s_xh, ld, k, w[k], w[k + 1], w[k + 2],
                         w[k + 3], K - k);
    }
  } else {
    // chunks and groups both start at multiples of kStream
    const int chunk = kStageFloats / R;
    float w[kStream];
    load_column(w, p, 0, K, F, wh_col, G);
    for (int k0 = 0; k0 < K; k0 += chunk) {
      const int n = min(chunk, K - k0), ld = round_up4(n);
      if (k0 > 0) __syncthreads();  // the last chunk's reads are done
      stage_rows<R>(s_xh, ld, x, h, row0, B, F, H, k0, n, dtypes);
      __syncthreads();
      for (int kk = 0; kk < n; kk += kStream) {
        // the next group's loads go out before this group's FMAs
        float next[kStream];
        load_column(next, p, k0 + kk + kStream, K, F, wh_col, G);
#pragma unroll
        for (int i = 0; i < kStream; i += 4) {
          if (kk + i < n) fma4<R>(acc, s_xh, ld, kk + i, w[i], w[i + 1],
                                  w[i + 2], w[i + 3], n - kk - i);
        }
#pragma unroll
        for (int i = 0; i < kStream; ++i) w[i] = next[i];
      }
    }
  }

  const unsigned quad = lstm::quad_mask();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float z = acc[r] + bias;
    const float act = q == 2 ? tanhf(z) : lstm::sigmoidf(z);
    // the unit's four gates, from the four lanes of its quad
    const float ig = __shfl_sync(quad, act, 0, 4);
    const float fg = __shfl_sync(quad, act, 1, 4);
    const float gg = __shfl_sync(quad, act, 2, 4);
    const float og = __shfl_sync(quad, act, 3, 4);
    const long long row = row0 + r;
    if (live && row < B && q < 2) {
      const float c_new = fg * c_old[r] + ig * gg;
      const long long at = row * H + j;
      if (q == 0)
        store_any(h_out, at, og * tanhf(c_new), dtypes & 2);
      else
        store_any(c_out, at, c_new, dtypes & 4);
    }
  }
}

// The two kernels, one a weight path.  They differ in their launch bounds
// too: with these, ptxas spills in neither at any R (-Xptxas -v, phase 2 of
// chip_smoke.py), where one bound for both spilled one of them.
template <int R>
__global__ void __launch_bounds__(kMaxThreads)
lstm_cell_kernel(const void* __restrict__ x, const void* __restrict__ h,
                 const void* __restrict__ c, const float* __restrict__ wx,
                 const float* __restrict__ wh, const float* __restrict__ b,
                 void* __restrict__ h_out, void* __restrict__ c_out, int B,
                 int F, int H, int units, int dtypes) {
  cell_step<R, true>(x, h, c, wx, wh, b, h_out, c_out, B, F, H, units,
                     dtypes);
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_cell_kernel_streamed(const void* __restrict__ x,
                          const void* __restrict__ h,
                          const void* __restrict__ c,
                          const float* __restrict__ wx,
                          const float* __restrict__ wh,
                          const float* __restrict__ b,
                          void* __restrict__ h_out, void* __restrict__ c_out,
                          int B, int F, int H, int units, int dtypes) {
  cell_step<R, false>(x, h, c, wx, wh, b, h_out, c_out, B, F, H, units,
                      dtypes);
}

template <int R>
cudaError_t launch(const void* x, const void* h, const void* c,
                   const float* wx, const float* wh, const float* b,
                   void* h_out, void* c_out, int B, int F, int H, int dtypes,
                   int units, dim3 grid, cudaStream_t stream) {
  const int K = F + H;
  const bool reg = K <= kRegK;
  const size_t smem =
      sizeof(float) * R * round_up4(std::min(K, kStageFloats / R));
  auto kernel = reg ? lstm_cell_kernel<R> : lstm_cell_kernel_streamed<R>;
  kernel<<<grid, 4 * units, smem, stream>>>(x, h, c, wx, wh, b, h_out, c_out,
                                            B, F, H, units, dtypes);
  return cudaGetLastError();
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// Launches one step on `stream` and returns cudaGetLastError() (0 on
// success).  `dtypes` says which of x, h, c are bfloat16 (bits 0, 1, 2; a
// clear bit is float32); h' takes h's type and c' takes c's.  The tiling is
// kernel.cell_tiling's: `rows` batch rows (1, 2, 4 or 8) and `units` hidden
// units a block, `threads` = 4 * units <= 512, a grid of `grid_x` row tiles
// by `grid_y` unit tiles that covers the B rows and H units with no tile
// empty; anything else is refused (cudaErrorInvalidValue) without a launch.
int lstm_cell_forward(const void* x, const void* h, const void* c,
                      const void* wx, const void* wh, const void* b,
                      void* h_out, void* c_out, int B, int F, int H,
                      int dtypes, int rows, int units, int threads,
                      int grid_x, int grid_y, void* stream) {
  if (B <= 0) return 0;
  const bool tiling_ok =
      (rows == 1 || rows == 2 || rows == 4 || rows == 8) && units >= 1 &&
      threads == 4 * units && threads <= kMaxThreads &&
      grid_x == ceil_div(B, rows) && grid_y == ceil_div(H, units) &&
      grid_y <= 65535;
  if (F < 0 || H < 1 || dtypes < 0 || dtypes > 7 || !tiling_ok)
    return cudaErrorInvalidValue;
  const dim3 grid(grid_x, grid_y);
  const auto* w = static_cast<const float*>(wx);
  const auto* u = static_cast<const float*>(wh);
  const auto* bias = static_cast<const float*>(b);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1:
      return launch<1>(x, h, c, w, u, bias, h_out, c_out, B, F, H, dtypes,
                       units, grid, s);
    case 2:
      return launch<2>(x, h, c, w, u, bias, h_out, c_out, B, F, H, dtypes,
                       units, grid, s);
    case 4:
      return launch<4>(x, h, c, w, u, bias, h_out, c_out, B, F, H, dtypes,
                       units, grid, s);
    default:
      return launch<8>(x, h, c, w, u, bias, h_out, c_out, B, F, H, dtypes,
                       units, grid, s);
  }
}

}  // extern "C"
