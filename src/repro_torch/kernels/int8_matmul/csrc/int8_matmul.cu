// Weight-only int8 dequantizing matmul for Hopper (sm_90a), over a stream
// axis S (a fleet of S independent products, each with its own weights; one
// product is S = 1):
//   y[s] (M, N) = (x[s] (M, K) @ q[s] (K, N)) * scale[s] (N)
//
// It replaces the Pallas TPU kernel
//   src/repro/kernels/int8_matmul/kernel.py: int8_matmul (_kernel).
//
// Layouts are the reference's with a leading stream axis, row-major and
// contiguous:
//   x     (S, M, K) float32 or bfloat16, converted to float32 on load
//   q     (S, K, N) int8, kept int8 in global and shared memory and
//                   converted to float32 in registers right before the FMA
//   scale (S, N)    float32, the per-output-channel scale
//   y     (S, M, N) in x's type
// The grid is (row tiles, column tiles, S); a block of stream s
// (blockIdx.z) reads rows s*M.. of x (the streams' rows taken together) and
// rows s*K.. of q, and writes rows s*M.. of y, so one stream's sums are
// those of an S = 1 launch.
// The sum over K is float32, and the scale multiplies it once per output,
// after the K loop, never per weight.  Any M, K and N: the ragged edges are
// guarded in the loads and the stores, the inputs are never padded.
//
// What bounds it: on the serving path (B = 250 windows of T = 5 steps,
// F = 5, H = 40) the products are (1250, 5, 160), (250, 40, 160) and
// (250, 40, 10): a few MFLOP over a few hundred KB, a fraction of a
// microsecond at the card's memory or float32 rate, so latency sets the
// time: one round trip to device memory, the FMAs of one output's K, one
// store, in as many blocks as the card takes at once.  PR 13's 64 x 64 tiles
// launched 12, 40 and 4 blocks at those shapes, each walking K in 32-deep
// stages with two barriers a stage.  Here the tiles fit the shapes: 16 x 32
// outputs a block of 128 threads, a thread 4 neighbouring columns of one
// row (80 blocks at (250, 40, 160), 395 at (1250, 5, 160)), and for N <= 16
// 2 x 16 outputs a block of 32 threads, a thread one output (125 blocks at
// (250, 40, 10)).  The whole K is staged at once when K <= 64 (every shape
// on the path; deeper K in 64-deep stages): x as float32 rows, q converted
// from int8 to float32 once per staged element, not once per FMA.  The FMAs
// are float32 on the CUDA cores in k order: weight-only int8 with float
// activations cannot use the int8 tensor cores (IMMA needs int8 on both
// sides), and the port keeps float32 numerics, so there is no mma here.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kKT = 64;  // depth staged at once: the whole K on the path

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// A block takes BM x BN outputs, a thread one row of TN neighbouring
// columns (TN 1 or 4).  kStreams = false is the S = 1 instance of the same
// body (the stream index a constant 0): even the stream's row offsets cost a
// single-stream launch ~0.3 us on the card.
template <typename T, int BM, int BN, int TN, bool kStreams>
__global__ void __launch_bounds__(BM * BN / TN)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, T* __restrict__ y, int M,
                   int K, int N) {
  constexpr int kThreads = BM * BN / TN;
  constexpr int kGroups = BN / TN;  // column groups a row
  // x rows at a padded stride (a warp reads up to 4 rows at once); q as
  // float32, converted once here
  __shared__ float xs[BM][kKT + 1];
  __shared__ __align__(16) float qs[kKT][BN];

  const long long z = kStreams ? blockIdx.z : 0;
  const long long xrow0 = z * M, qrow0 = z * K;
  const int tid = threadIdx.x;
  const int row = tid / kGroups, cg = tid % kGroups;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) acc[j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kKT) {
    const int depth = min(kKT, K - k0);
    if (k0 > 0) __syncthreads();  // the last stage is read by all
    // neighbouring threads load neighbouring elements of a row of x and q
    for (int e = tid; e < BM * depth; e += kThreads) {
      const int r = e / depth, c = e - r * depth;
      const int gm = m0 + r;
      xs[r][c] = gm < M ? load_f32(x + (xrow0 + gm) * K + k0 + c) : 0.0f;
    }
    for (int e = tid; e < depth * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int gn = n0 + c;
      qs[r][c] = gn < N ? static_cast<float>(q[(qrow0 + k0 + r) * N + gn])
                        : 0.0f;
    }
    __syncthreads();
    for (int kk = 0; kk < depth; ++kk) {
      const float a = xs[row][kk];
      if constexpr (TN == 4) {
        const float4 b = *reinterpret_cast<const float4*>(&qs[kk][4 * cg]);
        acc[0] = fmaf(a, b.x, acc[0]);
        acc[1] = fmaf(a, b.y, acc[1]);
        acc[2] = fmaf(a, b.z, acc[2]);
        acc[3] = fmaf(a, b.w, acc[3]);
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[j] = fmaf(a, qs[kk][TN * cg + j], acc[j]);
      }
    }
  }

  const int m = m0 + row;
  if (m >= M) return;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + TN * cg + j;
    if (n < N)
      store(y + (xrow0 + m) * N + n,
            acc[j] * __ldg(scale + z * N + n));
  }
}

template <typename T, int BM, int BN, int TN, bool kStreams>
cudaError_t launch_tiles(const void* x, const void* q, const void* scale,
                         void* y, int S, int M, int K, int N,
                         cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, S);
  int8_matmul_kernel<T, BM, BN, TN, kStreams>
      <<<grid, BM * BN / TN, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<T*>(y), M, K, N);
  return cudaGetLastError();
}

// 2 x 16 tiles of single outputs for N <= 16, else 16 x 32 tiles; the
// S = 1 instances where S is 1
template <typename T, bool kStreams>
cudaError_t launch_streams(const void* x, const void* q, const void* scale,
                           void* y, int S, int M, int K, int N,
                           cudaStream_t stream) {
  return N <= 16 ? launch_tiles<T, 2, 16, 1, kStreams>(x, q, scale, y, S, M,
                                                       K, N, stream)
                 : launch_tiles<T, 16, 32, 4, kStreams>(x, q, scale, y, S, M,
                                                        K, N, stream);
}

template <typename T>
cudaError_t launch(const void* x, const void* q, const void* scale, void* y,
                   int S, int M, int K, int N, cudaStream_t stream) {
  return S > 1
             ? launch_streams<T, true>(x, q, scale, y, S, M, K, N, stream)
             : launch_streams<T, false>(x, q, scale, y, S, M, K, N, stream);
}

}  // namespace

extern "C" {

// The S products of a stream axis in one launch on `stream`; returns
// cudaGetLastError() (0 on success), and launches nothing at S = 0 or
// M = 0.  x_is_bf16 selects bfloat16 x and y; otherwise both are float32.
int int8_matmul_forward(const void* x, const void* q, const void* scale,
                        void* y, int S, int M, int K, int N, int x_is_bf16,
                        void* stream) {
  if (S <= 0 || M <= 0) return 0;
  if (S > 65535 || K < 1 || N < 1 || (N + 31) / 32 > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      x_is_bf16 ? launch<__nv_bfloat16>(x, q, scale, y, S, M, K, N, s)
                : launch<float>(x, q, scale, y, S, M, K, N, s));
}

}  // extern "C"
