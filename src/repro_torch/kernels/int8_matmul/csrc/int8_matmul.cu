// Weight-only int8 dequantizing matmul for Hopper (sm_90a):
//   y (M, N) = (x (M, K) @ q (K, N)) * scale (N)
//
// It replaces the Pallas TPU kernel
//   src/repro/kernels/int8_matmul/kernel.py: int8_matmul (_kernel).
//
// Layouts are the reference's, row-major and contiguous:
//   x     (M, K) float32 or bfloat16, converted to float32 on load
//   q     (K, N) int8, kept int8 in global and shared memory and converted
//                to float32 in registers right before the FMA
//   scale (N)    float32, the per-output-channel scale
//   y     (M, N) in x's type
// The sum over K is float32, and the scale multiplies it once per output,
// after the K loop, never per weight.  Any M, K and N: the ragged edges are
// guarded in the loads and the stores, the inputs are never padded.
//
// What bounds it: on the serving path (B = 250 windows of T = 5 steps,
// F = 5, H = 40) the products are (1250, 5, 160), (250, 40, 160) and
// (250, 40, 10): a few MFLOP over a few hundred KB, a fraction of a
// microsecond at the card's memory or float32 rate, so launch latency sets
// the time.  The design is the simple tiled one: one block of 256 threads
// per 64 x 64 output tile, each thread a 4 x 4 register tile; the K loop
// stages a 64 x 32 tile of x (float32, transposed, at a padded stride
// against bank conflicts) and a 32 x 64 tile of q (int8, read as one 4-byte
// word per thread and step) in shared memory; the FMAs are float32 on the
// CUDA cores.  Weight-only int8 with float activations cannot use the int8
// tensor cores (IMMA needs int8 on both sides), and the port keeps float32
// numerics, so there is no mma here.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;  // rows of x (and y) per block
constexpr int kBN = 64;  // columns of q (and y) per block
constexpr int kBK = 32;  // depth of one staged tile
constexpr int kTM = 4;   // rows per thread
constexpr int kTN = 4;   // columns per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, T* __restrict__ y, int M,
                   int K, int N) {
  // x tile transposed (k-major) so a thread's 4 rows are 4 neighbouring
  // words; the +1 keeps the transposing stores free of bank conflicts
  __shared__ float xs[kBK][kBM + 1];
  __shared__ __align__(16) int8_t qs[kBK][kBN];

  const int tid = threadIdx.x;
  const int tn = tid % (kBN / kTN);  // column group of this thread
  const int tm = tid / (kBN / kTN);  // row group of this thread
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // neighbouring threads load neighbouring elements of a row of x and q
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int gm = m0 + r, gk = k0 + c;
      xs[c][r] = (gm < M && gk < K)
                     ? load_f32(x + static_cast<long long>(gm) * K + gk)
                     : 0.0f;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int r = e / kBN, c = e % kBN;
      const int gk = k0 + r, gn = n0 + c;
      qs[r][c] = (gk < K && gn < N) ? q[static_cast<long long>(gk) * N + gn]
                                    : static_cast<int8_t>(0);
    }
    __syncthreads();
    const int depth = min(kBK, K - k0);
    for (int kk = 0; kk < depth; ++kk) {
      const char4 w = *reinterpret_cast<const char4*>(&qs[kk][tn * kTN]);
      const float b[kTN] = {static_cast<float>(w.x), static_cast<float>(w.y),
                            static_cast<float>(w.z), static_cast<float>(w.w)};
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float a = xs[kk][tm * kTM + i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int n = n0 + tn * kTN + j;
    if (n >= N) continue;
    const float s = __ldg(scale + n);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int m = m0 + tm * kTM + i;
      if (m < M) store(y + static_cast<long long>(m) * N + n, acc[i][j] * s);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* q, const void* scale, void* y,
                   int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  int8_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<T*>(y), M, K, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x_is_bf16 selects bfloat16 x and y; otherwise both are float32.
int int8_matmul_forward(const void* x, const void* q, const void* scale,
                        void* y, int M, int K, int N, int x_is_bf16,
                        void* stream) {
  if (M <= 0) return 0;
  if (K < 1 || N < 1 || (N + kBN - 1) / kBN > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      x_is_bf16 ? launch<__nv_bfloat16>(x, q, scale, y, M, K, N, s)
                : launch<float>(x, q, scale, y, M, K, N, s));
}

}  // extern "C"
