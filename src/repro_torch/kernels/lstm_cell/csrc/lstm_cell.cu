// One fused LSTM step for Hopper (sm_90a):
//   lstm_cell_kernel  x (B,F), h (B,H), c (B,H) -> h' (B,H), c' (B,H)
//
// It replaces the Pallas TPU kernel
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
// 0.058 us at the card's memory rate, so a launch's latency sets its time.
//
// The design: a step has no time loop, so nothing needs the weights resident
// for long, and it takes any H that fits in device memory (the sequence
// kernels hold all (F+H)*4H weights in one block's shared memory, which at
// F=5 stops at H=117).  The grid runs over (row tile, hidden-unit tile); a
// block owns kRows rows and kUnits units.  Thread (r, j) computes the four
// gate pre-activations of unit j of row r, from columns j, H+j, 2H+j and
// 3H+j of [wx ; wh], so the gate combine needs no exchange between threads.
// The reduction depth K = F + H is walked kChunk at a time: the block stages
// its rows of [x | h] (kRows x kChunk) and the chunk of its four weight
// column slices (4 x kChunk x kUnits) in shared memory, neighbouring threads
// on neighbouring columns (coalesced loads; a warp is one row, so its read
// of [x | h] is a broadcast and its reads of the weights are conflict-free).
// Tails are guarded: a row >= B or a unit >= H loads zeros and stores
// nothing, but reaches every __syncthreads.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kUnits = 32;  // hidden units a block owns: a warp across them
constexpr int kRows = 8;    // batch rows a block owns: a warp each
constexpr int kChunk = 32;  // reduction depth staged at a time
constexpr int kThreads = kUnits * kRows;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// expf/tanhf, not the fast intrinsics: the port is held to 2e-5 of float32.
__device__ __forceinline__ float sigmoidf(float z) {
  return 1.0f / (1.0f + expf(-z));
}

template <typename Tx, typename Th, typename Tc>
__global__ void __launch_bounds__(kThreads)
lstm_cell_kernel(const Tx* __restrict__ x, const Th* __restrict__ h,
                 const Tc* __restrict__ c, const float* __restrict__ wx,
                 const float* __restrict__ wh, const float* __restrict__ b,
                 Th* __restrict__ h_out, Tc* __restrict__ c_out, int B,
                 int F, int H) {
  __shared__ float s_xh[kRows][kChunk];           // rows of [x | h]
  __shared__ float s_w[4][kChunk][kUnits];        // gate q's column slice

  const int u = threadIdx.x;  // unit within the tile
  const int r = threadIdx.y;  // row within the tile
  const int tid = r * kUnits + u;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int j0 = blockIdx.y * kUnits;
  const long long row = row0 + r;
  const int j = j0 + u;
  const long long G = 4LL * H;
  const int K = F + H;

  float zi = 0.0f, zf = 0.0f, zg = 0.0f, zo = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    for (int i = tid; i < kRows * kChunk; i += kThreads) {
      const int kk = i % kChunk;
      const long long grow = row0 + i / kChunk;
      const int k = k0 + kk;
      float v = 0.0f;
      if (grow < B && k < K) {
        v = k < F ? load_f32(x + grow * F + k)
                  : load_f32(h + grow * H + (k - F));
      }
      s_xh[i / kChunk][kk] = v;
    }
    for (int i = tid; i < 4 * kChunk * kUnits; i += kThreads) {
      const int uu = i % kUnits;
      const int kk = (i / kUnits) % kChunk;
      const int q = i / (kUnits * kChunk);
      const int k = k0 + kk;
      const int jj = j0 + uu;
      float v = 0.0f;
      if (k < K && jj < H) {
        const long long col = static_cast<long long>(q) * H + jj;
        v = k < F ? __ldg(wx + k * G + col) : __ldg(wh + (k - F) * G + col);
      }
      s_w[q][kk][uu] = v;
    }
    __syncthreads();
    const int depth = K - k0 < kChunk ? K - k0 : kChunk;
    for (int kk = 0; kk < depth; ++kk) {
      const float v = s_xh[r][kk];
      zi = fmaf(v, s_w[0][kk][u], zi);
      zf = fmaf(v, s_w[1][kk][u], zf);
      zg = fmaf(v, s_w[2][kk][u], zg);
      zo = fmaf(v, s_w[3][kk][u], zo);
    }
    // every read of this chunk is done before the next one is staged
    __syncthreads();
  }

  if (row < B && j < H) {
    const float ig = sigmoidf(zi + __ldg(b + j));
    const float fg = sigmoidf(zf + __ldg(b + H + j));
    const float gg = tanhf(zg + __ldg(b + 2 * H + j));
    const float og = sigmoidf(zo + __ldg(b + 3 * H + j));
    const long long at = row * H + j;
    const float c_new = fg * load_f32(c + at) + ig * gg;
    store(c_out + at, c_new);
    store(h_out + at, og * tanhf(c_new));
  }
}

// Launches the kernel for one choice of the three state types on `stream`
// and returns cudaGetLastError().
template <typename Tx, typename Th, typename Tc>
cudaError_t launch(const void* x, const void* h, const void* c,
                   const float* wx, const float* wh, const float* b,
                   void* h_out, void* c_out, int B, int F, int H,
                   cudaStream_t stream) {
  const dim3 block(kUnits, kRows);
  const dim3 grid((B + kRows - 1) / kRows, (H + kUnits - 1) / kUnits);
  lstm_cell_kernel<Tx, Th, Tc><<<grid, block, 0, stream>>>(
      static_cast<const Tx*>(x), static_cast<const Th*>(h),
      static_cast<const Tc*>(c), wx, wh, b, static_cast<Th*>(h_out),
      static_cast<Tc*>(c_out), B, F, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one step on `stream` and returns cudaGetLastError() (0 on
// success).  `dtypes` says which of x, h, c are bfloat16 (bits 0, 1, 2; a
// clear bit is float32); h' takes h's type and c' takes c's.
int lstm_cell_forward(const void* x, const void* h, const void* c,
                      const void* wx, const void* wh, const void* b,
                      void* h_out, void* c_out, int B, int F, int H,
                      int dtypes, void* stream) {
  if (B <= 0) return 0;
  if (F < 0 || H < 1 || (H + kUnits - 1) / kUnits > 65535 || dtypes < 0 ||
      dtypes > 7)
    return cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  using Launch = cudaError_t (*)(const void*, const void*, const void*,
                                 const float*, const float*, const float*,
                                 void*, void*, int, int, int, cudaStream_t);
  // indexed by `dtypes`
  constexpr Launch kLaunch[8] = {
      launch<float, float, float>, launch<bf16, float, float>,
      launch<float, bf16, float>,  launch<bf16, bf16, float>,
      launch<float, float, bf16>,  launch<bf16, float, bf16>,
      launch<float, bf16, bf16>,   launch<bf16, bf16, bf16>};
  return static_cast<int>(kLaunch[dtypes](
      x, h, c, static_cast<const float*>(wx), static_cast<const float*>(wh),
      static_cast<const float*>(b), h_out, c_out, B, F, H,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
