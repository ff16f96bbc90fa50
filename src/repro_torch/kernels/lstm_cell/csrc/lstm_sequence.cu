// Whole-sequence LSTM forward for Hopper (sm_90a), in two variants that share
// one body:
//   lstm_sequence_kernel        x (B,T,F) -> final (h, c)            (serving)
//   lstm_sequence_train_kernel  x (B,T,F) -> gates, c_seq, h_seq     (training)
//
// They replace the Pallas TPU kernels
//   src/repro/kernels/lstm_cell/kernel.py: lstm_sequence_fused (_sequence_kernel)
//   src/repro/kernels/lstm_cell/kernel.py: lstm_sequence_fwd_train
//                                          (_sequence_train_kernel).
//
// Layouts are the reference's, row-major and contiguous:
//   x  (B, T, F) float32 or bfloat16
//   wx (F, 4H)   float32, gates along the columns in the order i, f, g, o
//   wh (H, 4H)   float32, same column layout
//   b  (4H)      float32
//   h_out, c_out (B, H) in x's type                       (serving)
//   gates (B, T, 4H), c_seq (B, T, H), h_seq (B, T, H) float32  (training):
//     the post-activation gates i, f, g, o and the cell and hidden state of
//     every step, the residuals the backward (lstm_sequence_bwd.cu) reads.
// Compute is float32 throughout; only the serving outputs are rounded to x's
// type.
//
// What bounds it: at the paper's shape (B=250, T=5, F=5, H=40) one call is
// 18 MFLOP over ~134 KB (the training variant writes B*T*6H*4 bytes more,
// 307 KB at B=64), well under a microsecond of the card's float32 or memory
// rate, so launch latency and the serial T-step chain set the time.
// The design keeps everything after the first load on chip: each block
// stages wx, wh and b in shared memory once ((F+H)*4H*4 bytes, 28.8 KB at
// H=40), runs all T steps with h double-buffered in shared memory and c in a
// register, and writes only the final (h, c), or, in training, each step's
// residuals (coalesced: neighbouring threads own neighbouring units).  One
// thread owns one (batch row, hidden unit) and computes that unit's four
// gate pre-activations; the R rows of a block are a tile of the batch, and
// the last tile is guarded row by row (rows >= B do no work but still reach
// every __syncthreads).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreadsPerBlock = 256;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// expf/tanhf, not the fast intrinsics: the port is held to 1e-5 of float32.
__device__ __forceinline__ float sigmoidf(float z) {
  return 1.0f / (1.0f + expf(-z));
}

// Rows of the batch one block takes: as many as fit kThreadsPerBlock threads
// of H each, at least one.
int rows_per_block(int H) {
  int r = kThreadsPerBlock / H;
  return r < 1 ? 1 : r;
}

size_t smem_bytes(int F, int H) {
  const size_t G = 4 * static_cast<size_t>(H);
  const size_t R = static_cast<size_t>(rows_per_block(H));
  // wx, wh, b, then h double-buffered for R rows
  return sizeof(float) * ((F + H) * G + G + 2 * R * H);
}

// The recurrence both kernels run.  kEmitResiduals selects the outputs: the
// final (h, c) in x's type, or every step's gates, c and h in float32; the
// arithmetic is the same.
template <typename Tin, bool kEmitResiduals>
__device__ __forceinline__ void sequence_forward(
    const Tin* __restrict__ x, const float* __restrict__ wx,
    const float* __restrict__ wh, const float* __restrict__ b,
    Tin* __restrict__ h_out, Tin* __restrict__ c_out,
    float* __restrict__ gates, float* __restrict__ c_seq,
    float* __restrict__ h_seq, int B, int T, int F, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int R = blockDim.y;
  float* s_wx = smem;            // (F, 4H)
  float* s_wh = s_wx + F * G;    // (H, 4H)
  float* s_b = s_wh + H * G;     // (4H)
  float* s_h = s_b + G;          // (2, R, H)

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < F * G; i += nthreads) s_wx[i] = wx[i];
  for (int i = tid; i < H * G; i += nthreads) s_wh[i] = wh[i];
  for (int i = tid; i < G; i += nthreads) s_b[i] = b[i];
  for (int i = tid; i < R * H; i += nthreads) s_h[i] = 0.0f;
  __syncthreads();

  const int j = threadIdx.x;   // hidden unit
  const int r = threadIdx.y;   // row within the tile
  const long long row = static_cast<long long>(blockIdx.x) * R + r;
  const bool active = row < B;

  float h = 0.0f, c = 0.0f;
  int cur = 0;
  for (int t = 0; t < T; ++t) {
    if (active) {
      float zi = s_b[j], zf = s_b[H + j], zg = s_b[2 * H + j],
            zo = s_b[3 * H + j];
      const Tin* xt = x + (row * T + t) * F;
      for (int k = 0; k < F; ++k) {
        const float xv = load_f32(xt + k);
        const float* w = s_wx + k * G;
        zi += xv * w[j];
        zf += xv * w[H + j];
        zg += xv * w[2 * H + j];
        zo += xv * w[3 * H + j];
      }
      const float* hp = s_h + (cur * R + r) * H;
      for (int k = 0; k < H; ++k) {
        const float hv = hp[k];
        const float* w = s_wh + k * G;
        zi += hv * w[j];
        zf += hv * w[H + j];
        zg += hv * w[2 * H + j];
        zo += hv * w[3 * H + j];
      }
      const float ig = sigmoidf(zi), fg = sigmoidf(zf), gg = tanhf(zg),
                  og = sigmoidf(zo);
      c = fg * c + ig * gg;
      h = og * tanhf(c);
      s_h[((cur ^ 1) * R + r) * H + j] = h;
      if constexpr (kEmitResiduals) {
        const long long rt = row * T + t;
        float* g4 = gates + rt * G;
        g4[j] = ig;
        g4[H + j] = fg;
        g4[2 * H + j] = gg;
        g4[3 * H + j] = og;
        c_seq[rt * H + j] = c;
        h_seq[rt * H + j] = h;
      }
    }
    cur ^= 1;
    // every read of buffer `cur` this step is done before the next step
    // overwrites it
    __syncthreads();
  }
  if constexpr (!kEmitResiduals) {
    if (active) {
      store(h_out + row * H + j, h);
      store(c_out + row * H + j, c);
    }
  }
}

template <typename Tin>
__global__ void lstm_sequence_kernel(const Tin* __restrict__ x,
                                     const float* __restrict__ wx,
                                     const float* __restrict__ wh,
                                     const float* __restrict__ b,
                                     Tin* __restrict__ h_out,
                                     Tin* __restrict__ c_out,
                                     int B, int T, int F, int H) {
  sequence_forward<Tin, false>(x, wx, wh, b, h_out, c_out, nullptr, nullptr,
                               nullptr, B, T, F, H);
}

template <typename Tin>
__global__ void lstm_sequence_train_kernel(const Tin* __restrict__ x,
                                           const float* __restrict__ wx,
                                           const float* __restrict__ wh,
                                           const float* __restrict__ b,
                                           float* __restrict__ gates,
                                           float* __restrict__ c_seq,
                                           float* __restrict__ h_seq,
                                           int B, int T, int F, int H) {
  sequence_forward<Tin, true>(x, wx, wh, b, nullptr, nullptr, gates, c_seq,
                              h_seq, B, T, F, H);
}

// Launches `kernel` over the batch tiles of (B, F, H) on `stream` and returns
// cudaGetLastError().
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int B, int F, int H, cudaStream_t stream,
                   Args... args) {
  const int R = rows_per_block(H);
  const size_t smem = smem_bytes(F, H);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 block(H, R);
  const dim3 grid((B + R - 1) / R);
  kernel<<<grid, block, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the kernel needs for (F, H).
long long lstm_sequence_smem_bytes(int F, int H) {
  return static_cast<long long>(smem_bytes(F, H));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x_is_bf16 selects bfloat16 x and outputs; otherwise all are float32.
int lstm_sequence_forward(const void* x, const void* wx, const void* wh,
                          const void* b, void* h_out, void* c_out, int B,
                          int T, int F, int H, int x_is_bf16, void* stream) {
  if (B <= 0) return 0;
  if (T < 1 || F < 1 || H < 1 || H > 1024) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w[3] = {static_cast<const float*>(wx),
                       static_cast<const float*>(wh),
                       static_cast<const float*>(b)};
  const cudaError_t err =
      x_is_bf16
          ? launch(lstm_sequence_kernel<__nv_bfloat16>, B, F, H, s,
                   static_cast<const __nv_bfloat16*>(x), w[0], w[1], w[2],
                   static_cast<__nv_bfloat16*>(h_out),
                   static_cast<__nv_bfloat16*>(c_out), B, T, F, H)
          : launch(lstm_sequence_kernel<float>, B, F, H, s,
                   static_cast<const float*>(x), w[0], w[1], w[2],
                   static_cast<float*>(h_out), static_cast<float*>(c_out), B,
                   T, F, H);
  return static_cast<int>(err);
}

// The training variant: gates (B,T,4H), c_seq and h_seq (B,T,H), float32,
// whatever x's type.  Launches on `stream` and returns cudaGetLastError().
int lstm_sequence_forward_train(const void* x, const void* wx, const void* wh,
                                const void* b, void* gates, void* c_seq,
                                void* h_seq, int B, int T, int F, int H,
                                int x_is_bf16, void* stream) {
  if (B <= 0) return 0;
  if (T < 1 || F < 1 || H < 1 || H > 1024) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w[3] = {static_cast<const float*>(wx),
                       static_cast<const float*>(wh),
                       static_cast<const float*>(b)};
  float* out[3] = {static_cast<float*>(gates), static_cast<float*>(c_seq),
                   static_cast<float*>(h_seq)};
  const cudaError_t err =
      x_is_bf16
          ? launch(lstm_sequence_train_kernel<__nv_bfloat16>, B, F, H, s,
                   static_cast<const __nv_bfloat16*>(x), w[0], w[1], w[2],
                   out[0], out[1], out[2], B, T, F, H)
          : launch(lstm_sequence_train_kernel<float>, B, F, H, s,
                   static_cast<const float*>(x), w[0], w[1], w[2], out[0],
                   out[1], out[2], B, T, F, H);
  return static_cast<int>(err);
}

}  // extern "C"
