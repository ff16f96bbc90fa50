// Whole-sequence LSTM forward for Hopper (sm_90a), two kernels:
//   lstm_sequence_kernel   x (B,T,F) -> final (h, c)                (serving)
//   lstm_train_fwd_kernel  x (B,T,F) -> gates, c_seq, h_seq         (training)
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
// What bounds them: at the paper's shapes (B of 64 to 256, T=5, F=5, H=40)
// a call is a few MFLOP over a few hundred KB, well under a microsecond of
// the card's float32 or memory rate, so the latency of the serial T-step
// chain, of staging the weights and of the launch sets the time.
//
// The serving kernel: each block stages wx, wh and b in shared memory once
// ((F+H)*4H*4 bytes, 28.8 KB at H=40) with a per-thread load loop, runs all
// T steps with h double-buffered in shared memory and c in a register, and
// writes only the final (h, c).  One thread owns one (batch row, hidden
// unit) and computes that unit's four gate pre-activations; the R = 256/H
// rows of a block are a tile of the batch, the last tile guarded row by row.
//
// The training kernel is built for the short, narrow steps of a speed fit
// (B=64, 4H=160), where the serving design ran 11 blocks whose every thread
// chained 4(F+H) FMAs a step:
//   * one batch row a block, 4H threads: 64 blocks at B=64, 256 at B=256;
//   * one thread owns one gate column, so its serial chain is the H FMAs
//     of h.wh a step; the four gates of a unit sit on four neighbouring
//     lanes (a quad) and meet through __shfl_sync, so a step needs one
//     __syncthreads (for h, double-buffered in shared memory), not two;
//   * the input projection b + x.wx has no time dependence: each thread
//     computes it for a chunk of up to kTrainChunk steps into registers
//     before the recurrence, which then carries only h.wh;
//   * one thread stages wx and b with cp.async.bulk onto one mbarrier
//     (async_copy.cuh) while the others stage the chunk's x in shared
//     memory with plain loads (x is not 16-byte aligned in general); where
//     H is a multiple of 4 and at most kRegH, each thread loads its column
//     of wh straight into registers as the block starts and reads h 16
//     bytes at a time (a bulk copy of wh to shared memory, then a copy into
//     registers, was slower on the card); otherwise wh comes with the bulk
//     copy and every step reads it from shared memory.
// The residuals are written as they are made: each thread its gate, one lane
// of the quad c and another h.  Reruns are bit-identical: every sum has one
// fixed order.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kThreadsPerBlock = 256;
// dynamic shared memory one block may use on Hopper (227 KB)
constexpr size_t kSmemLimit = 232448;
// steps whose input projection a thread of the training kernel holds in
// registers: its time loop runs in chunks of this many steps
constexpr int kTrainChunk = 8;
constexpr int kTrainMaxThreads = 512;
// the longest column of wh a thread of the training kernel holds in
// registers
constexpr int kRegH = 64;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Rows of the batch one block of the serving kernel takes: as many as fit
// kThreadsPerBlock threads of H each, at least one.
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

// The training kernel's shared memory: the mbarrier (16 bytes, which keeps
// what follows 16-byte aligned), wx, wh and b (each a multiple of 16 bytes,
// as cp.async.bulk needs), h double-buffered, and with stage_x a chunk of x.
// Without x it is no more than the serving kernel's, so every H the serving
// kernel takes fits.
size_t train_smem_bytes(int F, int H, bool stage_x) {
  const size_t G = 4 * static_cast<size_t>(H);
  return 16 + sizeof(float) * ((F + H) * G + G + 2 * static_cast<size_t>(H) +
                               (stage_x ? static_cast<size_t>(kTrainChunk) * F
                                        : 0));
}

// Whether a thread of the training kernel holds its column of wh in
// registers: H <= kRegH, and H a multiple of 4 (16-byte loads of h).
bool registers_hold_wh(int H) { return H <= kRegH && H % 4 == 0; }

// The serving recurrence: the final (h, c) in x's type.
template <typename Tin>
__global__ void lstm_sequence_kernel(const Tin* __restrict__ x,
                                     const float* __restrict__ wx,
                                     const float* __restrict__ wh,
                                     const float* __restrict__ b,
                                     Tin* __restrict__ h_out,
                                     Tin* __restrict__ c_out,
                                     int B, int T, int F, int H) {
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
      const float ig = lstm::sigmoidf(zi), fg = lstm::sigmoidf(zf),
                  gg = tanhf(zg), og = lstm::sigmoidf(zo);
      c = fg * c + ig * gg;
      h = og * tanhf(c);
      s_h[((cur ^ 1) * R + r) * H + j] = h;
    }
    cur ^= 1;
    // every read of buffer `cur` this step is done before the next step
    // overwrites it
    __syncthreads();
  }
  if (active) {
    store(h_out + row * H + j, h);
    store(c_out + row * H + j, c);
  }
}

// The training recurrence of one batch row: a 1-d block of 4H threads
// (rounded up to whole warps), thread p owning gate q = p % 4 of unit
// j = p / 4, i.e. column q*H + j of the gates.  kRegW: the thread loads its
// column of wh from global memory into registers as the block starts (only
// wx and b go through the bulk copy) and reads h 16 bytes at a time;
// otherwise wh comes to shared memory with them and every step reads it
// there.
template <typename Tin, bool kRegW>
__global__ void __launch_bounds__(kTrainMaxThreads) lstm_train_fwd_kernel(
    const Tin* __restrict__ x, const float* __restrict__ wx,
    const float* __restrict__ wh, const float* __restrict__ b,
    float* __restrict__ gates, float* __restrict__ c_seq,
    float* __restrict__ h_seq, int T, int F, int H, int stage_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = 4 * H;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  float* s_wx = reinterpret_cast<float*>(smem_raw + 16);  // (F, 4H)
  float* s_wh = s_wx + F * G;                 // (H, 4H), unless kRegW
  float* s_b = s_wh + H * G;                  // (4H)
  float* s_h = s_b + G;                       // (2, H)
  float* s_x = s_h + 2 * H;                   // (kTrainChunk, F)

  const int tid = threadIdx.x;
  if (tid == 0) {
    lstm::mbar_init(bar, 1);
    const uint32_t wx_bytes = 4u * F * G, wh_bytes = kRegW ? 0u : 4u * H * G,
                   b_bytes = 4u * G;
    lstm::mbar_arrive_expect_tx(bar, wx_bytes + wh_bytes + b_bytes);
    lstm::bulk_copy_g2s(s_wx, wx, wx_bytes, bar);
    if (!kRegW) lstm::bulk_copy_g2s(s_wh, wh, wh_bytes, bar);
    lstm::bulk_copy_g2s(s_b, b, b_bytes, bar);
  }

  // threads past 4H only keep the warps whole: they meet every barrier
  const bool has_row = tid < G;
  const int j = tid >> 2, q = tid & 3;
  const int col = q * H + j;
  const long long row = blockIdx.x;
  const unsigned quad = lstm::quad_mask();

  float w[kRegW ? kRegH : 1];  // wh[:, col]
  if (kRegW) {
#pragma unroll
    for (int k = 0; k < kRegH; ++k)
      w[k] = has_row && k < H ? __ldg(wh + k * G + col) : 0.0f;
  }

  float h = 0.0f, c = 0.0f;
  int cur = 0;
  for (int t0 = 0; t0 < T; t0 += kTrainChunk) {
    const int n = min(kTrainChunk, T - t0);
    // this chunk's x into shared memory (or, where it does not fit, read
    // from global memory below): on the first chunk while the weights arrive
    if (stage_x) {
      for (int i = tid; i < n * F; i += blockDim.x)
        s_x[i] = load_f32(x + (row * T + t0) * F + i);
    }
    __syncthreads();  // x staged; on the first chunk the barrier's init
    if (t0 == 0) lstm::mbar_wait(bar, 0);
    // the input projection of the chunk, off the serial chain:
    // xw = b + sum_k x_k wx[k, col]
    float xw[kTrainChunk];
    const float bias = has_row ? s_b[col] : 0.0f;
#pragma unroll
    for (int s = 0; s < kTrainChunk; ++s) xw[s] = bias;
    for (int k = 0; k < F; ++k) {
      const float wk = has_row ? s_wx[k * G + col] : 0.0f;
      float xv[kTrainChunk];
#pragma unroll
      for (int s = 0; s < kTrainChunk; ++s)
        xv[s] = !(s < n && has_row) ? 0.0f
                : stage_x ? s_x[s * F + k]
                          : load_f32(x + (row * T + t0 + s) * F + k);
#pragma unroll
      for (int s = 0; s < kTrainChunk; ++s) xw[s] += xv[s] * wk;
    }
    // the steps, a runtime loop: xw shifts down one register a step
    const long long rt0 = row * T + t0;
    float* gate_out = gates + rt0 * G + col;
    float* state_out = (q == 1 ? c_seq : h_seq) + rt0 * H + j;
#pragma unroll 1
    for (int s = 0; s < n; ++s) {
      const float xw_s = xw[0];
#pragma unroll
      for (int i = 0; i + 1 < kTrainChunk; ++i) xw[i] = xw[i + 1];
      if (has_row) {
        // z = xw + h.wh[:, col]; h is zero at t = 0
        float a0 = xw_s, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
        if (t0 + s > 0) {
          const float* hp = s_h + cur * H;
          if (kRegW) {
#pragma unroll
            for (int i = 0; i < kRegH / 4; ++i) {
              if (4 * i < H) {
                const float4 hv = reinterpret_cast<const float4*>(hp)[i];
                a0 += hv.x * w[4 * i];
                a1 += hv.y * w[4 * i + 1];
                a2 += hv.z * w[4 * i + 2];
                a3 += hv.w * w[4 * i + 3];
              }
            }
          } else {
            const float* ws = s_wh + col;
            int k = 0;
            for (; k + 4 <= H; k += 4) {
              a0 += hp[k] * ws[k * G];
              a1 += hp[k + 1] * ws[(k + 1) * G];
              a2 += hp[k + 2] * ws[(k + 2) * G];
              a3 += hp[k + 3] * ws[(k + 3) * G];
            }
            for (; k < H; ++k) a0 += hp[k] * ws[k * G];
          }
        }
        const float z = (a0 + a1) + (a2 + a3);
        const float act = q == 2 ? tanhf(z) : lstm::sigmoidf(z);
        // the unit's four gates, from the four lanes of its quad
        const float ig = __shfl_sync(quad, act, 0, 4);
        const float fg = __shfl_sync(quad, act, 1, 4);
        const float gg = __shfl_sync(quad, act, 2, 4);
        const float og = __shfl_sync(quad, act, 3, 4);
        c = fg * c + ig * gg;
        h = og * tanhf(c);
        if (q == 0) s_h[(cur ^ 1) * H + j] = h;
        gate_out[s * G] = act;
        if (q == 1) state_out[s * H] = c;
        if (q == 2) state_out[s * H] = h;
      }
      cur ^= 1;
      // h of this step is complete before the next reads it, and every
      // read of buffer `cur` is done before the next step overwrites it
      __syncthreads();
    }
  }
}

// Launches the serving kernel over the batch tiles of (B, F, H) on `stream`
// and returns cudaGetLastError().
template <typename Tin>
cudaError_t launch_serving(int B, int T, int F, int H, cudaStream_t stream,
                           const void* x, const float* wx, const float* wh,
                           const float* b, void* h_out, void* c_out) {
  const int R = rows_per_block(H);
  const size_t smem = smem_bytes(F, H);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lstm_sequence_kernel<Tin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  lstm_sequence_kernel<Tin><<<(B + R - 1) / R, dim3(H, R), smem, stream>>>(
      static_cast<const Tin*>(x), wx, wh, b, static_cast<Tin*>(h_out),
      static_cast<Tin*>(c_out), B, T, F, H);
  return cudaGetLastError();
}

template <typename Tin, bool kRegW>
cudaError_t launch_train_as(int B, int T, int F, int H, cudaStream_t stream,
                            const void* x, const float* wx, const float* wh,
                            const float* b, float* gates, float* c_seq,
                            float* h_seq) {
  const bool stage_x = train_smem_bytes(F, H, true) <= kSmemLimit;
  const size_t smem = train_smem_bytes(F, H, stage_x);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lstm_train_fwd_kernel<Tin, kRegW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = (4 * H + 31) / 32 * 32;
  lstm_train_fwd_kernel<Tin, kRegW><<<B, threads, smem, stream>>>(
      static_cast<const Tin*>(x), wx, wh, b, gates, c_seq, h_seq, T, F, H,
      stage_x ? 1 : 0);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t launch_train(int B, int T, int F, int H, cudaStream_t stream,
                         const void* x, const float* wx, const float* wh,
                         const float* b, float* gates, float* c_seq,
                         float* h_seq) {
  return registers_hold_wh(H)
             ? launch_train_as<Tin, true>(B, T, F, H, stream, x, wx, wh, b,
                                          gates, c_seq, h_seq)
             : launch_train_as<Tin, false>(B, T, F, H, stream, x, wx, wh, b,
                                           gates, c_seq, h_seq);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the serving kernel needs for (F, H);
// the training kernel needs no more.
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
      x_is_bf16 ? launch_serving<__nv_bfloat16>(B, T, F, H, s, x, w[0], w[1],
                                                w[2], h_out, c_out)
                : launch_serving<float>(B, T, F, H, s, x, w[0], w[1], w[2],
                                        h_out, c_out);
  return static_cast<int>(err);
}

// The training kernel: gates (B,T,4H), c_seq and h_seq (B,T,H), float32,
// whatever x's type.  wx, wh and b must be 16-byte aligned (the bulk
// copies).  Launches on `stream` and returns cudaGetLastError().
int lstm_sequence_forward_train(const void* x, const void* wx, const void* wh,
                                const void* b, void* gates, void* c_seq,
                                void* h_seq, int B, int T, int F, int H,
                                int x_is_bf16, void* stream) {
  if (B <= 0) return 0;
  if (T < 1 || F < 1 || H < 1 || 4 * H > kTrainMaxThreads)
    return cudaErrorInvalidValue;
  if (!lstm::aligned16(wx) || !lstm::aligned16(wh) || !lstm::aligned16(b))
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w[3] = {static_cast<const float*>(wx),
                       static_cast<const float*>(wh),
                       static_cast<const float*>(b)};
  float* out[3] = {static_cast<float*>(gates), static_cast<float*>(c_seq),
                   static_cast<float*>(h_seq)};
  const cudaError_t err =
      x_is_bf16 ? launch_train<__nv_bfloat16>(B, T, F, H, s, x, w[0], w[1],
                                              w[2], out[0], out[1], out[2])
                : launch_train<float>(B, T, F, H, s, x, w[0], w[1], w[2],
                                      out[0], out[1], out[2]);
  return static_cast<int>(err);
}

}  // extern "C"
