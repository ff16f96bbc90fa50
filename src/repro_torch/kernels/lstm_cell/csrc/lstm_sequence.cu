// Whole-sequence LSTM forward for Hopper (sm_90a): one recurrence, two
// kernels that differ only in what they write:
//   lstm_serve_fwd_kernel  x (S,B,T,F) -> final (h, c)              (serving)
//   lstm_train_fwd_kernel  x (S,B,T,F) -> gates, c_seq, h_seq       (training)
// over a stream axis S: a fleet of S independent LSTMs, each with its own
// weights, in one launch (the reference batches its pallas_call under
// jax.vmap, which adds a grid axis).  A single LSTM is the S = 1 case.
//
// They replace the Pallas TPU kernels
//   src/repro/kernels/lstm_cell/kernel.py: lstm_sequence_fused (_sequence_kernel)
//   src/repro/kernels/lstm_cell/kernel.py: lstm_sequence_fwd_train
//                                          (_sequence_train_kernel).
//
// Layouts are the reference's with a leading stream axis, row-major and
// contiguous:
//   x  (S, B, T, F) float32 or bfloat16
//   wx (S, F, 4H)   float32, gates along the columns in the order i, f, g, o
//   wh (S, H, 4H)   float32, same column layout
//   b  (S, 4H)      float32
//   h_out, c_out (S, B, H) in x's type                       (serving)
//   gates (S, B, T, 4H), c_seq (S, B, T, H), h_seq (S, B, T, H) float32
//   (training):
//     the post-activation gates i, f, g, o and the cell and hidden state of
//     every step, the residuals the backward (lstm_sequence_bwd.cu) reads.
// Compute is float32 throughout; only the serving outputs are rounded to x's
// type.
//
// What bounds them: at the paper's shapes (B of 64 to 2048, T=5, F=5, H=40)
// a call is a few MFLOP over a few hundred KB, well under a microsecond of
// the card's float32 or memory rate, so the latency of the serial T-step
// chain, of staging the weights and of the launch sets the time.
//
// The design (lstm_forward_row, shared by both kernels):
//   * one batch row of one stream a block, 4H threads, the grid (B, S): 250
//     blocks a stream at the serving path's B=250, 64 at a speed fit's
//     B=64, so a fleet of 8 speed fits fills 512 blocks where one filled 64
//     of the 132 SMs; a block takes its stream's weights and its row of
//     the S*B rows, and the per-stream sums are those of an S = 1 launch;
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
// The training kernel writes the residuals as they are made: each thread its
// gate, one lane of the quad c and another h.  The serving kernel writes
// only the final (h, c), one lane of the quad each; it shares this design
// because one in which a thread chained the 4(F+H) FMAs of a unit's four
// gates a step through shared memory, x read inside the chain, was slower
// on the device than cuDNN's LSTM.  Reruns are bit-identical: every sum has
// one fixed order, the training kernel's
// (ref.lstm_sequence_fwd_train_tiled_ref).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

// dynamic shared memory one block may use on Hopper (227 KB)
constexpr size_t kSmemLimit = 232448;
// steps whose input projection a thread holds in registers: the time loop
// runs in chunks of this many steps
constexpr int kTrainChunk = 8;
// a block's threads, 4H rounded up to whole warps: H <= 128
constexpr int kMaxThreads = 512;
// the longest column of wh a thread holds in registers
constexpr int kRegH = 64;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// A block's shared memory: the mbarrier (16 bytes, which keeps what follows
// 16-byte aligned), wx, wh and b (each a multiple of 16 bytes, as
// cp.async.bulk needs), h double-buffered, and with stage_x a chunk of x.
size_t smem_bytes(int F, int H, bool stage_x) {
  const size_t G = 4 * static_cast<size_t>(H);
  return 16 + sizeof(float) * ((F + H) * G + G + 2 * static_cast<size_t>(H) +
                               (stage_x ? static_cast<size_t>(kTrainChunk) * F
                                        : 0));
}

// Whether a thread holds its column of wh in registers: H <= kRegH, and H a
// multiple of 4 (16-byte loads of h).
bool registers_hold_wh(int H) { return H <= kRegH && H % 4 == 0; }

// The recurrence of one batch row, ``row`` of the (S*B) rows of x, gates,
// c_seq, h_seq, h_out and c_out (stream s's row r is row s*B + r; wx, wh
// and b come already offset to the row's stream): a 1-d block of 4H
// threads (rounded up to whole warps), thread p owning gate q = p % 4 of
// unit j = p / 4, i.e. column q*H + j of the gates.  kRegW: the thread loads its column of wh
// from global memory into registers as the block starts (only wx and b go
// through the bulk copy) and reads h 16 bytes at a time; otherwise wh comes
// to shared memory with them and every step reads it there.  kResiduals:
// write every step's gates, c and h (training); otherwise only the final
// (h, c) in x's type (serving).
template <typename Tin, bool kRegW, bool kResiduals>
__device__ __forceinline__ void lstm_forward_row(
    const Tin* __restrict__ x, const float* __restrict__ wx,
    const float* __restrict__ wh, const float* __restrict__ b,
    float* __restrict__ gates, float* __restrict__ c_seq,
    float* __restrict__ h_seq, Tin* __restrict__ h_out,
    Tin* __restrict__ c_out, long long row, int T, int F, int H,
    int stage_x) {
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
    float* gate_out = nullptr;
    float* state_out = nullptr;
    if constexpr (kResiduals) {
      const long long rt0 = row * T + t0;
      gate_out = gates + rt0 * G + col;
      state_out = (q == 1 ? c_seq : h_seq) + rt0 * H + j;
    }
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
        if constexpr (kResiduals) {
          gate_out[s * G] = act;
          if (q == 1) state_out[s * H] = c;
          if (q == 2) state_out[s * H] = h;
        }
      }
      cur ^= 1;
      // h of this step is complete before the next reads it, and every
      // read of buffer `cur` is done before the next step overwrites it
      __syncthreads();
    }
  }
  if constexpr (!kResiduals) {
    if (has_row && q == 0) store(h_out + row * H + j, h);
    if (has_row && q == 1) store(c_out + row * H + j, c);
  }
}

// The two kernels: one batch row (blockIdx.x) of one stream (blockIdx.y) a
// block, the same recurrence.  Each takes both kinds of output pointer and
// writes only its own.  The row's data is row blockIdx.y * B + blockIdx.x
// of the streams' rows taken together, so the pointers to it stay kernel
// parameters (offsetting them in registers made the register-held-wh
// instances spill); only the weights, read once as the block starts, are
// offset to the stream.  A stream's slice of wx, wh or b is 16F*H, 16H*H or
// 16H bytes, so a 16-byte aligned base keeps every stream's bulk copies
// aligned.  kStreams = false is the S = 1 instance of the same body, the
// stream index a constant 0: even the few registers of the offsets cost a
// single-stream launch 1-2 us on the card at 128 registers a thread.
template <typename Tin, bool kRegW, bool kStreams>
__global__ void __launch_bounds__(kMaxThreads) lstm_train_fwd_kernel(
    const Tin* __restrict__ x, const float* __restrict__ wx,
    const float* __restrict__ wh, const float* __restrict__ b,
    float* __restrict__ gates, float* __restrict__ c_seq,
    float* __restrict__ h_seq, Tin* __restrict__ h_out,
    Tin* __restrict__ c_out, int B, int T, int F, int H, int stage_x) {
  const long long s = kStreams ? blockIdx.y : 0, G = 4 * H;
  lstm_forward_row<Tin, kRegW, true>(
      x, wx + s * F * G, wh + s * H * G, b + s * G, gates, c_seq, h_seq,
      h_out, c_out, s * B + blockIdx.x, T, F, H, stage_x);
}

template <typename Tin, bool kRegW, bool kStreams>
__global__ void __launch_bounds__(kMaxThreads) lstm_serve_fwd_kernel(
    const Tin* __restrict__ x, const float* __restrict__ wx,
    const float* __restrict__ wh, const float* __restrict__ b,
    float* __restrict__ gates, float* __restrict__ c_seq,
    float* __restrict__ h_seq, Tin* __restrict__ h_out,
    Tin* __restrict__ c_out, int B, int T, int F, int H, int stage_x) {
  const long long s = kStreams ? blockIdx.y : 0, G = 4 * H;
  lstm_forward_row<Tin, kRegW, false>(
      x, wx + s * F * G, wh + s * H * G, b + s * G, gates, c_seq, h_seq,
      h_out, c_out, s * B + blockIdx.x, T, F, H, stage_x);
}

// Launches one of the two kernels over the streams' batch rows on `stream`
// and returns cudaGetLastError().
template <typename Tin, bool kRegW, bool kResiduals, bool kStreams>
cudaError_t launch_as(int S, int B, int T, int F, int H, cudaStream_t stream,
                      const void* x, const float* wx, const float* wh,
                      const float* b, float* gates, float* c_seq,
                      float* h_seq, void* h_out, void* c_out) {
  const bool stage_x = smem_bytes(F, H, true) <= kSmemLimit;
  const size_t smem = smem_bytes(F, H, stage_x);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = kResiduals ? lstm_train_fwd_kernel<Tin, kRegW, kStreams>
                           : lstm_serve_fwd_kernel<Tin, kRegW, kStreams>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = (4 * H + 31) / 32 * 32;
  kernel<<<dim3(B, S), threads, smem, stream>>>(
      static_cast<const Tin*>(x), wx, wh, b, gates, c_seq, h_seq,
      static_cast<Tin*>(h_out), static_cast<Tin*>(c_out), B, T, F, H,
      stage_x ? 1 : 0);
  return cudaGetLastError();
}

// The instance for S: the S = 1 one where S is 1.
template <typename Tin, bool kRegW, bool kResiduals>
cudaError_t launch_streams(int S, int B, int T, int F, int H,
                           cudaStream_t stream, const void* x, const float* wx,
                           const float* wh, const float* b, float* gates,
                           float* c_seq, float* h_seq, void* h_out,
                           void* c_out) {
  return S > 1 ? launch_as<Tin, kRegW, kResiduals, true>(
                     S, B, T, F, H, stream, x, wx, wh, b, gates, c_seq, h_seq,
                     h_out, c_out)
               : launch_as<Tin, kRegW, kResiduals, false>(
                     S, B, T, F, H, stream, x, wx, wh, b, gates, c_seq, h_seq,
                     h_out, c_out);
}

template <bool kResiduals>
cudaError_t launch(int S, int B, int T, int F, int H, int x_is_bf16,
                   cudaStream_t stream, const void* x, const void* wx,
                   const void* wh, const void* b, float* gates, float* c_seq,
                   float* h_seq, void* h_out, void* c_out) {
  const float* w[3] = {static_cast<const float*>(wx),
                       static_cast<const float*>(wh),
                       static_cast<const float*>(b)};
  const bool reg = registers_hold_wh(H);
  if (x_is_bf16) {
    return reg ? launch_streams<__nv_bfloat16, true, kResiduals>(
                     S, B, T, F, H, stream, x, w[0], w[1], w[2], gates, c_seq,
                     h_seq, h_out, c_out)
               : launch_streams<__nv_bfloat16, false, kResiduals>(
                     S, B, T, F, H, stream, x, w[0], w[1], w[2], gates, c_seq,
                     h_seq, h_out, c_out);
  }
  return reg ? launch_streams<float, true, kResiduals>(
                   S, B, T, F, H, stream, x, w[0], w[1], w[2], gates, c_seq,
                   h_seq, h_out, c_out)
             : launch_streams<float, false, kResiduals>(
                   S, B, T, F, H, stream, x, w[0], w[1], w[2], gates, c_seq,
                   h_seq, h_out, c_out);
}

// The streams a launch may take: gridDim.y
constexpr int kMaxStreams = 65535;

// The checks both entry points share: 0, or the error to return.  The
// stacked bases must be 16-byte aligned; every stream's slice then is.
int check_call(int S, int T, int F, int H, const void* wx, const void* wh,
               const void* b) {
  if (S > kMaxStreams || T < 1 || F < 1 || H < 1 || 4 * H > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!lstm::aligned16(wx) || !lstm::aligned16(wh) || !lstm::aligned16(b))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the forward kernels needs at (F, H)
// at the least (x not staged).
long long lstm_sequence_smem_bytes(int F, int H) {
  return static_cast<long long>(smem_bytes(F, H, false));
}

// The serving kernel over S streams: the final (h, c) (S,B,H) in x's type.
// x_is_bf16 selects bfloat16 x and outputs; otherwise all are float32.  wx,
// wh and b must be 16-byte aligned (the bulk copies).  Launches nothing at
// S = 0 or B = 0; otherwise launches on `stream` and returns
// cudaGetLastError() (0 on success).
int lstm_sequence_forward(const void* x, const void* wx, const void* wh,
                          const void* b, void* h_out, void* c_out, int S,
                          int B, int T, int F, int H, int x_is_bf16,
                          void* stream) {
  if (S <= 0 || B <= 0) return 0;
  if (const int err = check_call(S, T, F, H, wx, wh, b)) return err;
  return static_cast<int>(launch<false>(
      S, B, T, F, H, x_is_bf16, static_cast<cudaStream_t>(stream), x, wx, wh,
      b, nullptr, nullptr, nullptr, h_out, c_out));
}

// The training kernel over S streams: gates (S,B,T,4H), c_seq and h_seq
// (S,B,T,H), float32, whatever x's type.  wx, wh and b must be 16-byte
// aligned (the bulk copies).  Launches nothing at S = 0 or B = 0; otherwise
// launches on `stream` and returns cudaGetLastError().
int lstm_sequence_forward_train(const void* x, const void* wx, const void* wh,
                                const void* b, void* gates, void* c_seq,
                                void* h_seq, int S, int B, int T, int F,
                                int H, int x_is_bf16, void* stream) {
  if (S <= 0 || B <= 0) return 0;
  if (const int err = check_call(S, T, F, H, wx, wh, b)) return err;
  return static_cast<int>(launch<true>(
      S, B, T, F, H, x_is_bf16, static_cast<cudaStream_t>(stream), x, wx, wh,
      b, static_cast<float*>(gates), static_cast<float*>(c_seq),
      static_cast<float*>(h_seq), nullptr, nullptr));
}

}  // extern "C"
