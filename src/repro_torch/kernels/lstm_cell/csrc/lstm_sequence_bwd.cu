// Whole-sequence LSTM backward for Hopper (sm_90a), in two kernels:
//   lstm_sequence_bwd_kernel    reverse-time loop: dh, dc of the final state
//                               -> dx (B,T,F) and dz (B,T,4H), the gradient
//                               of every step's gate pre-activations
//   lstm_sequence_wgrad_kernel  dz, x, h_seq -> dwx (F,4H), dwh (H,4H), db (4H)
//
// Together they replace the Pallas TPU kernel
//   src/repro/kernels/lstm_cell/kernel.py: lstm_sequence_bwd
//                                          (_sequence_bwd_kernel).
//
// Inputs are the primal x (B,T,F) in float32 or bfloat16 and the residuals
// of the training forward (lstm_sequence.cu): post-activation gates
// (B,T,4H) in the order i, f, g, o, c_seq and h_seq (B,T,H), all float32;
// wx (F,4H) and wh (H,4H); dh and dc (B,H), the cotangents of the final
// (h, c).  Every output is float32.  At t = 0, h_prev and c_prev are zero.
//
// The reference sums the weight gradients over its batch grid into one
// output block, which works only because the TPU runs the grid in order.
// Blocks on Hopper run concurrently, and float atomics would add in an order
// that changes from run to run.  So the reverse-time kernel writes dz to a
// workspace, and the second kernel reduces it with one thread per element of
// (dwx, dwh, db), each looping over the B*T rows in a fixed order: reruns
// are bit-identical.
//
// What bounds them: at the speed-training shape (B=64, T=5, F=5, H=40) the
// pair does ~8.5 MFLOP over ~0.4 MB of inputs and outputs (plus the 0.2 MB
// dz workspace, written once and read once), well under a microsecond of the
// card's float32 or memory rate; the serial T-step chain, the serial B*T
// loop of the reduce and two launches set the time.
//
// Design of the reverse-time kernel: as the forward, one block per tile of R
// batch rows and one thread per (row, hidden unit j); wx and wh in shared
// memory; dh and dc of unit j in registers.  Each step a thread forms the
// four dz of its unit from the residuals and puts them in shared memory; after
// a barrier it computes dh_j = sum_col dz[col] * wh[j, col] (and dx for
// unit indices below F) from its row's dz.  Thread j reading row j of wh
// would hit one bank across a warp when 4H is a multiple of 32 (4H = 160 at
// H=40), so the weight rows are stored with a stride of 4H+1 floats.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreadsPerBlock = 256;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Rows of the batch one block of the reverse-time kernel takes, as in the
// forward.
int rows_per_block(int H) {
  int r = kThreadsPerBlock / H;
  return r < 1 ? 1 : r;
}

size_t smem_bytes(int F, int H) {
  const size_t G = 4 * static_cast<size_t>(H);
  const size_t R = static_cast<size_t>(rows_per_block(H));
  // wx and wh with padded rows, then dz for R rows
  return sizeof(float) * ((F + H) * (G + 1) + R * G);
}

__global__ void lstm_sequence_bwd_kernel(const float* __restrict__ gates,
                                         const float* __restrict__ c_seq,
                                         const float* __restrict__ wx,
                                         const float* __restrict__ wh,
                                         const float* __restrict__ dh_in,
                                         const float* __restrict__ dc_in,
                                         float* __restrict__ dx,
                                         float* __restrict__ dz,
                                         int B, int T, int F, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int S = G + 1;           // padded row stride of the weights
  const int R = blockDim.y;
  float* s_wx = smem;            // (F, S)
  float* s_wh = s_wx + F * S;    // (H, S)
  float* s_dz = s_wh + H * S;    // (R, G)

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < F * G; i += nthreads) s_wx[(i / G) * S + i % G] = wx[i];
  for (int i = tid; i < H * G; i += nthreads) s_wh[(i / G) * S + i % G] = wh[i];
  __syncthreads();

  const int j = threadIdx.x;   // hidden unit
  const int r = threadIdx.y;   // row within the tile
  const long long row = static_cast<long long>(blockIdx.x) * R + r;
  const bool active = row < B;
  float* sd = s_dz + r * G;

  float dh = 0.0f, dc = 0.0f;
  if (active) {
    dh = dh_in[row * H + j];
    dc = dc_in[row * H + j];
  }
  for (int t = T - 1; t >= 0; --t) {
    const long long rt = row * T + t;
    float fg = 0.0f, dct = 0.0f;
    if (active) {
      const float* g4 = gates + rt * G;
      const float ig = g4[j];
      fg = g4[H + j];
      const float gg = g4[2 * H + j], og = g4[3 * H + j];
      const float c_t = c_seq[rt * H + j];
      const float c_prev = t > 0 ? c_seq[(rt - 1) * H + j] : 0.0f;
      const float tanh_c = tanhf(c_t);
      const float d_o = dh * tanh_c;
      dct = dc + dh * og * (1.0f - tanh_c * tanh_c);
      const float dzi = dct * gg * ig * (1.0f - ig);
      const float dzf = dct * c_prev * fg * (1.0f - fg);
      const float dzg = dct * ig * (1.0f - gg * gg);
      const float dzo = d_o * og * (1.0f - og);
      sd[j] = dzi;
      sd[H + j] = dzf;
      sd[2 * H + j] = dzg;
      sd[3 * H + j] = dzo;
      float* gd = dz + rt * G;
      gd[j] = dzi;
      gd[H + j] = dzf;
      gd[2 * H + j] = dzg;
      gd[3 * H + j] = dzo;
    }
    // the row's dz is complete before any thread reads it
    __syncthreads();
    if (active) {
      const float* w = s_wh + j * S;
      float acc = 0.0f;
      for (int col = 0; col < G; ++col) acc += sd[col] * w[col];
      dh = acc;
      dc = dct * fg;
      for (int k = j; k < F; k += H) {
        const float* wk = s_wx + k * S;
        float a = 0.0f;
        for (int col = 0; col < G; ++col) a += sd[col] * wk[col];
        dx[rt * F + k] = a;
      }
    }
    // every read of this step's dz is done before the next step writes it
    __syncthreads();
  }
}

// One thread per element of (dwx, dwh, db), laid out as rows k of
// [wx; wh; b] times columns col of the 4H gates: neighbouring threads take
// neighbouring columns, so the dz loads of a warp are coalesced and the x or
// h load is a broadcast.  Each sums over the B*T rows in order.
template <typename Tin>
__global__ void lstm_sequence_wgrad_kernel(const Tin* __restrict__ x,
                                           const float* __restrict__ h_seq,
                                           const float* __restrict__ dz,
                                           float* __restrict__ dwx,
                                           float* __restrict__ dwh,
                                           float* __restrict__ db,
                                           int B, int T, int F, int H) {
  const int G = 4 * H;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= static_cast<long long>(F + H + 1) * G) return;
  const int k = static_cast<int>(e / G);
  const int col = static_cast<int>(e % G);
  const long long rows = static_cast<long long>(B) * T;
  float acc = 0.0f;
  if (k < F) {
    for (long long rt = 0; rt < rows; ++rt)
      acc += load_f32(x + rt * F + k) * __ldg(dz + rt * G + col);
    dwx[k * G + col] = acc;
  } else if (k < F + H) {
    const int kk = k - F;
    // h_prev of step t is h_seq[t-1]; it is zero at t = 0
    for (long long rb = 0; rb < rows; rb += T)
      for (int t = 1; t < T; ++t)
        acc += __ldg(h_seq + (rb + t - 1) * H + kk) *
               __ldg(dz + (rb + t) * G + col);
    dwh[kk * G + col] = acc;
  } else {
    for (long long rt = 0; rt < rows; ++rt) acc += __ldg(dz + rt * G + col);
    db[col] = acc;
  }
}

template <typename Tin>
cudaError_t launch(const void* x, const void* gates, const void* c_seq,
                   const void* h_seq, const void* wx, const void* wh,
                   const void* dh, const void* dc, void* dx, void* dz,
                   void* dwx, void* dwh, void* db, int B, int T, int F, int H,
                   cudaStream_t stream) {
  if (B > 0) {
    const int R = rows_per_block(H);
    const size_t smem = smem_bytes(F, H);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          lstm_sequence_bwd_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    lstm_sequence_bwd_kernel<<<(B + R - 1) / R, dim3(H, R), smem, stream>>>(
        static_cast<const float*>(gates), static_cast<const float*>(c_seq),
        static_cast<const float*>(wx), static_cast<const float*>(wh),
        static_cast<const float*>(dh), static_cast<const float*>(dc),
        static_cast<float*>(dx), static_cast<float*>(dz), B, T, F, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long n_out = static_cast<long long>(F + H + 1) * 4 * H;
  const int blocks =
      static_cast<int>((n_out + kThreadsPerBlock - 1) / kThreadsPerBlock);
  lstm_sequence_wgrad_kernel<Tin><<<blocks, kThreadsPerBlock, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<const float*>(h_seq),
      static_cast<const float*>(dz), static_cast<float*>(dwx),
      static_cast<float*>(dwh), static_cast<float*>(db), B, T, F, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the reverse-time kernel needs for (F, H).
long long lstm_sequence_bwd_smem_bytes(int F, int H) {
  return static_cast<long long>(smem_bytes(F, H));
}

// Launches both kernels on `stream`, in order, and returns the first
// cudaGetLastError() that is not 0 (0 on success).  dz is a (B,T,4H) float32
// workspace.  x_is_bf16 selects a bfloat16 x; everything else is float32.
int lstm_sequence_backward(const void* x, const void* gates,
                           const void* c_seq, const void* h_seq,
                           const void* wx, const void* wh, const void* dh,
                           const void* dc, void* dx, void* dz, void* dwx,
                           void* dwh, void* db, int B, int T, int F, int H,
                           int x_is_bf16, void* stream) {
  if (B < 0 || T < 1 || F < 1 || H < 1 || H > 1024)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_is_bf16
          ? launch<__nv_bfloat16>(x, gates, c_seq, h_seq, wx, wh, dh, dc, dx,
                                  dz, dwx, dwh, db, B, T, F, H, s)
          : launch<float>(x, gates, c_seq, h_seq, wx, wh, dh, dc, dx, dz,
                          dwx, dwh, db, B, T, F, H, s);
  return static_cast<int>(err);
}

}  // extern "C"
