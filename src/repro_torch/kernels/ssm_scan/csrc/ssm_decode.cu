// The selective scan's decode kernel: the recurrence step by step, each
// state row split across lanes, sm_90a.  See ssm_scan.cu for the function,
// the layouts and how a call picks this kernel or the chunked one.
//
// A decode step (T = 1) reads and writes the whole state, B H P N floats
// (8.4 MB at the served (B, H, P, N) = (4, 64, 64, 64)), and does 5 flops a
// float: the bytes bound it (2.5 us at 3.35 TB/s).  So the kernel is laid
// out for bandwidth: a row h[p][:] of N floats is split over L lanes (L the
// power of two >= N/4, 16 at N = 64), each lane keeping 4 consecutive
// floats in registers, read and written with one 16-byte access where the
// rows allow.  A block is 256 threads, 256/L rows of one (batch, head): 1024
// blocks at the served shape, one wave of 8,192 warps, where one block of P
// threads per (batch, head) ran 256 blocks of 2 warps.  Every step:
//   u = dt x_p;  h[p][n] = exp(dt a) h[p][n] + u b_n   (the lane's 4 n)
//   y_p = sum_n h[p][n] c_n + d x_p
// the lane's partial sum of its 4 products in n order, then the L lanes'
// partials added by an xor butterfly (offsets L/2, ..., 1), whose result in
// the row's first lane is written; ref.ssm_decode_rows_ref is this order.
// No atomics: reruns are bit-identical.  Every thread reads its part of
// state0 before its first write of state_out, and no two threads share an
// element, so the two may alias.  Short T steps the same way, the state
// staying in registers (a call of T <= kernel.DECODE_MAX_T takes this
// kernel).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDecodeThreads = 256;

__device__ __forceinline__ void load4(const float* p, int n0, int N,
                                      bool vec, float (&v)[4]) {
  if (vec) {
    if (n0 < N) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = f.x;
      v[1] = f.y;
      v[2] = f.z;
      v[3] = f.w;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.0f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = n0 + i < N ? __ldg(p + i) : 0.0f;
  }
}

__global__ void __launch_bounds__(kDecodeThreads)
ssm_decode_kernel(const float* __restrict__ x, const float* __restrict__ b,
                  const float* __restrict__ c, const float* __restrict__ dt,
                  const float* __restrict__ a, const float* __restrict__ d,
                  const float* state0, float* __restrict__ y,
                  float* state_out, int T, int H, int P, int N, int lanes,
                  int vec) {
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int rows = kDecodeThreads / lanes;
  const int r = threadIdx.x / lanes, lr = threadIdx.x % lanes;
  const int p = blockIdx.x * rows + r;
  const int n0 = 4 * lr;
  const bool row_ok = p < P;
  const float ah = a[hh], dh = d[hh];
  const size_t sidx =
      ((static_cast<size_t>(bb) * H + hh) * P + (row_ok ? p : 0)) * N + n0;

  float hs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (state0 != nullptr && row_ok) {
    if (vec && n0 < N) {
      const float4 f = *reinterpret_cast<const float4*>(state0 + sidx);
      hs[0] = f.x;
      hs[1] = f.y;
      hs[2] = f.z;
      hs[3] = f.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) hs[i] = n0 + i < N ? state0[sidx + i] : 0.0f;
    }
  }
  for (int t = 0; t < T; ++t) {
    const size_t st = static_cast<size_t>(bb) * T + t;  // step (bb, t)
    const float dtv = __ldg(dt + st * H + hh);
    const float xv = row_ok ? __ldg(x + (st * H + hh) * P + p) : 0.0f;
    float bv[4], cv[4];
    load4(b + st * N + n0, n0, N, vec, bv);
    load4(c + st * N + n0, n0, N, vec, cv);
    const float decay = expf(dtv * ah);
    const float u = dtv * xv;
#pragma unroll
    for (int i = 0; i < 4; ++i) hs[i] = decay * hs[i] + u * bv[i];
    float part = hs[0] * cv[0];
#pragma unroll
    for (int i = 1; i < 4; ++i) part += hs[i] * cv[i];
    for (int off = lanes >> 1; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lr == 0 && row_ok) y[(st * H + hh) * P + p] = part + dh * xv;
  }
  if (row_ok) {
    if (vec && n0 < N) {
      *reinterpret_cast<float4*>(state_out + sidx) =
          make_float4(hs[0], hs[1], hs[2], hs[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (n0 + i < N) state_out[sidx + i] = hs[i];
    }
  }
}

// The lanes a state row is split over: the power of two >= N / 4.
int decode_lanes(int N) {
  int lanes = 1;
  while (4 * lanes < N) lanes *= 2;
  return lanes;
}

}  // namespace

// Launches the decode kernel on `stream`; returns cudaGetLastError().
// vec: b, c and the states 16-byte aligned with N a multiple of 4.
cudaError_t ssm_decode_launch(const float* x, const float* b, const float* c,
                              const float* dt, const float* a, const float* d,
                              const float* state0, float* y, float* state_out,
                              int B, int T, int H, int P, int N, bool vec,
                              cudaStream_t stream) {
  const int lanes = decode_lanes(N);
  const int rows = kDecodeThreads / lanes;
  const dim3 grid((P + rows - 1) / rows, H, B);
  ssm_decode_kernel<<<grid, kDecodeThreads, 0, stream>>>(
      x, b, c, dt, a, d, state0, y, state_out, T, H, P, N, lanes,
      vec ? 1 : 0);
  return cudaGetLastError();
}
