// The WKV scan's decode kernel: the recurrence step by step, each state
// column split across lanes, sm_90a.  See rwkv6_scan.cu for the function,
// the layouts and how a call picks this kernel or the chunked one.
//
// A decode step (T = 1) reads and writes the whole state, B H N^2 floats
// (2.6 MB each way at the served (B, H, N) = (4, 40, 64)), and does ~5
// flops a float: the bytes bound it (1.6 us at 3.35 TB/s).  So the kernel
// is laid out for bandwidth: a thread keeps a 4 x 4 tile of S, rows
// 4 l .. 4 l + 3 and columns 4 c .. 4 c + 3, read and written as four
// 16-byte rows where the layout allows; the rows of a column are split over
// L lanes (L the power of two >= N/4, 16 at N = 64), the lane index the low
// bits of the thread's.  A block is 64 threads (faster on the card than 128
// or 256): 640 blocks and 40,960 threads at the served shape, where one
// block of N threads per (batch, head) ran 160 blocks and 10,240 threads.
// Every step, for the thread's columns j and rows i:
//   y_j  = sum_i r_i (S[i][j] + (u_i k_i) v_j)
//   S[i][j] = w_i S[i][j] + k_i v_j
// the thread's partial sum of its 4 rows in i order, then the L lanes'
// partials added by an xor butterfly (offsets L/2, ..., 1), whose result in
// the column group's first lane is written; ref.wkv_decode_rows_ref is this
// order.  No atomics: reruns are bit-identical.  Every thread reads its
// elements of state0 before it writes the same elements of state_out, and
// no two threads share one, so the two may alias.  Short T steps the same
// way, the state staying in registers (a call of T <= kernel.DECODE_MAX_T
// takes this kernel).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDecodeThreads = 64;

// 4 floats at p (index n0 of a row of N), zeros past N
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
rwkv6_decode_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u, const float* state0,
                    float* __restrict__ y, float* state_out, int T, int H,
                    int N, int lanes, int vec) {
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int il = threadIdx.x % lanes;
  const int jg = blockIdx.x * (kDecodeThreads / lanes) + threadIdx.x / lanes;
  const int i0 = 4 * il, j0 = 4 * jg;
  const bool cols = j0 < N;
  const size_t sbase = (static_cast<size_t>(bb) * H + hh) * N * N;

  float s[4][4];  // s[a][c] = S[i0 + a][j0 + c]
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + a;
    if (state0 != nullptr && i < N && cols) {
      load4(state0 + sbase + static_cast<size_t>(i) * N + j0, j0, N, vec,
            s[a]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.0f;
    }
  }
  float ua[4];
  load4(u + static_cast<size_t>(hh) * N + i0, i0, N, vec, ua);

  for (int t = 0; t < T; ++t) {
    const size_t row = ((static_cast<size_t>(bb) * T + t) * H + hh) * N;
    float ra[4], ka[4], wa[4], vc[4];
    load4(r + row + i0, i0, N, vec, ra);
    load4(k + row + i0, i0, N, vec, ka);
    load4(w + row + i0, i0, N, vec, wa);
    load4(v + row + (cols ? j0 : 0), j0, N, vec, vc);
    float part[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      part[c] = ra[0] * (s[0][c] + (ua[0] * ka[0]) * vc[c]);
#pragma unroll
      for (int a = 1; a < 4; ++a)
        part[c] = fmaf(ra[a], s[a][c] + (ua[a] * ka[a]) * vc[c], part[c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = wa[a] * s[a][c] + ka[a] * vc[c];
    for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        part[c] += __shfl_xor_sync(0xffffffffu, part[c], off);
    }
    if (il == 0 && cols) {
      float* dst = y + row + j0;
      if (vec) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(part[0], part[1], part[2], part[3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (j0 + c < N) dst[c] = part[c];
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + a;
    if (i < N && cols) {
      float* dst = state_out + sbase + static_cast<size_t>(i) * N + j0;
      if (vec) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(s[a][0], s[a][1], s[a][2], s[a][3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (j0 + c < N) dst[c] = s[a][c];
      }
    }
  }
}

// The lanes a state column is split over: the power of two >= N / 4.
int decode_lanes(int N) {
  int lanes = 1;
  while (4 * lanes < N) lanes *= 2;
  return lanes;
}

}  // namespace

// Launches the decode kernel on `stream`; returns cudaGetLastError().
// vec: every array 16-byte aligned with N a multiple of 4.
cudaError_t rwkv6_decode_launch(const float* r, const float* k,
                                const float* v, const float* w,
                                const float* u, const float* state0, float* y,
                                float* state_out, int B, int T, int H, int N,
                                bool vec, cudaStream_t stream) {
  const int lanes = decode_lanes(N);
  const int groups = kDecodeThreads / lanes;  // column groups a block
  const dim3 grid(((N + 3) / 4 + groups - 1) / groups, H, B);
  rwkv6_decode_kernel<<<grid, kDecodeThreads, 0, stream>>>(
      r, k, v, w, u, state0, y, state_out, T, H, N, lanes, vec ? 1 : 0);
  return cudaGetLastError();
}
