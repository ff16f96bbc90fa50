// The pairwise matrix A of a chunk of the WKV scan, shared by the chunked
// forward (rwkv6_chunked.cu) and the backward (rwkv6_backward.cu):
//   A[t,s] = sum_n r_t,n k_s,n prod_{s < q < t} w_q,n   for s < t
//   A[t,t] = sum_n r_t,n u_n k_t,n                      the bonus
// for a chunk of 16 steps and a head size padded to 64, on the CUDA cores:
// every decay a running product of w in step order (r_t multiplied by
// w_{t-1}, w_{t-2}, ... as s walks down), no exp and no division.  Four
// warps, warp w rows 4w..4w+3: a row's 8 lanes each hold 8 of the 64 terms,
// and the row's 16 sums (15 pairs and the bonus) are added over the 8 lanes
// by recursive halving (3 xor steps, 14 shuffles).  Rows of r, k and w are
// 16-byte aligned (read as float4).
#pragma once

#include <cuda_runtime.h>

namespace wkv {

constexpr int kPairC = 16;  // steps a chunk

// warp w's four rows of A, t = 4w .. 4w+3, with MT = 4w + 3 pairs at most
template <int MT, int RS, int AS>
__device__ __forceinline__ void a_rows(const float (&r)[kPairC][RS],
                                       const float (&k)[kPairC][RS],
                                       const float (&w)[kPairC][RS],
                                       const float* u,
                                       float (&a)[kPairC][AS], int warp,
                                       int lane) {
  // row t = 4 warp + lane / 8; lane l8 holds n = 4 l8 .. +3, 32 + 4 l8 .. +3
  const int t = 4 * warp + (lane >> 3);
  const int l8 = lane & 7;
  const int na = 4 * l8, nb = 32 + 4 * l8;
  float qv[8];
  // sums[m]: the pair (t, t-1-m); sums[kPairC-1]: the bonus
  float sums[kPairC];
  {
    const float4 ra = *reinterpret_cast<const float4*>(&r[t][na]);
    const float4 rb = *reinterpret_cast<const float4*>(&r[t][nb]);
    const float4 ka = *reinterpret_cast<const float4*>(&k[t][na]);
    const float4 kb = *reinterpret_cast<const float4*>(&k[t][nb]);
    const float4 ua = *reinterpret_cast<const float4*>(&u[na]);
    const float4 ub = *reinterpret_cast<const float4*>(&u[nb]);
    const float rr[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
    const float kk[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
    const float uu[8] = {ua.x, ua.y, ua.z, ua.w, ub.x, ub.y, ub.z, ub.w};
    float bonus = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      qv[i] = rr[i];
      bonus = fmaf(rr[i] * uu[i], kk[i], bonus);
    }
    sums[kPairC - 1] = bonus;
  }
  // every row of the warp walks the warp's MT pairs (rows with fewer clamp
  // their indices and drop the sums): straight-line code
#pragma unroll
  for (int m = MT; m < kPairC - 1; ++m) sums[m] = 0.0f;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int s = t - 1 - m;
    if (m > 0) {
      const int sw = max(s + 1, 0);
      const float4 wa = *reinterpret_cast<const float4*>(&w[sw][na]);
      const float4 wb = *reinterpret_cast<const float4*>(&w[sw][nb]);
      qv[0] *= wa.x;
      qv[1] *= wa.y;
      qv[2] *= wa.z;
      qv[3] *= wa.w;
      qv[4] *= wb.x;
      qv[5] *= wb.y;
      qv[6] *= wb.z;
      qv[7] *= wb.w;
    }
    const int sk = max(s, 0);
    const float4 ka = *reinterpret_cast<const float4*>(&k[sk][na]);
    const float4 kb = *reinterpret_cast<const float4*>(&k[sk][nb]);
    float p = qv[0] * ka.x;
    p = fmaf(qv[1], ka.y, p);
    p = fmaf(qv[2], ka.z, p);
    p = fmaf(qv[3], ka.w, p);
    p = fmaf(qv[4], kb.x, p);
    p = fmaf(qv[5], kb.y, p);
    p = fmaf(qv[6], kb.z, p);
    sums[m] = fmaf(qv[7], kb.w, p);
  }
  // the 8 lanes' partials of the 16 sums added by recursive halving: at
  // each xor step a lane keeps half its sums and adds its partner's half
  const bool b2 = l8 & 4, b1 = l8 & 2, b0 = l8 & 1;
  float h8[8], h4[4], h2[2];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    h8[i] = (b2 ? sums[8 + i] : sums[i]) +
            __shfl_xor_sync(0xffffffffu, b2 ? sums[i] : sums[8 + i], 4);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h4[i] = (b1 ? h8[4 + i] : h8[i]) +
            __shfl_xor_sync(0xffffffffu, b1 ? h8[i] : h8[4 + i], 2);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    h2[i] = (b0 ? h4[2 + i] : h4[i]) +
            __shfl_xor_sync(0xffffffffu, b0 ? h4[i] : h4[2 + i], 1);
  // the lane now holds the sums m = 2 l8 and 2 l8 + 1
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = 2 * l8 + i;
    if (m == kPairC - 1) {
      a[t][t] = h2[i];
    } else if (t - 1 - m >= 0) {
      a[t][t - 1 - m] = h2[i];
    }
  }
  for (int s = t + 1 + l8; s < kPairC; s += 8) a[t][s] = 0.0f;
}

// warp w's four rows of A (the warp's last row, t = 4w + 3, has 4w + 3
// pairs: a trip count of its own)
template <int RS, int AS>
__device__ __forceinline__ void a_rows_of_warp(const float (&r)[kPairC][RS],
                                               const float (&k)[kPairC][RS],
                                               const float (&w)[kPairC][RS],
                                               const float* u,
                                               float (&a)[kPairC][AS],
                                               int warp, int lane) {
  switch (warp) {
    case 0:
      a_rows<3>(r, k, w, u, a, warp, lane);
      break;
    case 1:
      a_rows<7>(r, k, w, u, a, warp, lane);
      break;
    case 2:
      a_rows<11>(r, k, w, u, a, warp, lane);
      break;
    default:
      a_rows<15>(r, k, w, u, a, warp, lane);
  }
}

}  // namespace wkv
