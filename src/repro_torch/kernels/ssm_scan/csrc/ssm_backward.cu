// The selective scan's backward for Hopper (sm_90a): the gradients of the
// recurrence of ssm_scan.cu,
//
//   h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) b_t^T      (P x N)
//   y_t = h_t c_t + d x_t
//
// with respect to x, b, c, dt, a, d and h_0, given dy and the final state's
// gradient dh_T (zero when none is given).  Step by step, with
// e_t = exp(dt_t a) and G_t = dL/dh_t:
//
//   G_t    = dy_t c_t^T + e_{t+1} G_{t+1}          (G_T gets dh_T too)
//   dx_t   = dt_t G_t b_t + d dy_t
//   db_t  += dt_t G_t^T x_t                         (summed over heads)
//   dc_t  += h_t^T dy_t                             (summed over heads)
//   ddt_t  = sum G_t . (a e_t h_{t-1} + x_t b_t^T)
//   da    += dt_t e_t sum G_t . h_{t-1}
//   dd    += sum dy_t . x_t
//   dh_0   = e_1 G_1
//
// The JAX package has no kernel for this: its gradient is XLA's, through
// the scan (src/repro/models/ssm.py: ssd_stepwise).  These kernels are the
// backward of the port's #8 (src/repro/kernels/ssm_scan/kernel.py:
// ssm_scan), as flash_backward.cu is #6's.  ref.selective_scan_bwd_ref is
// the function, ref.ssd_bwd_chunked_ref this algorithm on the CPU (with
// operand_rounding="tf32x3" the same rounding of the products' operands).
//
// The chunked SSD form, in chunks of C = 64 steps (the forward's).  In a
// chunk, la_t = dt_t a (float32) and its prefix sums pfx_t from the chunk's
// start in float64; e_t = exp(pfx_t), the chunk's decay exp(pfx_L),
// w_s = exp(pfx_L - pfx_s) dt_s, L[t,s] = exp(pfx_t - pfx_s) dt_s (s <= t).
// Two launches:
//
//  1. ssm_bwd_bounds_kernel: the state h_b at every chunk's start and the
//     state's gradient dh_e at every chunk's end.  Blocks of the first half
//     walk the chunks forward, h <- exp(pfx_L) h + (diag(w) X)^T B (the
//     forward's own chunk update); blocks of the second half walk them
//     backward, dh <- exp(pfx_L) dh + (diag(e) dY)^T C, and write dh_0.
//     Each a (32 rows of P, head, batch row), the state's slice in the
//     accumulators of its product, as the forward carries it.  The
//     chunk-local products are independent; only the elementwise carry by
//     exp(pfx_L) is serial.
//  2. ssm_bwd_chunk_kernel: every chunk of every head alone, all in
//     parallel (a block per (chunk, head, batch row): 2048 at the training
//     shape (4, 512, 64, 64, 64), where one block per (b, h) walking all 512
//     steps gave 256).  On the tensor cores G = C B^T and dM = dY X^T
//     (s <= t); then in registers M = L G, dG = dM L, Q = dM M; then
//       dx = M^T dY + (diag(w) B) dh_e^T + d dY
//       dc = (diag(e) dY) h_b + dG B        (this head's share)
//       db = diag(w) X dh_e + dG^T C        (this head's share)
//     and the gradient of la_q through the segment sums, e and the decays,
//       dla_q = sum_{t>=q, s<q} Q[t,s] + sum_{t>=q} I_t
//               + exp(pfx_L) <dh_e, h_b> + sum_{s<q} w_s J_s
//     (I_t = c_t . (e dY h_b)_t, J_s = b_s . (X dh_e)_s), taken as one
//     exclusive prefix sum in float64 of colsum(Q) - rowsum(Q) + w J - I
//     (strictly lower Q) from sum_t I_t + exp(pfx_L) <dh_e, h_b>:
//       ddt_q = a dla_q + sum_{t>=q} (dM G exp(pfx_t - pfx_q))[t,q]
//               + J_q exp(pfx_L - pfx_q),   da += dt_q dla_q.
//
// Where it would go wrong, and what the design does:
//  - ddt and da where exp(dt a) rounds to 0 (dt x 40, a near -20: pfx
//    reaches -1e5 in a chunk).  Every exponent is a difference of prefix
//    sums taken in float64 and rounded to float32 only in front of expf
//    (as ssm_chunked.cu explains), every exponent <= 0, and nothing is
//    divided by exp(dt a) or by dt: the direct dt terms of M and w come from
//    dM G exp(.) and J exp(.), not from M / dt.  chip_smoke's "dt x 40
//    (e = 0)" case checks it.
//  - Precision.  One TF32 pass misses 1e-4 (tests/test_torch_ssm_chunked.py
//    shows it for the forward), so every product runs in 3xTF32
//    (tf32_mma.cuh); plain IEEE float32 and expf elsewhere, no fast math.
//  - Sums across blocks, without atomics: db and dc come back as each
//    head's share (B, T, H, N), da and dd as each chunk's (B, chunks, H);
//    the wrapper sums them in a fixed order.  Reruns are bit-identical.
//  - Ragged and small T: a ragged last chunk is the identity step past T
//    (dt = 0, x = b = c = dy = 0), as the forward treats it.  P and N below
//    64 are padded with zeros.
//
// The boundary states come from pass 1, not from the forward: the forward
// could write them under grad (33.5 MB a layer at the training shape) and
// skip pass 1, but they would live from the forward to the backward and
// the forward kernel would take a second output.  Pass 1 reads x, dy, b, c
// and dt once and writes h_b and dh_e once (33.5 MB each, transient).
//
// What bounds it: at the training shape the function's bytes (x, dy in, dx
// and the per-head db, dc out, b, c, dt, ~170 MB) take 51 us at 3.35 TB/s;
// the products (~28 GFLOP in three TF32 passes, the causal halves counted
// once) 57 us at 495 TFLOP/s (chip_smoke._ssm_bwd_bound).  Pass 2 holds 146
// KB of shared memory a block (the chunk's x, dy, b, c, h_b, dh_e, M and
// dG), so one block an SM: its 16 warps (a 16 x 16 tile of each product a
// warp) hide the latency of the products, but a block's staging does not
// overlap its own work.  Its time goes to the products' issue on mma.sync
// (each operand split in three instructions, per warp that reads it) and
// to that staging.  Both passes stage with cp.async, every copy of a tile
// in flight at once.
//
// Layouts, all float32: x, dy, dx (B, T, H, P); b, c (B, T, N); dt, ddt
// (B, T, H); a, d (H,); state0, dstate, dstate0 (B, H, P, N), each may be
// null (zero in, not written out); db_part and dc_part (B, T, H, N);
// da_part and dd_part (B, chunks, H); s_bounds and g_bounds (B, H, chunks,
// P, N).
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kC = 64;        // steps a chunk
constexpr int kNP = 64;       // P and N, padded
constexpr int kPT = 32;       // rows of P a block of pass 1
constexpr int kXS = kPT + 4;  // padded row strides in shared memory
constexpr int kRS = kNP + 4;
constexpr int kThreads1 = 128;  // pass 1: 4 warps
constexpr int kThreads2 = 512;  // pass 2: 16 warps
constexpr int kJ2 = 2;          // pass 2: column tiles a warp
constexpr unsigned kFull = 0xffffffffu;

// The prefix sums of la = dt a over a chunk of 64 steps in float64, by one
// warp (lane l holds steps 2l and 2l+1, an inclusive scan over the lanes):
// returns pfx_{2l} and pfx_{2l+1} in s0 and s1 and pfx_L in total.
__device__ __forceinline__ void prefix_sums(const float* dt, float ah,
                                            int lane, double& s0, double& s1,
                                            double& total) {
  const float la0 = dt[2 * lane] * ah, la1 = dt[2 * lane + 1] * ah;
  const double v0 = la0, v1 = v0 + static_cast<double>(la1);
  double incl = v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  double excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0;
  total = __shfl_sync(kFull, incl, 31);
  s0 = excl + v0;
  s1 = excl + v1;
}

struct BoundSmem {
  float x[kC][kXS];   // x (forward) or dy (backward), the block's rows of P
                      // as columns (s, p)
  float y[kC][kRS];   // b (forward) or c (backward) (s, n)
  float dt[kC];
  float scale[kC];    // w_s (forward) or e_t (backward)
  float decay;        // exp(pfx_L)
};

// Pass 1.  Blocks x < npb: h_b of every chunk into s_bounds, walking
// forward from state0; blocks x >= npb: dh_e of every chunk into g_bounds,
// walking backward from dstate, and dstate0.  The warp's 16 x 32 tile of
// the state: rows pr + (g, g+8) of the block's slice of P, columns
// nc + 8j + 2q (+1) of N.
__global__ void __launch_bounds__(kThreads1)
ssm_bwd_bounds_kernel(const float* __restrict__ x,
                      const float* __restrict__ b,
                      const float* __restrict__ c,
                      const float* __restrict__ dt,
                      const float* __restrict__ a,
                      const float* __restrict__ dy,
                      const float* __restrict__ state0,
                      const float* __restrict__ dstate,
                      float* __restrict__ s_bounds,
                      float* __restrict__ g_bounds,
                      float* __restrict__ dstate0, int T, int H, int P,
                      int N, int npb, int vec) {
  __shared__ __align__(16) BoundSmem sm;
  const bool fwd = static_cast<int>(blockIdx.x) < npb;
  const int p0 = (fwd ? blockIdx.x : blockIdx.x - npb) * kPT;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const float ah = a[hh];
  const int chunks = (T + kC - 1) / kC;
  const float* xs = fwd ? x : dy;
  const float* ys = fwd ? b : c;
  const float* init = fwd ? state0 : dstate;
  float* out = fwd ? s_bounds : g_bounds;
  const size_t bh = static_cast<size_t>(bb) * H + hh;
  const int pr = 16 * (warp & 1), nc = 32 * (warp >> 1);

  float hacc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + pr + g + 8 * (e >> 1);
      const int n = nc + 8 * j + 2 * q + (e & 1);
      hacc[j][e] = init != nullptr && p < P && n < N
                       ? init[(bh * P + p) * N + n] : 0.0f;
    }
  }
  // the warp's tile of the carry into the P x N matrix at `base`
  auto store_tile = [&](float* base) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = p0 + pr + g + 8 * half, n = nc + 8 * j + 2 * q;
        float* dst = base + p * N + n;
        const float a0 = hacc[j][2 * half], a1 = hacc[j][2 * half + 1];
        if (p >= P || n >= N) continue;
        if (vec) {  // N a multiple of 4: both in range, 8-aligned
          *reinterpret_cast<float2*>(dst) = make_float2(a0, a1);
        } else {
          dst[0] = a0;
          if (n + 1 < N) dst[1] = a1;
        }
      }
    }
  };
  for (int step = 0; step < chunks; ++step) {
    const int ch = fwd ? step : chunks - 1 - step;
    // the state at chunk ch's start, or its gradient at chunk ch's end
    store_tile(out + (bh * chunks + ch) * P * N);
    if (fwd && step == chunks - 1) break;  // the last chunk's end: unused
    const int t0 = ch * kC, steps = min(kC, T - t0);
    const size_t row0 = static_cast<size_t>(bb) * T + t0;
    __syncthreads();  // the previous chunk's tiles are read
    // the chunk's tiles, every copy in flight at once
    async_copy::stage_tile(&sm.x[0][0], kXS, xs + (row0 * H + hh) * P + p0,
                           static_cast<size_t>(H) * P, kC, kPT, steps,
                           P - p0, vec, tid, kThreads1);
    async_copy::stage_tile(&sm.y[0][0], kRS, ys + row0 * N, N, kC, kNP,
                           steps, N, vec, tid, kThreads1);
    async_copy::stage_tile(sm.dt, 1, dt + row0 * H + hh, H, kC, 1, steps, 1,
                           false, tid, kThreads1);
    async_copy::cp_async_commit();
    async_copy::cp_async_wait<0>();
    __syncthreads();
    if (warp == 0) {
      double s0, s1, total;
      prefix_sums(sm.dt, ah, lane, s0, s1, total);
      if (fwd) {
        sm.scale[2 * lane] =
            expf(static_cast<float>(total - s0)) * sm.dt[2 * lane];
        sm.scale[2 * lane + 1] =
            expf(static_cast<float>(total - s1)) * sm.dt[2 * lane + 1];
      } else {
        sm.scale[2 * lane] = expf(static_cast<float>(s0));
        sm.scale[2 * lane + 1] = expf(static_cast<float>(s1));
      }
      if (lane == 0) sm.decay = expf(static_cast<float>(total));
    }
    __syncthreads();
    // h = exp(pfx_L) h + (diag(scale) X)^T Y on the warp's tile, K = s
    const float decay = sm.decay;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[j][e] *= decay;
    const int kS = (steps + 7) / 8;
    for (int kk = 0; kk < kS; ++kk) {
      float av[4];
      tf32x3::load_a(&sm.x[8 * kk][pr], 1, kXS, g, q, av);
      const float s_lo = sm.scale[8 * kk + q], s_hi = sm.scale[8 * kk + q + 4];
      av[0] *= s_lo;
      av[1] *= s_lo;
      av[2] *= s_hi;
      av[3] *= s_hi;
      const tf32x3::FragA fa = tf32x3::split_a(av);
      tf32x3::FragB fb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        fb[j] = tf32x3::load_b(&sm.y[8 * kk][nc + 8 * j], kRS, 1, g, q);
      tf32x3::mma_3xtf32(hacc, fa, fb);
    }
  }
  if (!fwd && dstate0 != nullptr) store_tile(dstate0 + bh * P * N);
}

struct ChunkSmem {
  float x[kC][kRS];    // (s, p), zeros past T and P
  float dy[kC][kRS];   // (t, p)
  float b[kC][kRS];    // (s, n), zeros past T and N
  float c[kC][kRS];    // (t, n)
  float h[kNP][kRS];   // h_b (p, n)
  float dh[kNP][kRS];  // dh_e (p, n)
  float m[kC][kRS];    // M (t, s), zero above the diagonal
  float dg[kC][kRS];   // dG (t, s), zero above the diagonal
  double pfx[kC];
  float dt[kC];
  float e[kC];         // exp(pfx_t)
  float w[kC];         // exp(pfx_L - pfx_s) dt_s
  float ew[kC];        // exp(pfx_L - pfx_s)
  // partial sums, by quarter of the columns (rowq, ipart, jpart) or of
  // the rows (colq, colq2) of a 64 x 64 product: Q's row sums over s < t,
  // I_t, J_s; Q's column sums over t > s, (dM G exp(pfx_t - pfx_s))'s over
  // t >= s
  float rowq[4][kC];
  float ipart[4][kC];
  float jpart[4][kC];
  float colq[4][kC];
  float colq2[4][kC];
  float red[2][kThreads2 / 32];  // <dh_e, h_b> and sum dy . x, by warp
  float decay;         // exp(pfx_L)
};

// The four partials of step s, added in a fixed order.
__device__ __forceinline__ float quarter_sum(const float (&v)[4][kC], int s) {
  return (v[0][s] + v[1][s]) + (v[2][s] + v[3][s]);
}

// The sum of v over the 8 lanes of one q (lane bits 2..4), in all of them.
__device__ __forceinline__ float sum_over_g(float v) {
  v += __shfl_xor_sync(kFull, v, 4);
  v += __shfl_xor_sync(kFull, v, 8);
  v += __shfl_xor_sync(kFull, v, 16);
  return v;
}

// The sum of v over the 4 lanes of one g (lane bits 0..1), in all of them.
__device__ __forceinline__ float sum_over_q(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  v += __shfl_xor_sync(kFull, v, 2);
  return v;
}

// The sum of v over the warp, in all lanes.
__device__ __forceinline__ float warp_sum(float v) {
  return sum_over_g(sum_over_q(v));
}

// Pass 2: a chunk's gradients for one head.  Warp w's 16 x 16 tiles:
// rows 16 (w % 4) .. +15, columns 16 (w / 4) .. +15 of every 64 x 64
// product.
__global__ void __launch_bounds__(kThreads2, 1)
ssm_bwd_chunk_kernel(const float* __restrict__ x,
                     const float* __restrict__ b,
                     const float* __restrict__ c,
                     const float* __restrict__ dt,
                     const float* __restrict__ a,
                     const float* __restrict__ d,
                     const float* __restrict__ dy,
                     const float* __restrict__ s_bounds,
                     const float* __restrict__ g_bounds,
                     float* __restrict__ dx, float* __restrict__ db_part,
                     float* __restrict__ dc_part, float* __restrict__ ddt,
                     float* __restrict__ da_part,
                     float* __restrict__ dd_part, int T, int H, int P,
                     int N, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);
  const int ch = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int chunks = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int mt = warp & 3, nq = warp >> 2;
  const int r0 = 16 * mt, c0 = 16 * nq;  // the warp's tile
  const float ah = a[hh], dh_ = d[hh];
  const int t0 = ch * kC, steps = min(kC, T - t0);
  const size_t row0 = static_cast<size_t>(bb) * T + t0;
  const size_t sq = ((static_cast<size_t>(bb) * H + hh) * chunks + ch) * P * N;

  // the chunk's tiles and its boundary state and gradient, every copy in
  // flight at once
  {
    using async_copy::stage_tile;
    const size_t xrow = (row0 * H + hh) * P, gs = static_cast<size_t>(H) * P;
    stage_tile(&sm.x[0][0], kRS, x + xrow, gs, kC, kNP, steps, P, vec, tid,
               kThreads2);
    stage_tile(&sm.dy[0][0], kRS, dy + xrow, gs, kC, kNP, steps, P, vec, tid,
               kThreads2);
    stage_tile(&sm.b[0][0], kRS, b + row0 * N, N, kC, kNP, steps, N, vec, tid,
               kThreads2);
    stage_tile(&sm.c[0][0], kRS, c + row0 * N, N, kC, kNP, steps, N, vec, tid,
               kThreads2);
    stage_tile(&sm.h[0][0], kRS, s_bounds + sq, N, kNP, kNP, P, N, vec, tid,
               kThreads2);
    stage_tile(&sm.dh[0][0], kRS, g_bounds + sq, N, kNP, kNP, P, N, vec, tid,
               kThreads2);
    stage_tile(sm.dt, 1, dt + row0 * H + hh, H, kC, 1, steps, 1, false, tid,
               kThreads2);
    async_copy::cp_async_commit();
    async_copy::cp_async_wait<0>();
  }
  __syncthreads();

  // <dh_e, h_b> and sum dy . x, a warp's partials each; then warp 0 the
  // prefix sums and decays
  {
    float hd = 0.0f, yx = 0.0f;
    for (int i = tid; i < kC * kNP; i += kThreads2) {
      const int s = i / kNP, j = i % kNP;
      hd = fmaf(sm.dh[s][j], sm.h[s][j], hd);
      yx = fmaf(sm.dy[s][j], sm.x[s][j], yx);
    }
    hd = warp_sum(hd);
    yx = warp_sum(yx);
    if (lane == 0) {
      sm.red[0][warp] = hd;
      sm.red[1][warp] = yx;
    }
  }
  if (warp == 0) {
    double s0, s1, total;
    prefix_sums(sm.dt, ah, lane, s0, s1, total);
    sm.pfx[2 * lane] = s0;
    sm.pfx[2 * lane + 1] = s1;
    sm.e[2 * lane] = expf(static_cast<float>(s0));
    sm.e[2 * lane + 1] = expf(static_cast<float>(s1));
    const float ew0 = expf(static_cast<float>(total - s0));
    const float ew1 = expf(static_cast<float>(total - s1));
    sm.ew[2 * lane] = ew0;
    sm.ew[2 * lane + 1] = ew1;
    sm.w[2 * lane] = ew0 * sm.dt[2 * lane];
    sm.w[2 * lane + 1] = ew1 * sm.dt[2 * lane + 1];
    if (lane == 0) sm.decay = expf(static_cast<float>(total));
  }

  // G = C B^T and dM = dY X^T on the warp's (t, s) tile, skipped where it
  // lies wholly above the diagonal
  const bool live = c0 <= r0 + 15;
  float gacc[kJ2][4], macc[kJ2][4];
#pragma unroll
  for (int j = 0; j < kJ2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gacc[j][e] = macc[j][e] = 0.0f;
  if (live) {
    for (int kk = 0; kk < kNP / 8; ++kk) {
      float av[4];
      tf32x3::load_a(&sm.c[r0][8 * kk], kRS, 1, g, q, av);
      const tf32x3::FragA fc = tf32x3::split_a(av);
      tf32x3::load_a(&sm.dy[r0][8 * kk], kRS, 1, g, q, av);
      const tf32x3::FragA fy = tf32x3::split_a(av);
      tf32x3::FragB fb[kJ2], fx[kJ2];
#pragma unroll
      for (int j = 0; j < kJ2; ++j) {
        fb[j] = tf32x3::load_b(&sm.b[c0 + 8 * j][8 * kk], 1, kRS, g, q);
        fx[j] = tf32x3::load_b(&sm.x[c0 + 8 * j][8 * kk], 1, kRS, g, q);
      }
      tf32x3::mma_3xtf32(gacc, fc, fb);
      tf32x3::mma_3xtf32(macc, fy, fx);
    }
  }
  __syncthreads();  // the prefix sums and decays are in place

  // M = L G and dG = dM L into shared memory; Q = dM M's row and column
  // sums over the strictly lower triangle, (dM G exp(.))'s column sums
  {
    float rq[2] = {0.0f, 0.0f};
    float cq[kJ2][2], cq2[kJ2][2];
#pragma unroll
    for (int j = 0; j < kJ2; ++j) {
      float mv[4], gv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = r0 + g + 8 * (e >> 1);
        const int s = c0 + 8 * j + 2 * q + (e & 1);
        float mm = 0.0f, dgv = 0.0f, qv = 0.0f, q2 = 0.0f;
        if (s <= t) {
          const float ex = expf(static_cast<float>(sm.pfx[t] - sm.pfx[s]));
          const float l = ex * sm.dt[s];
          mm = l * gacc[j][e];
          dgv = macc[j][e] * l;
          qv = s < t ? macc[j][e] * mm : 0.0f;
          q2 = macc[j][e] * gacc[j][e] * ex;
        }
        mv[e] = mm;
        gv[e] = dgv;
        rq[e >> 1] += qv;
        if (e < 2) {
          cq[j][e] = qv;
          cq2[j][e] = q2;
        } else {
          cq[j][e - 2] += qv;
          cq2[j][e - 2] += q2;
        }
      }
      const int s = c0 + 8 * j + 2 * q;
      sm.m[r0 + g][s] = mv[0];
      sm.m[r0 + g][s + 1] = mv[1];
      sm.m[r0 + g + 8][s] = mv[2];
      sm.m[r0 + g + 8][s + 1] = mv[3];
      sm.dg[r0 + g][s] = gv[0];
      sm.dg[r0 + g][s + 1] = gv[1];
      sm.dg[r0 + g + 8][s] = gv[2];
      sm.dg[r0 + g + 8][s + 1] = gv[3];
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float v = sum_over_q(rq[half]);
      if (q == 0) sm.rowq[nq][r0 + g + 8 * half] = v;
    }
#pragma unroll
    for (int j = 0; j < kJ2; ++j) {
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const float v = sum_over_g(cq[j][o]);
        const float v2 = sum_over_g(cq2[j][o]);
        if (g == 0) {
          sm.colq[mt][c0 + 8 * j + 2 * q + o] = v;
          sm.colq2[mt][c0 + 8 * j + 2 * q + o] = v2;
        }
      }
    }
  }
  __syncthreads();  // M and dG in place

  float acc[kJ2][4];
  auto zero = [&]() {
#pragma unroll
    for (int j = 0; j < kJ2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  };
  // rows r0 + (g, g+8) of acc scaled by v[row]
  auto scale_rows = [&](const float* v) {
    const float lo = v[r0 + g], hi = v[r0 + g + 8];
#pragma unroll
    for (int j = 0; j < kJ2; ++j) {
      acc[j][0] *= lo;
      acc[j][1] *= lo;
      acc[j][2] *= hi;
      acc[j][3] *= hi;
    }
  };
  // row sums over the warp's 32 columns of acc . y (y (row, column) in
  // shared memory), lane q == 0 writing them into dst[row]
  auto row_dot = [&](const float (&y)[kC][kRS], float* dst) {
    float lo = 0.0f, hi = 0.0f;
#pragma unroll
    for (int j = 0; j < kJ2; ++j) {
      const int n = c0 + 8 * j + 2 * q;
      lo = fmaf(acc[j][0], y[r0 + g][n], lo);
      lo = fmaf(acc[j][1], y[r0 + g][n + 1], lo);
      hi = fmaf(acc[j][2], y[r0 + g + 8][n], hi);
      hi = fmaf(acc[j][3], y[r0 + g + 8][n + 1], hi);
    }
    lo = sum_over_q(lo);
    hi = sum_over_q(hi);
    if (q == 0) {
      dst[r0 + g] = lo;
      dst[r0 + g + 8] = hi;
    }
  };
  // acc += (A, rows r0.., K = 8 kk..) (B, K, columns c0..), A scaled by
  // rows when a_scale is given; A (row, k) at a_base[row*ars + k*aks], B
  // (k, column) at b_base[k*bks + column*bns]
  auto product = [&](const float* a_base, int ars, int aks,
                     const float* a_scale, const float* b_base, int bks,
                     int bns, int kk0, int kk1) {
    for (int kk = kk0; kk < kk1; ++kk) {
      float av[4];
      tf32x3::load_a(a_base + r0 * ars + 8 * kk * aks, ars, aks, g, q, av);
      if (a_scale != nullptr) {
        const float lo = a_scale[r0 + g], hi = a_scale[r0 + g + 8];
        av[0] *= lo;
        av[1] *= hi;
        av[2] *= lo;
        av[3] *= hi;
      }
      const tf32x3::FragA fa = tf32x3::split_a(av);
      tf32x3::FragB fb[kJ2];
#pragma unroll
      for (int j = 0; j < kJ2; ++j)
        fb[j] = tf32x3::load_b(b_base + 8 * kk * bks + (c0 + 8 * j) * bns,
                               bks, bns, g, q);
      tf32x3::mma_3xtf32(acc, fa, fb);
    }
  };
  // the warp's tile of acc into a (B, T, H, width) tensor
  auto store = [&](float* dst, int width, int limit, const float* skip) {
#pragma unroll
    for (int j = 0; j < kJ2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = r0 + g + 8 * (e >> 1);
        const int n = c0 + 8 * j + 2 * q + (e & 1);
        if (t < steps && n < limit) {
          const float add = skip != nullptr ? dh_ * skip[t * kRS + n] : 0.0f;
          dst[((row0 + t) * H + hh) * width + n] = acc[j][e] + add;
        }
      }
    }
  };

  // dx = M^T dY (K = t >= s) + (diag(w) B) dh_e^T (K = n) + d dY
  zero();
  product(&sm.m[0][0], 1, kRS, nullptr, &sm.dy[0][0], kRS, 1, 2 * mt,
          kC / 8);
  product(&sm.b[0][0], kRS, 1, sm.w, &sm.dh[0][0], 1, kRS, 0, kNP / 8);
  store(dx, P, P, &sm.dy[0][0]);
  // dc = (diag(e) dY) h_b (K = p), I_t = c_t . that, + dG B (K = s <= t)
  zero();
  product(&sm.dy[0][0], kRS, 1, sm.e, &sm.h[0][0], kRS, 1, 0, kNP / 8);
  row_dot(sm.c, sm.ipart[nq]);
  product(&sm.dg[0][0], kRS, 1, nullptr, &sm.b[0][0], kRS, 1, 0, 2 * mt + 2);
  store(dc_part, N, N, nullptr);
  // db = diag(w) X dh_e (K = p), J_s = b_s . X dh_e, + dG^T C (K = t >= s)
  zero();
  product(&sm.x[0][0], kRS, 1, nullptr, &sm.dh[0][0], kRS, 1, 0, kNP / 8);
  row_dot(sm.b, sm.jpart[nq]);
  scale_rows(sm.w);
  product(&sm.dg[0][0], 1, kRS, nullptr, &sm.c[0][0], kRS, 1, 2 * mt,
          kC / 8);
  store(db_part, N, N, nullptr);
  __syncthreads();  // the partial sums in place

  // ddt and da: dla by one exclusive prefix sum in float64 (lane l holds
  // steps 2l and 2l+1)
  if (warp == 0) {
    double term[2], i_sum = 0.0;
    float q2[2], jv[2];
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const int s = 2 * lane + o;
      const float rowq = quarter_sum(sm.rowq, s);
      const float colq = quarter_sum(sm.colq, s);
      q2[o] = quarter_sum(sm.colq2, s);
      const float iv = quarter_sum(sm.ipart, s);
      jv[o] = quarter_sum(sm.jpart, s);
      term[o] = static_cast<double>(colq) - rowq +
                static_cast<double>(sm.w[s]) * jv[o] - iv;
      i_sum += iv;
    }
    double pair = term[0] + term[1];
    double incl = pair;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += o;
      i_sum += __shfl_xor_sync(kFull, i_sum, off);
    }
    double excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.0;
    float hd = 0.0f, yx = 0.0f;
#pragma unroll
    for (int wp = 0; wp < kThreads2 / 32; ++wp) {
      hd += sm.red[0][wp];
      yx += sm.red[1][wp];
    }
    const double base =
        i_sum + static_cast<double>(sm.decay) * static_cast<double>(hd);
    double da = 0.0;
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const int s = 2 * lane + o;
      const double dla = base + (o == 0 ? excl : excl + term[0]);
      da += static_cast<double>(sm.dt[s]) * dla;
      if (s < steps)
        ddt[(row0 + s) * H + hh] = static_cast<float>(
            static_cast<double>(ah) * dla + q2[o] +
            static_cast<double>(jv[o]) * sm.ew[s]);
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      da += __shfl_xor_sync(kFull, da, off);
    if (lane == 0) {
      const size_t at = (static_cast<size_t>(bb) * chunks + ch) * H + hh;
      da_part[at] = static_cast<float>(da);
      dd_part[at] = yx;
    }
  }
}

}  // namespace

// The C entry point: launches pass 1 (kernel 0) or pass 2 (kernel 1) on
// `stream` and returns the CUDA error of the launch (0 on success); the
// wrapper launches both, in that order, into the same scratch.
// T >= 1, 1 <= P, N <= 64, 1 <= B, H <= 65535; s_bounds and g_bounds hold
// B H ceil(T / 64) P N floats each, da_part and dd_part B ceil(T / 64) H.
extern "C" int ssm_scan_backward(const float* x, const float* b,
                                 const float* c, const float* dt,
                                 const float* a, const float* d,
                                 const float* state0, const float* dy,
                                 const float* dstate, float* dx,
                                 float* db_part, float* dc_part, float* ddt,
                                 float* da_part, float* dd_part,
                                 float* dstate0, float* s_bounds,
                                 float* g_bounds, int B, int T, int H, int P,
                                 int N, int kernel, cudaStream_t stream) {
  if (B < 1 || T < 1 || H < 1 || P < 1 || N < 1 || P > kNP || N > kNP ||
      B > 65535 || H > 65535 || (kernel != 0 && kernel != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = (T + kC - 1) / kC;
  using tf32x3::aligned16;
  const int vec = P % 4 == 0 && N % 4 == 0 && aligned16(x) && aligned16(b) &&
                  aligned16(c) && aligned16(dy) && aligned16(s_bounds) &&
                  aligned16(g_bounds);
  if (kernel == 0) {
    const int npb = (P + kPT - 1) / kPT;
    ssm_bwd_bounds_kernel<<<dim3(2 * npb, H, B), kThreads1, 0, stream>>>(
        x, b, c, dt, a, dy, state0, dstate, s_bounds, g_bounds, dstate0, T,
        H, P, N, npb, vec);
    return static_cast<int>(cudaGetLastError());
  }
  const int bytes = static_cast<int>(sizeof(ChunkSmem));
  cudaError_t err = cudaFuncSetAttribute(
      ssm_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssm_bwd_chunk_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssm_bwd_chunk_kernel<<<dim3(chunks, H, B), kThreads2, bytes, stream>>>(
      x, b, c, dt, a, d, dy, s_bounds, g_bounds, dx, db_part, dc_part, ddt,
      da_part, dd_part, T, H, P, N, vec);
  return static_cast<int>(cudaGetLastError());
}
