// The WKV scan's backward for Hopper (sm_90a): the gradients of the
// recurrence of rwkv6_scan.cu,
//
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// with respect to r, k, v, w, u and S_0, given dy and the final state's
// gradient dS_T (zero when none is given).  Step by step, with
// G_t = dL/dS_t from G_T = dS_T:
//
//   dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t
//   dk_t = u . r_t (v_t . dy_t) + G_t v_t
//   dv_t = (r_t . (u . k_t)) dy_t + G_t^T k_t
//   dw_t = rowsum(G_t . S_{t-1})
//   du  += r_t . k_t (v_t . dy_t)
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T,      dS_0 = G_0
//
// The JAX package has no kernel for this: its gradient is XLA's, through
// the scan (src/repro/models/rwkv.py: wkv_stepwise).  These kernels are the
// backward of the port's #7 (src/repro/kernels/rwkv6_scan/kernel.py:
// rwkv6_scan), as flash_backward.cu is #6's.  ref.wkv_bwd_ref is the
// function, ref.wkv_bwd_chunked_ref this algorithm on the CPU (with
// operand_rounding="tf32x3" the same rounding of the products' operands).
//
// The chunked form, in chunks of C = 16 steps (the forward's).  In a chunk
// starting at step b, every decay a running product of its w's in step
// order: D_t = prod_{b<=q<t} w_q, E_t = prod_{t<q<b+C} w_q,
// P(s,t) = prod_{s<q<t} w_q; r~ = r D, k~ = k E.  Two launches:
//
//  1. rwkv6_bwd_bounds_kernel: the state S_b at every chunk's start and the
//     state's gradient G_e at every chunk's end.  Blocks of the first half
//     walk the chunks forward, S <- diag(D_C) S + k~^T V (the forward's own
//     chunk update); blocks of the second half walk them backward,
//     G <- diag(D_C) G + r~^T dY, and write dS_0.  Each a (32 state
//     columns, head, batch row): 640 blocks at the training shape, one
//     wave, the state's slice in the accumulators of its product (N x 16 x
//     32 on the tensor cores a chunk), as the forward carries it; every
//     chunk's tiles copied (cp.async) while the previous chunk computes.
//  2. rwkv6_bwd_chunk_kernel: every chunk alone, all in parallel (a block
//     per (chunk, head, batch row): 4480 at the training shape (4, 512, 40,
//     64), where one block per (b, h) walking all 512 steps gave 160).  On
//     the tensor cores Y2 = dY S_b^T, X = V G_e^T, B2 = dY V^T (B2[t,s] =
//     dy_t . v_s) and dv = k~ G_e + A^T dY, A the forward's pairwise
//     matrix (wkv_pairs.cuh, the bonus on its diagonal).  Then, a thread a
//     column i (every term below is elementwise in i):
//       dr_t = D_t Y2_t + sum_{s<t} P(s,t) k_s B2[t,s] + u k_t B2[t,t]
//       dk_t = E_t X_t + R_t(t) + u r_t B2[t,t]
//       dw_t = E_t Z_t + D_t W_t + sum_{s<t} P(s,t) k_s R_s(t)
//     with R_s(t) = sum_{t'>t} P(t,t') r_t' B2[t',s] (walked down in t:
//     R_s <- w_t R_s + r_t B2[t,s]), W_t = sum_{t'>t} P(t,t') r_t' Y2_t'
//     and Z_{t+1} = w_t Z_t + k_t X_t from Z_0 = rowsum(G_e . S_b); du the
//     chunk's sum of r_t k_t B2[t,t].
//
// Where it would go wrong, and what the design does:
//  - dw where w rounds to 0.  The model's w = exp(-exp(.)) is exactly 0
//    for large inputs, and the stepwise dw_t = rowsum(G_t . S_{t-1}) is
//    finite and nonzero there.  The usual chunked backward takes the
//    gradient of log w from cumulative sums and divides by w (0/0 here),
//    and the gradient through the reference's own wkv_chunked
//    (log(max(w, 1e-30))) is 0 below 1e-30.  So dw is rowsum(G_t . S_{t-1})
//    itself, expanded over the chunk into four terms: D_t E_t rowsum(G_e .
//    S_b) and the G_e-V cross term (both in E_t Z_t), the S_b-dY cross
//    term (D_t W_t) and the pairs s < t < t' (from B2).  Every decay in them
//    is a product of w's taken in step order, the factor w_t left out by
//    a prefix times a suffix (D_t E_t), never by a division.
//    chip_smoke's "dw to 5 (w = 0)" case checks it.
//  - Precision.  One TF32 pass misses 1e-4 (tests/test_torch_rwkv6_chunked
//    .py shows it for the forward), so every product runs in 3xTF32
//    (tf32_mma.cuh); plain IEEE float32 elsewhere, no fast math.
//  - Sums across blocks, without atomics: du comes back as each chunk's
//    partial (du_part, (B, chunks, H, N)), summed by the wrapper in a fixed
//    order; a state column splits over blocks of pass 1 only, where nothing
//    is summed over columns.  Reruns are bit-identical.
//  - Ragged and small T: a ragged last chunk is the identity step past T
//    (w = 1, r = k = v = dy = 0), as the forward treats it; T = 1 is one
//    such chunk.  A head size below 64 is padded with zeros.
//
// The boundary states come from pass 1, not from the forward: the forward
// could write them under grad and skip pass 1, but they would live from
// the forward to the backward, B H (T/16) N^2 floats, 84 MB a layer at the
// training shape and 2.7 GB over rwkv6-3b's 32 layers on a 53.8 GiB step,
// and the forward kernel would take a second output.  Pass 1 reads k, v,
// w, r and dy once and writes S_b and G_e once (84 MB each, transient).
//
// What bounds it: at the training shape the function's bytes (r, k, v, w,
// dy in, dr, dk, dv, dw out, ~190 MB) take 57 us at 3.35 TB/s; the
// products (~11 GFLOP in three TF32 passes) 22 us at 495 TFLOP/s.  This
// design also writes and reads the boundary states, 84 MB each way for S_b
// and for G_e, so its own floor is bytes: ~80 us for pass 1 and ~110 us
// for pass 2 (chip_smoke._wkv_bwd_bound).  Both passes stage their tiles
// with cp.async, every copy of a tile in flight at once; a loop of loads
// waits on each and took half as long again.  Boundary states every other
// chunk, the middle one recomputed in pass 2, would halve that traffic.
//
// Layouts, all float32: r, k, v, w, dy and dr, dk, dv, dw (B, T, H, N);
// u (H, N); state0, dstate and dstate0 (B, H, N, N), each may be null (zero
// in, not written out); s_bounds and g_bounds (B, H, chunks, N, N).
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "tf32_mma.cuh"
#include "wkv_pairs.cuh"

namespace {

constexpr int kC = 16;          // steps a chunk
constexpr int kNP = 64;         // the head size, padded
constexpr int kCols = 32;       // state columns a block of pass 1
constexpr int kJT = kCols / 8;  // its column tiles
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRS = kNP + 4;    // padded row strides in shared memory
constexpr int kKS = kNP + 8;
constexpr int kVS = kCols + 8;
constexpr int kAS = kC + 4;
static_assert(kC == wkv::kPairC && kWarps * 4 == kC,
              "a warp per 4 rows of A");
static_assert(kThreads == 2 * kNP && kWarps * 16 == kNP,
              "two threads a column, a warp per 16 state rows");

// The A fragment at rows (g, g+8), columns (q, q+4), split for 3xTF32.
__device__ __forceinline__ tf32x3::FragA fragment_a(const float* base,
                                                   int rs, int ks, int g,
                                                   int q) {
  float v[4];
  tf32x3::load_a(base, rs, ks, g, q, v);
  return tf32x3::split_a(v);
}

// element n of step t of (batch row bb, head hh) in a (B, T, H, N) tensor
__device__ __forceinline__ size_t at(int bb, int t, int hh, int n, int T,
                                     int H, int N) {
  return ((static_cast<size_t>(bb) * T + t) * H + hh) * N + n;
}

struct BoundSmem {
  float x[2][kC][kRS];  // k (forward) or r (backward) (t, n), two chunks
  float w[2][kC][kRS];  // 1 past T
  float y[2][kC][kVS];  // v or dy on the block's columns (t, j)
  float xt[kC][kKS];    // k~ or r~ (t, n)
  float dc[kNP];        // the chunk's decay D_C
};

// rows t >= steps of a chunk's w: the identity step
__device__ __forceinline__ void identity_rows(float (&w)[kC][kRS], int steps,
                                              int tid) {
  for (int e = tid; e < (kC - steps) * kNP; e += kThreads)
    w[steps + e / kNP][e % kNP] = 1.0f;
}

// Pass 1.  Blocks x < ncb: S_b of every chunk into s_bounds, walking
// forward from state0; blocks x >= ncb: G_e of every chunk into g_bounds,
// walking backward from dstate, and dstate0.  The warp's tile of the state
// (or gradient): rows 16 warp + (g, g+8), columns 8 jt + 2q (+1) of the
// block's 32.
__global__ void __launch_bounds__(kThreads)
rwkv6_bwd_bounds_kernel(const float* __restrict__ r,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ w,
                        const float* __restrict__ dy,
                        const float* __restrict__ state0,
                        const float* __restrict__ dstate,
                        float* __restrict__ s_bounds,
                        float* __restrict__ g_bounds,
                        float* __restrict__ dstate0, int T, int H, int N,
                        int ncb, int vec) {
  __shared__ __align__(16) BoundSmem sm;
  const bool fwd = static_cast<int>(blockIdx.x) < ncb;
  const int j0 = (fwd ? blockIdx.x : blockIdx.x - ncb) * kCols;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int ncols = min(kCols, N - j0);
  const int chunks = (T + kC - 1) / kC;
  const float* xs = fwd ? k : r;
  const float* ys = fwd ? v : dy;
  const float* init = fwd ? state0 : dstate;
  float* out = fwd ? s_bounds : g_bounds;
  const size_t bh = static_cast<size_t>(bb) * H + hh;
  const int i_lo = 16 * warp + g;

  float hacc[kJT][4];
#pragma unroll
  for (int jt = 0; jt < kJT; ++jt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i_lo + 8 * (e >> 1), jl = 8 * jt + 2 * q + (e & 1);
      hacc[jt][e] = init != nullptr && i < N && jl < ncols
                        ? init[(bh * N + i) * N + j0 + jl] : 0.0f;
    }
  }
  // the warp's tile of the carry into the N x N matrix at `base`
  auto store_tile = [&](float* base) {
#pragma unroll
    for (int jt = 0; jt < kJT; ++jt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = i_lo + 8 * half, jl = 8 * jt + 2 * q;
        float* dst = base + i * N + j0 + jl;
        const float a0 = hacc[jt][2 * half], a1 = hacc[jt][2 * half + 1];
        if (i >= N || jl >= ncols) continue;
        if (vec) {  // N and ncols multiples of 4: both in range, 8-aligned
          *reinterpret_cast<float2*>(dst) = make_float2(a0, a1);
        } else {
          dst[0] = a0;
          if (jl + 1 < ncols) dst[1] = a1;
        }
      }
    }
  };
  // chunk c's x, w and y into buffer `buf`, in flight behind the work
  auto stage = [&](int buf, int c) {
    const int t0 = c * kC, steps = min(kC, T - t0);
    const size_t row0 = at(bb, t0, hh, 0, T, H, N);
    async_copy::stage_tile(&sm.x[buf][0][0], kRS, xs + row0, H * N, kC, kNP,
                           steps, N, vec, tid, kThreads);
    async_copy::stage_tile(&sm.w[buf][0][0], kRS, w + row0, H * N, steps,
                           kNP, steps, N, vec, tid, kThreads);
    async_copy::stage_tile(&sm.y[buf][0][0], kVS, ys + row0 + j0, H * N, kC,
                           kCols, steps, ncols, vec, tid, kThreads);
    identity_rows(sm.w[buf], steps, tid);
    async_copy::cp_async_commit();
  };
  // the steps that update the carry: the forward needs no state past the
  // last chunk's start
  const int updates = fwd ? chunks - 1 : chunks;
  if (updates > 0) stage(0, fwd ? 0 : chunks - 1);
  for (int step = 0; step < chunks; ++step) {
    const int c = fwd ? step : chunks - 1 - step;
    // the state at chunk c's start, or its gradient at chunk c's end
    store_tile(out + (bh * chunks + c) * N * N);
    if (step == updates) break;
    const int buf = step & 1;
    async_copy::cp_async_wait<0>();
    // chunk c's tiles in place, and every read of the previous chunk's done
    __syncthreads();
    if (step + 1 < updates) stage(buf ^ 1, fwd ? c + 1 : c - 1);
    if (tid < kNP) {  // a column n: k~ (or r~) and the chunk's decay
      const int n = tid;
      float dec = 1.0f;
      if (fwd) {
#pragma unroll
        for (int s = kC - 1; s >= 0; --s) {
          sm.xt[s][n] = sm.x[buf][s][n] * dec;
          dec *= sm.w[buf][s][n];
        }
      } else {
#pragma unroll
        for (int t = 0; t < kC; ++t) {
          sm.xt[t][n] = sm.x[buf][t][n] * dec;
          dec *= sm.w[buf][t][n];
        }
      }
      sm.dc[n] = dec;
    }
    __syncthreads();
    // the increment k~^T V (or r~^T dY) on the warp's 16 rows
    float ds[kJT][4];
#pragma unroll
    for (int jt = 0; jt < kJT; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[jt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kC / 8; ++kk) {
      const tf32x3::FragA fa =
          fragment_a(&sm.xt[8 * kk][16 * warp], 1, kKS, g, q);
      tf32x3::FragB fb[kJT];
#pragma unroll
      for (int jt = 0; jt < kJT; ++jt)
        fb[jt] = tf32x3::load_b(&sm.y[buf][8 * kk][8 * jt], kVS, 1, g, q);
      tf32x3::mma_3xtf32(ds, fa, fb);
    }
    const float d_lo = sm.dc[i_lo], d_hi = sm.dc[i_lo + 8];
#pragma unroll
    for (int jt = 0; jt < kJT; ++jt) {
      hacc[jt][0] = d_lo * hacc[jt][0] + ds[jt][0];
      hacc[jt][1] = d_lo * hacc[jt][1] + ds[jt][1];
      hacc[jt][2] = d_hi * hacc[jt][2] + ds[jt][2];
      hacc[jt][3] = d_hi * hacc[jt][3] + ds[jt][3];
    }
  }
  if (!fwd && dstate0 != nullptr) store_tile(dstate0 + bh * N * N);
}

struct ChunkSmem {
  float r[kC][kRS];   // the chunk's inputs (t, n), zeros past N and T
  float k[kC][kRS];
  float w[kC][kRS];   // 1 past T
  float v[kC][kRS];
  float dy[kC][kRS];
  float s[kNP][kRS];  // S_b (i, j)
  float g[kNP][kRS];  // G_e (i, j)
  float kt[kC][kRS];  // k~ (s, i)
  float y2[kC][kRS];  // dY S_b^T (t, i)
  float x[kC][kRS];   // V G_e^T (s, i)
  float b2[kC][kAS];  // dY V^T (t, s)
  float a[kC][kAS];   // A (t, s), the bonus on its diagonal
  float rho[kNP];     // rowsum(G_e . S_b)
  float u[kNP];
};

// Pass 2: a chunk's gradients.  Warp w's tiles: Y2's and X's columns
// 16w..16w+15, dv's columns 16w..16w+15, B2's columns 8w..8w+7 (warps 0
// and 1).
__global__ void __launch_bounds__(kThreads, 3)
rwkv6_bwd_chunk_kernel(const float* __restrict__ r,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ w,
                       const float* __restrict__ u,
                       const float* __restrict__ dy,
                       const float* __restrict__ s_bounds,
                       const float* __restrict__ g_bounds,
                       float* __restrict__ dr, float* __restrict__ dk,
                       float* __restrict__ dv, float* __restrict__ dw,
                       float* __restrict__ du_part, int T, int H, int N,
                       int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);
  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int chunks = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int t0 = c * kC, steps = min(kC, T - t0);
  const size_t bh = static_cast<size_t>(bb) * H + hh;

  // two groups of copies, all in flight at once: r, k, w and u, which k~
  // and A take; then v, dy, S_b and G_e
  {
    using async_copy::stage_tile;
    const size_t row0 = at(bb, t0, hh, 0, T, H, N);
    const size_t sq = (bh * chunks + c) * N * N;
    stage_tile(&sm.r[0][0], kRS, r + row0, H * N, kC, kNP, steps, N, vec, tid,
               kThreads);
    stage_tile(&sm.k[0][0], kRS, k + row0, H * N, kC, kNP, steps, N, vec, tid,
               kThreads);
    stage_tile(&sm.w[0][0], kRS, w + row0, H * N, steps, kNP, steps, N, vec,
               tid, kThreads);
    identity_rows(sm.w, steps, tid);
    stage_tile(sm.u, 0, u + hh * N, 0, 1, kNP, 1, N, vec, tid, kThreads);
    async_copy::cp_async_commit();
    stage_tile(&sm.v[0][0], kRS, v + row0, H * N, kC, kNP, steps, N, vec, tid,
               kThreads);
    stage_tile(&sm.dy[0][0], kRS, dy + row0, H * N, kC, kNP, steps, N, vec,
               tid, kThreads);
    stage_tile(&sm.s[0][0], kRS, s_bounds + sq, N, kNP, kNP, N, N, vec, tid,
               kThreads);
    stage_tile(&sm.g[0][0], kRS, g_bounds + sq, N, kNP, kNP, N, N, vec, tid,
               kThreads);
    async_copy::cp_async_commit();
  }
  async_copy::cp_async_wait<1>();
  __syncthreads();

  if (tid < kNP) {  // k~, a column each
    const int n = tid;
    float dec = 1.0f;
#pragma unroll
    for (int s = kC - 1; s >= 0; --s) {
      sm.kt[s][n] = sm.k[s][n] * dec;
      dec *= sm.w[s][n];
    }
  }
  wkv::a_rows_of_warp(sm.r, sm.k, sm.w, sm.u, sm.a, warp, lane);
  async_copy::cp_async_wait<0>();
  __syncthreads();
  if (tid >= kNP) {  // rowsum(G_e . S_b), a row each, its columns skewed
                     // by the row so that the 32 lanes read 32 banks
    const int i = tid - kNP;
    float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll 8
    for (int j = 0; j < kNP; j += 2) {
      const int j_a = (j + i) & (kNP - 1), j_b = (j + 1 + i) & (kNP - 1);
      acc0 = fmaf(sm.g[i][j_a], sm.s[i][j_a], acc0);
      acc1 = fmaf(sm.g[i][j_b], sm.s[i][j_b], acc1);
    }
    sm.rho[i] = acc0 + acc1;
  }

  // Y2 = dY S_b^T and X = V G_e^T on the warp's 16 columns i (K = j), and
  // B2 = dY V^T on its 8 columns s (warps 0 and 1)
  {
    float ya[2][4], xa[2][4], ba[1][4];
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[jt][e] = xa[jt][e] = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) ba[0][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kNP / 8; ++kk) {
      const tf32x3::FragA fdy = fragment_a(&sm.dy[0][8 * kk], kRS, 1, g, q);
      const tf32x3::FragA fv = fragment_a(&sm.v[0][8 * kk], kRS, 1, g, q);
      tf32x3::FragB fs[2], fg[2];
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
        fs[jt] = tf32x3::load_b(&sm.s[16 * warp + 8 * jt][8 * kk], 1, kRS,
                                g, q);
        fg[jt] = tf32x3::load_b(&sm.g[16 * warp + 8 * jt][8 * kk], 1, kRS,
                                g, q);
      }
      tf32x3::mma_3xtf32(ya, fdy, fs);
      tf32x3::mma_3xtf32(xa, fv, fg);
      if (warp < 2) {
        const tf32x3::FragB fb[1] = {
            tf32x3::load_b(&sm.v[8 * warp][8 * kk], 1, kRS, g, q)};
        tf32x3::mma_3xtf32(ba, fdy, fb);
      }
    }
#pragma unroll
    for (int jt = 0; jt < 2; ++jt) {
      const int i = 16 * warp + 8 * jt + 2 * q;
      sm.y2[g][i] = ya[jt][0];
      sm.y2[g][i + 1] = ya[jt][1];
      sm.y2[g + 8][i] = ya[jt][2];
      sm.y2[g + 8][i + 1] = ya[jt][3];
      sm.x[g][i] = xa[jt][0];
      sm.x[g][i + 1] = xa[jt][1];
      sm.x[g + 8][i] = xa[jt][2];
      sm.x[g + 8][i + 1] = xa[jt][3];
    }
    if (warp < 2) {
      const int s = 8 * warp + 2 * q;
      sm.b2[g][s] = ba[0][0];
      sm.b2[g][s + 1] = ba[0][1];
      sm.b2[g + 8][s] = ba[0][2];
      sm.b2[g + 8][s + 1] = ba[0][3];
    }
  }
  // dv = k~ G_e (K = i) + A^T dY (K = t) on the warp's 16 columns j
  {
    float va[2][4];
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) va[jt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kNP / 8; ++kk) {
      const tf32x3::FragA fa = fragment_a(&sm.kt[0][8 * kk], kRS, 1, g, q);
      tf32x3::FragB fb[2];
#pragma unroll
      for (int jt = 0; jt < 2; ++jt)
        fb[jt] = tf32x3::load_b(&sm.g[8 * kk][16 * warp + 8 * jt], kRS, 1,
                                g, q);
      tf32x3::mma_3xtf32(va, fa, fb);
    }
#pragma unroll
    for (int kk = 0; kk < kC / 8; ++kk) {
      const tf32x3::FragA fa = fragment_a(&sm.a[8 * kk][0], 1, kAS, g, q);
      tf32x3::FragB fb[2];
#pragma unroll
      for (int jt = 0; jt < 2; ++jt)
        fb[jt] = tf32x3::load_b(&sm.dy[8 * kk][16 * warp + 8 * jt], kRS, 1,
                                g, q);
      tf32x3::mma_3xtf32(va, fa, fb);
    }
#pragma unroll
    for (int jt = 0; jt < 2; ++jt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = g + 8 * (e >> 1);
        const int j = 16 * warp + 8 * jt + 2 * q + (e & 1);
        if (s < steps && j < N) dv[at(bb, t0 + s, hh, j, T, H, N)] =
            va[jt][e];
      }
    }
  }
  __syncthreads();  // Y2, X and B2 in place

  // the elementwise terms, a thread a column i: threads 0..63 dk, dw and
  // du, threads 64..127 dr
  const int i = tid & (kNP - 1);
  const float ui = sm.u[i];
  float kk_[kC], ww[kC], D[kC];
#pragma unroll
  for (int t = 0; t < kC; ++t) {
    kk_[t] = sm.k[t][i];
    ww[t] = sm.w[t][i];
  }
  D[0] = 1.0f;
#pragma unroll
  for (int t = 1; t < kC; ++t) D[t] = D[t - 1] * ww[t - 1];
  if (tid < kNP) {
    float rr[kC], E[kC], EZ[kC], R[kC];
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      rr[t] = sm.r[t][i];
      R[t] = 0.0f;
    }
    E[kC - 1] = 1.0f;
#pragma unroll
    for (int t = kC - 2; t >= 0; --t) E[t] = E[t + 1] * ww[t + 1];
    // Z_t = D_t rowsum(G_e . S_b) + sum_{s<t} P(s,t) k_s X_s
    float Z = sm.rho[i];
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      EZ[t] = E[t] * Z;
      Z = fmaf(ww[t], Z, kk_[t] * sm.x[t][i]);
    }
    float W = 0.0f, du = 0.0f;
#pragma unroll
    for (int t = kC - 1; t >= 0; --t) {
      // the pairs s < t < t': sum_{s<t} P(s,t) k_s R_s(t)
      float pq = 1.0f, aw = 0.0f;
#pragma unroll
      for (int s = t - 1; s >= 0; --s) {
        aw = fmaf(R[s], kk_[s] * pq, aw);
        pq *= ww[s];
      }
      const float bonus = sm.b2[t][t];
      if (t < steps && i < N) {
        const size_t idx = at(bb, t0 + t, hh, i, T, H, N);
        dk[idx] = E[t] * sm.x[t][i] + R[t] + ui * rr[t] * bonus;
        dw[idx] = EZ[t] + D[t] * W + aw;
      }
      du = fmaf(rr[t] * kk_[t], bonus, du);
      W = fmaf(ww[t], W, rr[t] * sm.y2[t][i]);
#pragma unroll
      for (int s = 0; s < t; ++s)
        R[s] = fmaf(ww[t], R[s], rr[t] * sm.b2[t][s]);
    }
    if (i < N) du_part[(static_cast<size_t>(bb) * chunks + c) * H * N +
                       static_cast<size_t>(hh) * N + i] = du;
  } else {
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      // sum_{s<t} P(s,t) k_s B2[t,s]
      float pq = 1.0f, ar = 0.0f;
#pragma unroll
      for (int s = t - 1; s >= 0; --s) {
        ar = fmaf(sm.b2[t][s], kk_[s] * pq, ar);
        pq *= ww[s];
      }
      if (t < steps && i < N)
        dr[at(bb, t0 + t, hh, i, T, H, N)] =
            D[t] * sm.y2[t][i] + ar + ui * kk_[t] * sm.b2[t][t];
    }
  }
}

}  // namespace

// The C entry point: launches pass 1 (kernel 0) or pass 2 (kernel 1) on
// `stream` and returns the CUDA error of the launch (0 on success); the
// wrapper launches both, in that order, into the same scratch.
// T >= 1, 1 <= N <= 64, 1 <= B, H <= 65535; s_bounds and g_bounds hold
// B H ceil(T / 16) N^2 floats each, du_part B ceil(T / 16) H N.
extern "C" int rwkv6_scan_backward(const float* r, const float* k,
                                   const float* v, const float* w,
                                   const float* u, const float* state0,
                                   const float* dy, const float* dstate,
                                   float* dr, float* dk, float* dv, float* dw,
                                   float* du_part, float* dstate0,
                                   float* s_bounds, float* g_bounds, int B,
                                   int T, int H, int N, int kernel,
                                   cudaStream_t stream) {
  if (B < 1 || T < 1 || H < 1 || N < 1 || N > kNP || B > 65535 ||
      H > 65535 || (kernel != 0 && kernel != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = (T + kC - 1) / kC;
  using tf32x3::aligned16;
  const int vec = N % 4 == 0 && aligned16(r) && aligned16(k) &&
                  aligned16(v) && aligned16(w) && aligned16(dy) &&
                  aligned16(u) && aligned16(s_bounds) && aligned16(g_bounds);
  if (kernel == 0) {
    const int ncb = (N + kCols - 1) / kCols;
    rwkv6_bwd_bounds_kernel<<<dim3(2 * ncb, H, B), kThreads, 0, stream>>>(
        r, k, v, w, dy, state0, dstate, s_bounds, g_bounds, dstate0, T, H, N,
        ncb, vec);
    return static_cast<int>(cudaGetLastError());
  }
  const int bytes = static_cast<int>(sizeof(ChunkSmem));
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  // the whole carveout to shared memory: three blocks of 73 KB an SM
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rwkv6_bwd_chunk_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv6_bwd_chunk_kernel<<<dim3(chunks, H, B), kThreads, bytes, stream>>>(
      r, k, v, w, u, dy, s_bounds, g_bounds, dr, dk, dv, dw, du_part, T, H,
      N, vec);
  return static_cast<int>(cudaGetLastError());
}
