// The WKV scan's prefill kernel: the chunked WKV form with its products on
// the tensor cores (mma.sync m16n8k8, 3xTF32), sm_90a.  See rwkv6_scan.cu
// for the function, the layouts and how a call picks this kernel or the
// decode one.
//
// For a chunk of C = 16 steps of one (batch, head) starting at step b, with
// S_b the state at the chunk's start and every product of w taken as a
// running product of the chunk's own factors:
//   D_t    = prod_{b <= q < t} w_q          (t = b .. b+C, D_b = 1)
//   r~_t   = r_t * D_t                      the decay from the chunk's start
//   k~_s   = k_s * prod_{s < q < b+C} w_q   the decay to the chunk's end
//   A[t,s] = sum_n r_t,n k_s,n prod_{s < q < t} w_q,n   for s < t
//   A[t,t] = sum_n r_t,n u_n k_t,n                      the bonus
//   y      = r~ S_b + A V         (C x N)(N x cols) + (C x C)(C x cols)
//   S_b+C  = diag(D_b+C) S_b + k~^T V       (N x C)(C x cols)
// Every factor is a w (<= 1) multiplied in step order: no exp, no division,
// nothing that cancels, for decays near 0 (products underflow to 0, as the
// stepwise recurrence's do) and near 1 alike.  The three products run on the
// tensor cores in 3xTF32 (kernels/csrc/tf32_mma.cuh; one TF32 pass misses
// the port's 1e-4, tests/test_torch_rwkv6_chunked.py shows it); A, with its
// running products, on the CUDA cores in a fixed order.  ref.wkv_chunked_ref
// is this algorithm on the CPU, with operand_rounding="tf32x3" the same
// rounding of the products' operands.
//
// Grid and block.  Column j of S and of y depends only on v_j, so a
// (batch, head) splits over blocks of 32 value columns: one block per (32
// columns, head, batch row), 4 warps, 320 blocks at the served (B, H, N) =
// (4, 40, 64), where one block per (batch, head) gave 160 (and 2 warps).
// Each block recomputes A (2x at N = 64).  A block walks its chunks in
// order, carrying its N x 32 slice of the state in registers.
//
// A chunk's work splits in two: its products, which need the state at its
// start, and its preparation (D, r~, k~ and A from its r, k and w), which
// does not.  So the block runs them skewed by one chunk.  In the step of
// chunk c every warp first issues chunk c's products (y's columns
// 8w..8w+7: r~ S_b over K = N in four accumulators, then A V; the state's
// rows 16w..16w+15: k~^T V over its 32 columns), then prepares chunk c+1
// into the other of two buffers while they are in flight, and only then
// stores y and forms S = diag(D) S + k~^T V from them, into the other of
// two state buffers.  In the preparation threads 0..63 form D and r~ (a
// column each, forward), threads 64..127 k~ (backward), and warp w rows
// 4w..4w+3 of A (wkv_pairs.cuh, shared with the backward; 4w+3 pairs at
// most, a trip count of its own): a row's 8 lanes each hold 8 of the N
// terms, walk s from t-1 down to 0 multiplying their r_t,n by w_{s+1},n
// before each step, and the row's 16 sums (15 pairs and the bonus) are
// added over the 8 lanes by recursive halving (3 xor steps, 14
// shuffles).  r, k and w arrive by cp.async two chunks ahead
// of their products and v one chunk ahead; with them, the preparation and
// the state double-buffered, a step needs one barrier.  Every loop has a
// fixed trip count (the head size padded to 64 with zeros, a ragged last
// chunk's rows zero), so each half is straight-line code.  Rows of every
// tile are padded so that each fragment load hits 32 distinct banks.  A
// block's shared memory is 71 KB, so 3 fit an SM and the served prefill's
// 320 blocks run in one wave.  Each thread reads its elements of state0
// before it writes the same elements of state_out and no other thread
// touches them, so the two may alias.  No atomics, fixed orders: reruns
// are bit-identical.
//
// Where its time goes (an H100 at 700 W, PERF.md): the serial walk over 32
// chunks with 2-3 blocks an SM leaves latency exposed.  Of its parts A
// costs the most, then the products, then D, r~ and k~; sharing A between
// a head's two blocks through a cluster (half of A a block) ran slower.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "wkv_pairs.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kC = 16;          // steps a chunk
constexpr int kCols = 32;       // value columns a block
constexpr int kNP = 64;         // the head size, padded
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRS = kNP + 4;    // padded row strides in shared memory
constexpr int kKS = kNP + 8;
constexpr int kVS = kCols + 8;
constexpr int kAS = kC + 4;
static_assert(kThreads == 2 * kNP, "a thread per column for D and for k~");
static_assert(kWarps * 16 == kNP && kWarps * 8 == kCols,
              "a warp per 16 state rows and per 8 columns of y");
static_assert(kWarps * 4 == kC && kC == wkv::kPairC,
              "a warp per 4 rows of A");

// The A fragment at rows (g, g+8), columns (q, q+4), split for 3xTF32.
__device__ __forceinline__ tf32x3::FragA fragment_a(const float* base,
                                                   int rs, int ks, int g,
                                                   int q) {
  float v[4];
  tf32x3::load_a(base, rs, ks, g, q, v);
  return tf32x3::split_a(v);
}

struct Raw {         // a chunk's r, k, w (t, n)
  float r[kC][kRS];
  float k[kC][kRS];
  float w[kC][kRS];
};

struct Prep {        // what a chunk's products take besides v and the state
  float rt[kC][kRS];  // r~ (t, n)
  float kt[kC][kKS];  // k~ (s, n)
  float a[kC][kAS];   // A (t, s), the bonus on its diagonal
  float dc[kNP];      // the chunk's decay, D at its end
};

struct ChunkSmem {
  Raw raw[2];              // chunks c+1 and c+2
  float v[2][kC][kVS];     // chunks c and c+1 (s, the block's columns)
  Prep prep[2];            // chunks c and c+1
  float h[2][kNP][kVS];    // the state at chunks c's and c+1's starts
                           // (n, column)
  float u[kNP];
};
static_assert(sizeof(ChunkSmem) % 16 == 0, "zeroed as float4");

// D, r~ and the chunk's decay (threads 0..63, a column each, forward), k~
// (threads 64..127, backward), and warp w's four rows of A
__device__ __forceinline__ void prepare(const Raw& raw, const float* u,
                                        Prep& out, int steps, int tid,
                                        int warp, int lane) {
  if (tid < kNP) {
    const int n = tid;
    float D = 1.0f;
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      out.rt[t][n] = raw.r[t][n] * D;
      if (t < steps) D *= raw.w[t][n];
    }
    out.dc[n] = D;
  } else {
    const int n = tid - kNP;
    float E = 1.0f;
#pragma unroll
    for (int s = kC - 1; s >= 0; --s) {
      if (s < steps) {
        out.kt[s][n] = raw.k[s][n] * E;
        E *= raw.w[s][n];
      } else {
        out.kt[s][n] = 0.0f;
      }
    }
  }

  wkv::a_rows_of_warp(raw.r, raw.k, raw.w, u, out.a, warp, lane);
}

__global__ void __launch_bounds__(kThreads, 3)
rwkv6_chunked_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, const float* state0,
                     float* __restrict__ y, float* state_out, int T, int H,
                     int N, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);
  const int j0 = blockIdx.x * kCols;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int ncols = min(kCols, N - j0);

  // zeros first: what lies past N, past the block's columns and past T
  // stays zero in every tile
  for (int i = tid; i < static_cast<int>(sizeof(ChunkSmem) / 16);
       i += kThreads)
    reinterpret_cast<float4*>(smem_raw)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  if (tid < N) sm.u[tid] = __ldg(u + static_cast<size_t>(hh) * N + tid);

  // the warp's tile of the state: rows 16 warp + (g, g+8), columns
  // 8 jt + 2q (+1) of the block's
  const int i_lo = 16 * warp + g;
  const size_t sbase = (static_cast<size_t>(bb) * H + hh) * N * N;
  float hacc[4][4];
#pragma unroll
  for (int jt = 0; jt < 4; ++jt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i_lo + 8 * (e >> 1);
      const int jl = 8 * jt + 2 * q + (e & 1);
      hacc[jt][e] = state0 != nullptr && i < N && jl < ncols
                        ? state0[sbase + static_cast<size_t>(i) * N + j0 + jl]
                        : 0.0f;
      sm.h[0][i][jl] = hacc[jt][e];
    }
  }

  // the chunk at step t0: its r, k and w into `dst`, rows past T zero
  auto stage_rkw = [&](Raw& dst, int t0) {
    const int steps = min(kC, T - t0);
    const size_t row0 = static_cast<size_t>(bb) * T + t0;  // step (bb, t0)
    if (vec) {
      for (int e = tid; e < kC * (kNP / 4); e += kThreads) {
        const int t = e / (kNP / 4), n4 = 4 * (e % (kNP / 4));
        if (n4 < N) {
          const size_t at =
              ((row0 + min(t, steps - 1)) * H + hh) * N + n4;
          const int bytes = t < steps ? 16 : 0;
          async_copy::cp_async16(&dst.r[t][n4], r + at, bytes);
          async_copy::cp_async16(&dst.k[t][n4], k + at, bytes);
          async_copy::cp_async16(&dst.w[t][n4], w + at, bytes);
        }
      }
    } else {
      for (int e = tid; e < kC * kNP; e += kThreads) {
        const int t = e / kNP, n = e % kNP;
        if (n < N) {
          const bool in = t < steps;
          const size_t at = in ? ((row0 + t) * H + hh) * N + n : 0;
          dst.r[t][n] = in ? __ldg(r + at) : 0.0f;
          dst.k[t][n] = in ? __ldg(k + at) : 0.0f;
          dst.w[t][n] = in ? __ldg(w + at) : 0.0f;
        }
      }
    }
  };
  // and its v columns
  auto stage_v = [&](float (&dst)[kC][kVS], int t0) {
    const int steps = min(kC, T - t0);
    const size_t row0 = static_cast<size_t>(bb) * T + t0;
    if (vec) {
      for (int e = tid; e < kC * (kCols / 4); e += kThreads) {
        const int t = e / (kCols / 4), c4 = 4 * (e % (kCols / 4));
        if (c4 < ncols) {
          const size_t at =
              ((row0 + min(t, steps - 1)) * H + hh) * N + j0 + c4;
          async_copy::cp_async16(&dst[t][c4], v + at, t < steps ? 16 : 0);
        }
      }
    } else {
      for (int e = tid; e < kC * kCols; e += kThreads) {
        const int t = e / kCols, c = e % kCols;
        if (c < ncols) {
          const bool in = t < steps;
          dst[t][c] =
              in ? __ldg(v + ((row0 + t) * H + hh) * N + j0 + c) : 0.0f;
        }
      }
    }
  };

  const int nchunks = (T + kC - 1) / kC;
  // chunk 0 prepared; its v and chunk 1's r, k, w in place
  stage_rkw(sm.raw[0], 0);
  stage_v(sm.v[0], 0);
  if (nchunks > 1) stage_rkw(sm.raw[1], kC);
  async_copy::cp_async_commit();
  async_copy::cp_async_wait<0>();
  __syncthreads();
  prepare(sm.raw[0], sm.u, sm.prep[0], min(kC, T), tid, warp, lane);

  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * kC;
    const int steps = min(kC, T - t0);
    async_copy::cp_async_wait<0>();  // chunk c+1's r, k, w and chunk c's v
    // the one barrier of a step: chunk c prepared and the state at its
    // start in place, and every read of the buffers refilled below done
    __syncthreads();
    // chunk c+2's r, k, w over chunk c's (read by the previous step's
    // preparation) and chunk c+1's v over chunk c-1's
    if (c + 2 < nchunks) stage_rkw(sm.raw[c & 1], t0 + 2 * kC);
    if (c + 1 < nchunks) stage_v(sm.v[(c + 1) & 1], t0 + kC);
    async_copy::cp_async_commit();
    const Prep& pc = sm.prep[c & 1];
    const float (&hc)[kNP][kVS] = sm.h[c & 1];
    const float (&vc)[kC][kVS] = sm.v[c & 1];

    // chunk c's products: y on its rows, the warp's 8 columns (r~ S_b over
    // K = 64 in four accumulators, then A V over K = s), and the state's
    // increment k~^T V on the warp's 16 rows
    float yacc[4][1][4], ds[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[a][0][e] = ds[a][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kNP / 8; ++kk) {
      const tf32x3::FragA fa = fragment_a(&pc.rt[0][8 * kk], kRS, 1, g, q);
      const tf32x3::FragB fb[1] = {
          tf32x3::load_b(&hc[8 * kk][8 * warp], kVS, 1, g, q)};
      tf32x3::mma_3xtf32(yacc[kk & 3], fa, fb);
    }
#pragma unroll
    for (int kk = 0; kk < kC / 8; ++kk) {
      const tf32x3::FragA fa = fragment_a(&pc.a[0][8 * kk], kAS, 1, g, q);
      const tf32x3::FragB fb[1] = {
          tf32x3::load_b(&vc[8 * kk][8 * warp], kVS, 1, g, q)};
      tf32x3::mma_3xtf32(yacc[kk], fa, fb);
    }
#pragma unroll
    for (int kk = 0; kk < kC / 8; ++kk) {
      const tf32x3::FragA fa =
          fragment_a(&pc.kt[8 * kk][16 * warp], 1, kKS, g, q);
      tf32x3::FragB fb[4];
#pragma unroll
      for (int jt = 0; jt < 4; ++jt)
        fb[jt] = tf32x3::load_b(&vc[8 * kk][8 * jt], kVS, 1, g, q);
      tf32x3::mma_3xtf32(ds, fa, fb);
    }

    // chunk c+1 prepared while the products are in flight
    if (c + 1 < nchunks)
      prepare(sm.raw[(c + 1) & 1], sm.u, sm.prep[(c + 1) & 1],
              min(kC, T - t0 - kC), tid, warp, lane);

    // y stored; the state S = diag(D) S_b + k~^T V
    {
      const size_t row0 = static_cast<size_t>(bb) * T + t0;
      const int jl = 8 * warp + 2 * q;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = g + 8 * half;
        if (t < steps) {
          float* dst = y + ((row0 + t) * H + hh) * N + j0 + jl;
          const int e = 2 * half;
          const float y0 = (yacc[0][0][e] + yacc[1][0][e]) +
                           (yacc[2][0][e] + yacc[3][0][e]);
          const float y1 = (yacc[0][0][e + 1] + yacc[1][0][e + 1]) +
                           (yacc[2][0][e + 1] + yacc[3][0][e + 1]);
          if (vec && jl + 1 < ncols) {
            *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
          } else {
            if (jl < ncols) dst[0] = y0;
            if (jl + 1 < ncols) dst[1] = y1;
          }
        }
      }
      const float d_lo = pc.dc[i_lo], d_hi = pc.dc[i_lo + 8];
#pragma unroll
      for (int jt = 0; jt < 4; ++jt) {
        hacc[jt][0] = d_lo * hacc[jt][0] + ds[jt][0];
        hacc[jt][1] = d_lo * hacc[jt][1] + ds[jt][1];
        hacc[jt][2] = d_hi * hacc[jt][2] + ds[jt][2];
        hacc[jt][3] = d_hi * hacc[jt][3] + ds[jt][3];
      }
    }
    // the state at chunk c+1's start, over chunk c-1's
#pragma unroll
    for (int jt = 0; jt < 4; ++jt) {
      const int jl = 8 * jt + 2 * q;
      *reinterpret_cast<float2*>(&sm.h[(c + 1) & 1][i_lo][jl]) =
          make_float2(hacc[jt][0], hacc[jt][1]);
      *reinterpret_cast<float2*>(&sm.h[(c + 1) & 1][i_lo + 8][jl]) =
          make_float2(hacc[jt][2], hacc[jt][3]);
    }
  }

#pragma unroll
  for (int jt = 0; jt < 4; ++jt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i_lo + 8 * (e >> 1);
      const int jl = 8 * jt + 2 * q + (e & 1);
      if (i < N && jl < ncols)
        state_out[sbase + static_cast<size_t>(i) * N + j0 + jl] = hacc[jt][e];
    }
  }
}

}  // namespace

// Launches the chunked kernel on `stream`; returns cudaGetLastError().
// vec: r, k, v and w 16-byte aligned with N a multiple of 4.
cudaError_t rwkv6_chunked_launch(const float* r, const float* k,
                                 const float* v, const float* w,
                                 const float* u, const float* state0,
                                 float* y, float* state_out, int B, int T,
                                 int H, int N, bool vec,
                                 cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(ChunkSmem));
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  // the whole unified cache as shared memory: 3 blocks of 71 KB an SM
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rwkv6_chunked_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kCols - 1) / kCols, H, B);
  rwkv6_chunked_kernel<<<grid, kThreads, smem, stream>>>(
      r, k, v, w, u, state0, y, state_out, T, H, N, vec ? 1 : 0);
  return cudaGetLastError();
}
