// The selective scan's prefill kernel: Mamba2's chunked SSD form on the
// tensor cores (mma.sync m16n8k8, 3xTF32), sm_90a.  See ssm_scan.cu for the
// function, the layouts and how a call picks this kernel or the decode one.
//
// The algorithm is the reference's ssd_chunked (src/repro/models/ssm.py)
// with the skip d x and an initial state.  For a chunk of C = 64 steps of
// one (batch, head), with la_s = dt_s a (<= 0) and its prefix sums
// pfx_t = sum_{r <= t} la_r taken from the chunk's start:
//   G      = C_c B_c^T                     (t, s)  one group: the same for
//                                                  every head of a batch row
//   M[t,s] = exp(pfx_t - pfx_s) dt_s G[t,s] for s <= t, else 0
//   y      = M x_c + exp(pfx_t) (C_c h^T) + d x_c   (t, p)
//   h      = exp(pfx_last) h + x_c^T diag(exp(pfx_last - pfx_s) dt_s) B_c
// where h (P, N) is the state at the chunk's start.  Three products of
// 64 x 64 x 64 a chunk replace the 64 rank-1 updates of the recurrence.
//
// Precision.  The port holds the scan to 1e-4 of the float32 recurrence.
// TF32 alone keeps 10 mantissa bits and misses that over 64-long sums, so
// every product runs in 3xTF32 (tf32_mma.cuh).  The exponents come from
// prefix sums kept in float64: at a large step (dt x 40, a near -20) pfx
// reaches -1e5 within a chunk, where a float32 difference pfx_t - pfx_s
// would keep only ~1e-2 of absolute precision in front of exp.  In float64
// the difference is exact to ~1e-11, and only then rounded to float32.
// ref.ssd_chunked_ref is this algorithm on the CPU, in the same order and,
// with operand_rounding="tf32x3", the same rounding of the operands.
//
// Grid and block.  One block per (32 columns of the head dim, head, batch
// row), 4 warps.  A block walks its chunks in order, carrying its 32 x N
// slice of the state in the accumulators of the state product; the slices
// of a head are independent (each reads all of x's chunk rows but only its
// own columns), so splitting P doubles the blocks at no cost but G and M,
// recomputed per block: 512 blocks at the served (B, H, P) = (4, 64, 64)
// and 128 at B = 1, where one block per (batch, head) gave 256 and 64.
// Only the inter-chunk term and the state depend on the previous chunk; a
// second launch that computed every chunk's state in parallel would cut
// the serial walk of 8 chunks at T = 512 but add a launch and a pass over
// the states, so the walk stays in the block.
//
// A chunk in a block: all threads stage x (64 x 32), B, C (64 x N) and dt
// in shared memory (16-byte loads where the rows allow, zeros past T and
// past P and N: a ragged tail is the identity step, dt = 0); warp w takes
// rows 16w..16w+15 of y: the inter-chunk term C h^T (K = n) and G on the
// same rows (only columns s <= its last row), while warp 0 first forms the
// float64 prefix sums and the chunk's decays; after one barrier the
// inter-chunk rows are scaled by exp(pfx_t) (the reference's order), G
// turns into M in registers, written over the warp's own rows of C (no
// other warp reads them), and the causal half of M x (K = s) is added;
// last every warp adds x^T W B to its 16 x 32 tile of the state, and the
// state goes to shared memory for the next chunk.  The next chunk's x is
// prefetched into L2 behind the products.  M in C's place keeps a block's shared memory at 54 KB, so 4
// blocks fit an SM and the served prefill's 512 blocks run in one wave.
// Each 3xTF32 product runs its three passes over 4 independent tiles.
// Rows of every tile are padded by 4 floats so that each fragment load hits
// 32 distinct banks.  No atomics, fixed orders: reruns are bit-identical.
// The loads are plain loads in front of each chunk's products; TMA or
// cp.async staging of the next chunk behind the current one's products is
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kC = 64;        // steps a chunk
constexpr int kPT = 32;       // columns of the head dim a block
constexpr int kNP = 64;       // the state dim, padded
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kXS = kPT + 4;  // padded row strides in shared memory
constexpr int kRS = kNP + 4;

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

struct ChunkSmem {
  float x[kC][kXS];    // x of the chunk (s, p)
  float b[kC][kRS];    // (s, n)
  float c[kC][kRS];    // (t, n), then M (t, s): each warp reads only its
                       // own 16 rows of C and writes M over them
  float h[kPT][kRS];   // the state at the chunk's start (p, n)
  double pfx[kC];      // prefix sums of dt a, float64
  float dt[kC];
  float e[kC];         // exp(pfx_t)
  float w[kC];         // exp(pfx_last - pfx_s) dt_s
  float decay;         // exp(pfx_last)
};

__global__ void __launch_bounds__(kThreads, 4)
ssm_chunked_kernel(const float* __restrict__ x, const float* __restrict__ b,
                   const float* __restrict__ c, const float* __restrict__ dt,
                   const float* __restrict__ a, const float* __restrict__ d,
                   const float* state0, float* __restrict__ y,
                   float* state_out, int T, int H, int P, int N, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);
  const int p0 = blockIdx.x * kPT;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const float ah = a[hh], dh = d[hh];
  const int kN = (N + 7) / 8;  // k-steps over the state dim

  // the warp's 16 x 32 tile of the state: rows pr + (g, g+8) of the
  // block's slice, columns nc + 8j + 2q (+1)
  const int pr = 16 * (warp & 1);
  const int nc = 32 * (warp >> 1);
  const size_t sbase = (static_cast<size_t>(bb) * H + hh) * P * N;
  float hacc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = pr + g + 8 * (e >> 1);
      const int n = nc + 8 * j + 2 * q + (e & 1);
      const int p = p0 + r;
      hacc[j][e] = state0 != nullptr && p < P && n < N
                       ? state0[sbase + static_cast<size_t>(p) * N + n]
                       : 0.0f;
      sm.h[r][n] = hacc[j][e];
    }
  }

  const int t_lo = 16 * warp + g, t_hi = t_lo + 8;  // this lane's rows of y
  const int jmax = 2 * (warp + 1);  // column tiles of G with s <= t
  for (int t0 = 0; t0 < T; t0 += kC) {
    const int steps = min(kC, T - t0);
    const size_t row0 = static_cast<size_t>(bb) * T + t0;  // step (bb, t0)
    // stage the chunk, zeros past T, P and N
    if (vec) {
      for (int i = tid; i < kC * (kPT / 4); i += kThreads) {
        const int s = i / (kPT / 4), p4 = 4 * (i % (kPT / 4));
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (s < steps && p0 + p4 < P)
          v = __ldg(reinterpret_cast<const float4*>(
              x + ((row0 + s) * H + hh) * P + p0 + p4));
        *reinterpret_cast<float4*>(&sm.x[s][p4]) = v;
      }
      for (int i = tid; i < kC * (kNP / 4); i += kThreads) {
        const int s = i / (kNP / 4), n4 = 4 * (i % (kNP / 4));
        float4 vb = make_float4(0.0f, 0.0f, 0.0f, 0.0f), vc = vb;
        if (s < steps && n4 < N) {
          vb = __ldg(reinterpret_cast<const float4*>(b + (row0 + s) * N + n4));
          vc = __ldg(reinterpret_cast<const float4*>(c + (row0 + s) * N + n4));
        }
        *reinterpret_cast<float4*>(&sm.b[s][n4]) = vb;
        *reinterpret_cast<float4*>(&sm.c[s][n4]) = vc;
      }
    } else {
      for (int i = tid; i < kC * kPT; i += kThreads) {
        const int s = i / kPT, p = i % kPT;
        sm.x[s][p] = s < steps && p0 + p < P
                         ? __ldg(x + ((row0 + s) * H + hh) * P + p0 + p)
                         : 0.0f;
      }
      for (int i = tid; i < kC * kNP; i += kThreads) {
        const int s = i / kNP, n = i % kNP;
        const bool in = s < steps && n < N;
        sm.b[s][n] = in ? __ldg(b + (row0 + s) * N + n) : 0.0f;
        sm.c[s][n] = in ? __ldg(c + (row0 + s) * N + n) : 0.0f;
      }
    }
    if (tid < kC)
      sm.dt[tid] = tid < steps ? __ldg(dt + (row0 + tid) * H + hh) : 0.0f;
    __syncthreads();

    // y on this warp's rows, all 32 columns: first the inter-chunk term
    // C h^T (K = n), scaled by exp(pfx_t) below; then G = C B^T on the same
    // rows, in groups of 4 column tiles up to the last with s <= t.  Neither
    // needs the prefix sums, which warp 0 forms first (its rows of G are the
    // fewest).
    if (warp == 0) {
      // the prefix sums in float64 (lane l holds steps 2l and 2l+1, an
      // inclusive scan over the lanes) and the chunk's decays
      const float la0 = sm.dt[2 * lane] * ah, la1 = sm.dt[2 * lane + 1] * ah;
      const double v0 = la0, v1 = v0 + static_cast<double>(la1);
      double incl = v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      double excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.0;
      const double total = __shfl_sync(0xffffffffu, incl, 31);
      const double s0 = excl + v0, s1 = excl + v1;
      sm.pfx[2 * lane] = s0;
      sm.pfx[2 * lane + 1] = s1;
      sm.e[2 * lane] = expf(static_cast<float>(s0));
      sm.e[2 * lane + 1] = expf(static_cast<float>(s1));
      sm.w[2 * lane] = expf(static_cast<float>(total - s0)) * sm.dt[2 * lane];
      sm.w[2 * lane + 1] =
          expf(static_cast<float>(total - s1)) * sm.dt[2 * lane + 1];
      if (lane == 0) sm.decay = expf(static_cast<float>(total));
    }
    // the next chunk's x into L2 while this one computes (b and c are
    // shared by every head of the batch row, mostly in L2 already)
    if (t0 + kC < T && tid < kC && t0 + kC + tid < T)
      prefetch_l2(x + ((row0 + kC + tid) * H + hh) * P + p0);

    float yacc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[j][e] = 0.0f;
    for (int kk = 0; kk < kN; ++kk) {
      float av[4];
      tf32x3::load_a(&sm.c[16 * warp][8 * kk], kRS, 1, g, q, av);
      const tf32x3::FragA fa = tf32x3::split_a(av);
      tf32x3::FragB fb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        fb[j] = tf32x3::load_b(&sm.h[8 * j][8 * kk], 1, kRS, g, q);
      tf32x3::mma_3xtf32(yacc, fa, fb);
    }
    float gacc[2][4][4];
#pragma unroll
    for (int jg = 0; jg < 2; ++jg)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) gacc[jg][j][e] = 0.0f;
    for (int kk = 0; kk < kN; ++kk) {
      float av[4];
      tf32x3::load_a(&sm.c[16 * warp][8 * kk], kRS, 1, g, q, av);
      const tf32x3::FragA fa = tf32x3::split_a(av);
#pragma unroll
      for (int jg = 0; jg < 2; ++jg) {
        if (4 * jg < jmax) {
          tf32x3::FragB fb[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            fb[j] = tf32x3::load_b(&sm.b[8 * (4 * jg + j)][8 * kk], 1, kRS, g,
                                q);
          tf32x3::mma_3xtf32(gacc[jg], fa, fb);
        }
      }
    }
    __syncthreads();  // the prefix sums and decays are in place

    // y's inter-chunk rows scaled; M in registers, written over the warp's
    // rows of C (no other warp reads them)
    {
      const float e_lo = sm.e[t_lo], e_hi = sm.e[t_hi];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        yacc[j][0] *= e_lo;
        yacc[j][1] *= e_lo;
        yacc[j][2] *= e_hi;
        yacc[j][3] *= e_hi;
      }
      const double pt_lo = sm.pfx[t_lo], pt_hi = sm.pfx[t_hi];
#pragma unroll
      for (int jg = 0; jg < 2; ++jg) {
        if (4 * jg < jmax) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = 4 * jg + jj;
            float mv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int t = e < 2 ? t_lo : t_hi;
              const int s = 8 * j + 2 * q + (e & 1);
              const double pt = e < 2 ? pt_lo : pt_hi;
              mv[e] = s <= t ? expf(static_cast<float>(pt - sm.pfx[s])) *
                                   sm.dt[s] * gacc[jg][jj][e]
                             : 0.0f;
            }
            *reinterpret_cast<float2*>(&sm.c[t_lo][8 * j + 2 * q]) =
                make_float2(mv[0], mv[1]);
            *reinterpret_cast<float2*>(&sm.c[t_hi][8 * j + 2 * q]) =
                make_float2(mv[2], mv[3]);
          }
        }
      }
    }
    __syncwarp();  // M is written before the warp reads it back

    // then the causal half of M x, K = s; the skip; the store
    {
      const int kS = min(jmax, (steps + 7) / 8);
      for (int kk = 0; kk < kS; ++kk) {
        float av[4];
        tf32x3::load_a(&sm.c[16 * warp][8 * kk], kRS, 1, g, q, av);
        const tf32x3::FragA fa = tf32x3::split_a(av);
        tf32x3::FragB fb[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          fb[j] = tf32x3::load_b(&sm.x[8 * kk][8 * j], kXS, 1, g, q);
        tf32x3::mma_3xtf32(yacc, fa, fb);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = e < 2 ? t_lo : t_hi;
          const int p = 8 * j + 2 * q + (e & 1);
          if (t < steps && p0 + p < P)
            y[((row0 + t) * H + hh) * P + p0 + p] =
                yacc[j][e] + dh * sm.x[t][p];
        }
      }
    }

    // the state: h = exp(pfx_last) h + x^T diag(w) B on this warp's tile
    {
      const float decay = sm.decay;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[j][e] *= decay;
      const int kS = (steps + 7) / 8;
      for (int kk = 0; kk < kS; ++kk) {
        float av[4];
        tf32x3::load_a(&sm.x[8 * kk][pr], 1, kXS, g, q, av);
        const float w_lo = sm.w[8 * kk + q], w_hi = sm.w[8 * kk + q + 4];
        av[0] *= w_lo;
        av[1] *= w_lo;
        av[2] *= w_hi;
        av[3] *= w_hi;
        const tf32x3::FragA fa = tf32x3::split_a(av);
        tf32x3::FragB fb[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          fb[j] = tf32x3::load_b(&sm.b[8 * kk][nc + 8 * j], kRS, 1, g, q);
        tf32x3::mma_3xtf32(hacc, fa, fb);
      }
    }
    // every read of this chunk's tiles and of the old state is done before
    // the state is overwritten and the next chunk staged
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nc + 8 * j + 2 * q;
      *reinterpret_cast<float2*>(&sm.h[pr + g][n]) =
          make_float2(hacc[j][0], hacc[j][1]);
      *reinterpret_cast<float2*>(&sm.h[pr + g + 8][n]) =
          make_float2(hacc[j][2], hacc[j][3]);
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + pr + g + 8 * (e >> 1);
      const int n = nc + 8 * j + 2 * q + (e & 1);
      if (p < P && n < N)
        state_out[sbase + static_cast<size_t>(p) * N + n] = hacc[j][e];
    }
  }
}

}  // namespace

// Launches the chunked kernel on `stream`; returns cudaGetLastError().
// vec: x, b and c 16-byte aligned with P and N multiples of 4.
cudaError_t ssm_chunked_launch(const float* x, const float* b, const float* c,
                               const float* dt, const float* a,
                               const float* d, const float* state0, float* y,
                               float* state_out, int B, int T, int H, int P,
                               int N, bool vec, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(ChunkSmem));
  cudaError_t err = cudaFuncSetAttribute(
      ssm_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // the whole unified cache as shared memory: 4 blocks of 54 KB an SM
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssm_chunked_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + kPT - 1) / kPT, H, B);
  ssm_chunked_kernel<<<grid, kThreads, smem, stream>>>(
      x, b, c, dt, a, d, state0, y, state_out, T, H, P, N, vec ? 1 : 0);
  return cudaGetLastError();
}
