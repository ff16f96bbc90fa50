// Backward of grouped-query flash attention over explicit positions, for
// Hopper (sm_90a): given q, k, v, the forward's output o and its gradient
// dO, the gradients
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O)
//   dQ = scale dS K,  dK = scale dS^T Q
// with P = softmax(mask(q k^T * scale)) recomputed here.
//
// It replaces no Pallas kernel: the reference's Pallas flash attention
//   src/repro/kernels/flash_attention/kernel.py: flash_attention (:83)
// has no backward, and the reference trains through XLA's autodiff of the
// chunked scan src/repro/models/attention.py: attend.  On the card the
// port's attend is kernel #6 (flash_attention.cu and its two Hopper
// kernels), whose launch carries no autograd graph, so training needs this
// gradient as a kernel of its own.
//
// The forward kernels are not changed: their outputs and launch counts stay
// as they are, and nothing is saved by them.  So the backward recomputes
// each row's softmax statistics.  Two launches, no atomics, every sum taken
// in one fixed order (reruns are bit-identical):
//   * bwd_dq: one block for a tile of (query, head) rows of one (batch, KV
//     head), the forward's SIMT row layout (row i * G + g is query i, head
//     hkv * G + g).  A first pass over the keys gives each row's max m and
//     sum l, hence lse = m + log l; delta = rowsum(dO * O) reads the
//     forward's own O.  A second pass recomputes P = exp(s - lse) and dP
//     and accumulates dQ.  lse and delta go to scratch (B, Hkv, Sq G).
//   * bwd_dkdv: one block for a tile of keys of one (batch, KV head).  It
//     walks all Sq G rows of the group (the G query heads of the KV head)
//     in row order, a tile at a time, recomputing P and dS from lse and
//     delta, and accumulates dV and dK for its keys: the group's sum is
//     taken in-kernel, in one order, with nothing repeated.
//
// Layouts are the forward's, row-major and contiguous:
//   q, o, dO, dq  (B, Sq, Hq, D)   float32 or bfloat16
//   k, v, dk, dv  (B, Sk, Hkv, D)  in q's type
//   q_pos (B, Sq), kv_pos (B, Sk)  int32, -1 marks an unwritten slot
// The mask is the forward's (flash::attends): written, not after the query
// when causal, less than `window` behind it when window > 0.  A row that
// attends no slot has zero gradient (the forward's m_safe guard gives it
// o = 0 whatever q, k and v are).  Every product and sum is float32; bf16
// inputs are converted on load and the gradients rounded once on store.
//
// What bounds it: its own arithmetic.  At TinyLlama-1.1B's training shape
// (B 4, S 512, 32:4 heads, D 64, causal) the five products of a flash
// backward are ~11 GFLOP, 0.011 ms at the bf16 tensor-core rate, and the
// bytes of q, k, v, o, dO and the three gradients are less.  This first
// kernel runs every product as an f32 FMA on the CUDA cores from shared
// memory, like the forward's SIMT kernel, and recomputes the scores twice
// (once a kernel).  Its design keeps it simple and exact:
//   * 256 threads a block; tiles of 64 rows and 64 keys (32 and 32 above
//     D = 128, so that q, dO, K and V, staged in shared memory at an odd
//     row stride, fit: 140 KB at D = 256);
//   * the two score-shaped products (q k^T and dO v^T) in one loop over d,
//     a (tile/16) x (tile/16) register tile a thread;
//   * the D-wide accumulators (dQ; dK and dV) split over 4 threads a row
//     (8 above D = 128), at most 32 floats each a thread in registers;
//   * a tile that no row of the block can attend is skipped, as in the
//     forward (a superset test on positions; skipping is exact).
#include "hopper.cuh"

#include <limits.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
using flash::attends;
using flash::kNegInf;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Row stride of a staged (rows, D) tile: odd, so the 16 rows a warp reads
// at one d fall in distinct banks.
__host__ __device__ __forceinline__ int odd_stride(int D) {
  return (D % 2 == 0) ? D + 1 : D;
}

// The tiling of the instance for head dims up to kMaxD.
template <int kMaxD>
struct Tiles {
  static constexpr int kTile = kMaxD > 128 ? 32 : 64;  // rows, keys a tile
  static constexpr int kMicro = kTile / 16;  // score tile a thread: kMicro^2
  static constexpr int kPer = kThreads / kTile;  // threads a D-wide row
  static constexpr int kCols = kMaxD / kPer;     // its columns a thread
  static_assert(kTile % 32 == 0, "the softmax pass gives each lane keys");
};

template <int kMaxD>
size_t dq_smem_bytes(int D) {
  constexpr int kT = Tiles<kMaxD>::kTile;
  return sizeof(float) * (4 * static_cast<size_t>(kT) * odd_stride(D)
                          + kT * (kT + 1) + 4 * kT)
         + sizeof(int) * 2 * kT;
}

template <int kMaxD>
size_t dkdv_smem_bytes(int D) {
  constexpr int kT = Tiles<kMaxD>::kTile;
  return sizeof(float) * (4 * static_cast<size_t>(kT) * odd_stride(D)
                          + 2 * kT * (kT + 1) + 2 * kT)
         + sizeof(int) * 2 * kT;
}

// Offset of (query, head) row R of KV head hkv's group in q, o, dO or dq.
__device__ __forceinline__ long long row_offset(int b, int R, int hkv, int Sq,
                                                int Hq, int G, int D) {
  const int i = R / G, g = R % G;
  return ((static_cast<long long>(b) * Sq + i) * Hq + hkv * G + g) * D;
}

// Offset of key j of KV head hkv in k, v, dk or dv.
__device__ __forceinline__ long long key_offset(int b, int j, int hkv, int Sk,
                                               int Hkv, int D) {
  return ((static_cast<long long>(b) * Sk + j) * Hkv + hkv) * D;
}

// c[i][jj] = sum_d a[(sr M + i) ks + d] b[(sk + 16 jj) ks + d] and
// e[i][jj] the same of a2, b2: the two score-shaped products in one loop.
template <int M>
__device__ __forceinline__ void two_products(const float* a, const float* b,
                                             const float* a2, const float* b2,
                                             int ks, int D, int sr, int sk,
                                             float c[M][M], float e[M][M]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int jj = 0; jj < M; ++jj) c[i][jj] = e[i][jj] = 0.0f;
  for (int d = 0; d < D; ++d) {
    float x[M], y[M], x2[M], y2[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      x[i] = a[(sr * M + i) * ks + d];
      x2[i] = a2[(sr * M + i) * ks + d];
    }
#pragma unroll
    for (int jj = 0; jj < M; ++jj) {
      y[jj] = b[(sk + 16 * jj) * ks + d];
      y2[jj] = b2[(sk + 16 * jj) * ks + d];
    }
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int jj = 0; jj < M; ++jj) {
        c[i][jj] = fmaf(x[i], y[jj], c[i][jj]);
        e[i][jj] = fmaf(x2[i], y2[jj], e[i][jj]);
      }
  }
}

// c[i][jj] = sum_d a[(sr M + i) ks + d] b[(sk + 16 jj) ks + d] alone.
template <int M>
__device__ __forceinline__ void one_product(const float* a, const float* b,
                                            int ks, int D, int sr, int sk,
                                            float c[M][M]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int jj = 0; jj < M; ++jj) c[i][jj] = 0.0f;
  for (int d = 0; d < D; ++d) {
    float x[M], y[M];
#pragma unroll
    for (int i = 0; i < M; ++i) x[i] = a[(sr * M + i) * ks + d];
#pragma unroll
    for (int jj = 0; jj < M; ++jj) y[jj] = b[(sk + 16 * jj) * ks + d];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int jj = 0; jj < M; ++jj) c[i][jj] = fmaf(x[i], y[jj], c[i][jj]);
  }
}

template <typename T, int kMaxD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const int* __restrict__ q_pos,
                    const int* __restrict__ kv_pos, T* __restrict__ dq,
                    float* __restrict__ lse_out,
                    float* __restrict__ delta_out, int Sq, int Sk, int Hq,
                    int Hkv, int D, int causal, int window, float scale) {
  using Tl = Tiles<kMaxD>;
  constexpr int kT = Tl::kTile, kM = Tl::kMicro, kPer = Tl::kPer;
  constexpr int kCols = Tl::kCols;
  extern __shared__ float smem[];
  const int ks = odd_stride(D);
  float* qs = smem;                        // [kT][ks]
  float* dos = qs + kT * ks;               // [kT][ks]
  float* kt = dos + kT * ks;               // [kT][ks]
  float* vt = kt + kT * ks;                // [kT][ks]
  float* st = vt + kT * ks;                // [kT][kT + 1]: s, then dS
  float* lse_s = st + kT * (kT + 1);       // [kT]
  float* delta_s = lse_s + kT;             // [kT]
  float* m_s = delta_s + kT;               // [kT]
  float* l_s = m_s + kT;                   // [kT]
  int* qpos_s = reinterpret_cast<int*>(l_s + kT);  // [kT]
  int* kpos_s = qpos_s + kT;                       // [kT]
  __shared__ int q_lo, q_hi;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z, hkv = blockIdx.y;
  const int G = Hq / Hkv;
  const int rows_total = Sq * G;
  const int row0 = blockIdx.x * kT;
  const int rows = min(kT, rows_total - row0);

  for (int e = tid; e < kT * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float qv = 0.0f, dv = 0.0f;
    if (r < rows) {
      const long long off = row_offset(b, row0 + r, hkv, Sq, Hq, G, D) + d;
      qv = to_f32(q[off]);
      dv = to_f32(dout[off]);
    }
    qs[r * ks + d] = qv;
    dos[r * ks + d] = dv;
  }
  // delta = rowsum(dO * O), one warp a row
  for (int r = warp; r < kT; r += kWarps) {
    float sum = 0.0f;
    if (r < rows) {
      const long long off = row_offset(b, row0 + r, hkv, Sq, Hq, G, D);
      for (int d = lane; d < D; d += 32)
        sum = fmaf(to_f32(dout[off + d]), to_f32(o[off + d]), sum);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) delta_s[r] = sum;
  }
  if (tid < kT) {
    qpos_s[tid] = tid < rows
        ? q_pos[static_cast<long long>(b) * Sq + (row0 + tid) / G] : 0;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }
  __syncthreads();
  if (tid == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = 0; r < rows; ++r) {
      lo = min(lo, qpos_s[r]);
      hi = max(hi, qpos_s[r]);
    }
    q_lo = lo;
    q_hi = hi;
  }

  const int sr = tid / 16, sk = tid % 16;  // score tile: rows sr M.., keys sk + 16 jj
  // pass 1: each row's max m and sum l of p = exp(s - m), online
  for (int k0 = 0; k0 < Sk; k0 += kT) {
    const int nk = min(kT, Sk - k0);
    __syncthreads();  // the last tile's readers are done; q_lo, q_hi visible
    int live = 0;
    if (tid < kT) {
      const int p = tid < nk
          ? kv_pos[static_cast<long long>(b) * Sk + k0 + tid] : -1;
      kpos_s[tid] = p;
      live = p >= 0 && (!causal || p <= q_hi) &&
             (window <= 0 || q_lo - p < window);
    }
    if (!__syncthreads_or(live)) continue;  // uniform: every row masked
    for (int e = tid; e < kT * D; e += kThreads) {
      const int j = e / D, d = e % D;
      kt[j * ks + d] = j < nk ? to_f32(k[key_offset(b, k0 + j, hkv, Sk, Hkv,
                                                    D) + d])
                              : 0.0f;
    }
    __syncthreads();
    {
      float c[kM][kM];
      one_product<kM>(qs, kt, ks, sr * kM < rows ? D : 0, sr, sk, c);
#pragma unroll
      for (int i = 0; i < kM; ++i)
#pragma unroll
        for (int jj = 0; jj < kM; ++jj) {
          const int r = sr * kM + i, j = sk + 16 * jj;
          st[r * (kT + 1) + j] =
              r < rows && attends(kpos_s[j], qpos_s[r], causal, window)
                  ? c[i][jj] * scale : kNegInf;
        }
    }
    __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {
      const float* srow = st + r * (kT + 1);
      float s[kT / 32];
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < kT / 32; ++t) {
        s[t] = srow[lane + 32 * t];
        mx = fmaxf(mx, s[t]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = m_new <= kNegInf / 2 ? 0.0f : m_new;
      float sum = 0.0f;
#pragma unroll
      for (int t = 0; t < kT / 32; ++t)
        sum += s[t] > kNegInf / 2 ? expf(s[t] - m_safe) : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = m_old <= kNegInf / 2 ? 0.0f : expf(m_old - m_safe);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
      }
    }
  }
  __syncthreads();
  if (tid < kT) {
    // a row that attends no slot keeps m = -1e30: its p is 0 by the mask
    const float lse = m_s[tid] > kNegInf / 2 ? m_s[tid] + logf(l_s[tid])
                                             : 0.0f;
    lse_s[tid] = lse;
    if (tid < rows) {
      const long long at =
          (static_cast<long long>(b) * Hkv + hkv) * rows_total + row0 + tid;
      lse_out[at] = lse;
      delta_out[at] = delta_s[tid];
    }
  }

  // pass 2: dQ = scale sum_j dS_ij K_j, dS = P (dP - delta)
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
  const int pr = tid / kPer, part = tid % kPer;
  for (int k0 = 0; k0 < Sk; k0 += kT) {
    const int nk = min(kT, Sk - k0);
    __syncthreads();
    int live = 0;
    if (tid < kT) {
      const int p = tid < nk
          ? kv_pos[static_cast<long long>(b) * Sk + k0 + tid] : -1;
      kpos_s[tid] = p;
      live = p >= 0 && (!causal || p <= q_hi) &&
             (window <= 0 || q_lo - p < window);
    }
    if (!__syncthreads_or(live)) continue;
    for (int e = tid; e < kT * D; e += kThreads) {
      const int j = e / D, d = e % D;
      float kx = 0.0f, vx = 0.0f;
      if (j < nk) {
        const long long off = key_offset(b, k0 + j, hkv, Sk, Hkv, D) + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      kt[j * ks + d] = kx;
      vt[j * ks + d] = vx;
    }
    __syncthreads();
    {
      float s[kM][kM], dp[kM][kM];
      two_products<kM>(qs, kt, dos, vt, ks, sr * kM < rows ? D : 0, sr, sk,
                       s, dp);
#pragma unroll
      for (int i = 0; i < kM; ++i)
#pragma unroll
        for (int jj = 0; jj < kM; ++jj) {
          const int r = sr * kM + i, j = sk + 16 * jj;
          float ds = 0.0f;
          if (r < rows && attends(kpos_s[j], qpos_s[r], causal, window)) {
            const float p = expf(s[i][jj] * scale - lse_s[r]);
            ds = p * (dp[i][jj] - delta_s[r]);
          }
          st[r * (kT + 1) + j] = ds;
        }
    }
    __syncthreads();
    if (pr < rows) {
      const float* dsrow = st + pr * (kT + 1);
      for (int j = 0; j < nk; ++j) {
        const float ds = dsrow[j];
        const float* krow = kt + j * ks;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = part + kPer * c;
          if (d < D) acc[c] = fmaf(ds, krow[d], acc[c]);
        }
      }
    }
  }
  if (pr < rows) {
    T* out = dq + row_offset(b, row0 + pr, hkv, Sq, Hq, G, D);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = part + kPer * c;
      if (d < D) store(out + d, acc[c] * scale);
    }
  }
}

template <typename T, int kMaxD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const int* __restrict__ q_pos,
                      const int* __restrict__ kv_pos,
                      const float* __restrict__ lse_in,
                      const float* __restrict__ delta_in, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv,
                      int D, int causal, int window, float scale) {
  using Tl = Tiles<kMaxD>;
  constexpr int kT = Tl::kTile, kM = Tl::kMicro, kPer = Tl::kPer;
  constexpr int kCols = Tl::kCols;
  extern __shared__ float smem[];
  const int ks = odd_stride(D);
  float* kt = smem;                        // [kT][ks]
  float* vt = kt + kT * ks;                // [kT][ks]
  float* qs = vt + kT * ks;                // [kT][ks]
  float* dos = qs + kT * ks;               // [kT][ks]
  float* pt = dos + kT * ks;               // [kT][kT + 1]: P, rows x keys
  float* dst = pt + kT * (kT + 1);         // [kT][kT + 1]: dS
  float* lse_s = dst + kT * (kT + 1);      // [kT]
  float* delta_s = lse_s + kT;             // [kT]
  int* qpos_s = reinterpret_cast<int*>(delta_s + kT);  // [kT]
  int* kpos_s = qpos_s + kT;                           // [kT]
  __shared__ int k_lo, k_hi;  // least and largest written position

  const int tid = threadIdx.x;
  const int b = blockIdx.z, hkv = blockIdx.y;
  const int G = Hq / Hkv;
  const int rows_total = Sq * G;
  const int key0 = blockIdx.x * kT;
  const int nk = min(kT, Sk - key0);

  for (int e = tid; e < kT * D; e += kThreads) {
    const int j = e / D, d = e % D;
    float kx = 0.0f, vx = 0.0f;
    if (j < nk) {
      const long long off = key_offset(b, key0 + j, hkv, Sk, Hkv, D) + d;
      kx = to_f32(k[off]);
      vx = to_f32(v[off]);
    }
    kt[j * ks + d] = kx;
    vt[j * ks + d] = vx;
  }
  if (tid < kT)
    kpos_s[tid] = tid < nk
        ? kv_pos[static_cast<long long>(b) * Sk + key0 + tid] : -1;
  __syncthreads();
  if (tid == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int j = 0; j < nk; ++j) {
      if (kpos_s[j] < 0) continue;
      lo = min(lo, kpos_s[j]);
      hi = max(hi, kpos_s[j]);
    }
    k_lo = lo;
    k_hi = hi;
  }

  float acc_k[kCols], acc_v[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc_k[c] = acc_v[c] = 0.0f;
  const int pk = tid / kPer, part = tid % kPer;
  const int sr = tid / 16, sk = tid % 16;
  const long long stat0 = (static_cast<long long>(b) * Hkv + hkv) * rows_total;

  // the group's rows in row order, a tile at a time
  for (int R0 = 0; R0 < rows_total; R0 += kT) {
    const int nr = min(kT, rows_total - R0);
    __syncthreads();  // the last tile's readers are done; k_lo, k_hi visible
    int live = 0;
    if (tid < kT) {
      const int qp = tid < nr
          ? q_pos[static_cast<long long>(b) * Sq + (R0 + tid) / G] : 0;
      qpos_s[tid] = qp;
      // some written key of the block may be attended by this row
      live = tid < nr && k_lo <= k_hi && (!causal || k_lo <= qp) &&
             (window <= 0 || qp - k_hi < window);
    }
    if (!__syncthreads_or(live)) continue;  // uniform
    for (int e = tid; e < kT * D; e += kThreads) {
      const int r = e / D, d = e % D;
      float qv = 0.0f, dv_ = 0.0f;
      if (r < nr) {
        const long long off = row_offset(b, R0 + r, hkv, Sq, Hq, G, D) + d;
        qv = to_f32(q[off]);
        dv_ = to_f32(dout[off]);
      }
      qs[r * ks + d] = qv;
      dos[r * ks + d] = dv_;
    }
    if (tid < kT) {
      lse_s[tid] = tid < nr ? lse_in[stat0 + R0 + tid] : 0.0f;
      delta_s[tid] = tid < nr ? delta_in[stat0 + R0 + tid] : 0.0f;
    }
    __syncthreads();
    {
      float s[kM][kM], dp[kM][kM];
      two_products<kM>(qs, kt, dos, vt, ks, sr * kM < nr ? D : 0, sr, sk, s,
                       dp);
#pragma unroll
      for (int i = 0; i < kM; ++i)
#pragma unroll
        for (int jj = 0; jj < kM; ++jj) {
          const int r = sr * kM + i, j = sk + 16 * jj;
          float p = 0.0f, ds = 0.0f;
          if (r < nr && attends(kpos_s[j], qpos_s[r], causal, window)) {
            p = expf(s[i][jj] * scale - lse_s[r]);
            ds = p * (dp[i][jj] - delta_s[r]);
          }
          pt[r * (kT + 1) + j] = p;
          dst[r * (kT + 1) + j] = ds;
        }
    }
    __syncthreads();
    // dV_j += sum_r P_rj dO_r, dK_j += sum_r dS_rj q_r, rows in order
    if (pk < nk) {
      for (int r = 0; r < nr; ++r) {
        const float p = pt[r * (kT + 1) + pk];
        const float ds = dst[r * (kT + 1) + pk];
        const float* qrow = qs + r * ks;
        const float* dorow = dos + r * ks;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = part + kPer * c;
          if (d < D) {
            acc_v[c] = fmaf(p, dorow[d], acc_v[c]);
            acc_k[c] = fmaf(ds, qrow[d], acc_k[c]);
          }
        }
      }
    }
  }
  if (pk < nk) {
    const long long off = key_offset(b, key0 + pk, hkv, Sk, Hkv, D);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = part + kPer * c;
      if (d < D) {
        store(dk + off + d, acc_k[c] * scale);
        store(dv + off + d, acc_v[c]);
      }
    }
  }
}

template <typename T, int kMaxD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const int* q_pos,
                      const int* kv_pos, void* dq, float* lse, float* delta,
                      int B, int Sq, int Sk, int Hq, int Hkv, int D,
                      int causal, int window, float scale,
                      cudaStream_t stream) {
  constexpr int kT = Tiles<kMaxD>::kTile;
  const size_t smem = dq_smem_bytes<kMaxD>(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, kMaxD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(Sq) * (Hq / Hkv);
  const dim3 grid(static_cast<unsigned>((rows + kT - 1) / kT), Hkv, B);
  flash_bwd_dq_kernel<T, kMaxD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), q_pos, kv_pos, static_cast<T*>(dq), lse,
      delta, Sq, Sk, Hq, Hkv, D, causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int kMaxD>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* dout, const int* q_pos, const int* kv_pos,
                        const float* lse, const float* delta, void* dk,
                        void* dv, int B, int Sq, int Sk, int Hq, int Hkv,
                        int D, int causal, int window, float scale,
                        cudaStream_t stream) {
  constexpr int kT = Tiles<kMaxD>::kTile;
  const size_t smem = dkdv_smem_bytes<kMaxD>(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, kMaxD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((Sk + kT - 1) / kT), Hkv, B);
  flash_bwd_dkdv_kernel<T, kMaxD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), q_pos, kv_pos,
      lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, Hq, Hkv,
      D, causal, window, scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int Sq, int Sk, int Hq, int Hkv, int D) {
  return Sq < 0 || Sk < 0 || Hkv < 1 || Hq % Hkv != 0 || D < 1 || D > 256 ||
         B > 65535 || Hkv > 65535 ||
         static_cast<long long>(Sq) * (Hq / Hkv) > INT_MAX;
}

}  // namespace

extern "C" {

// dQ of one call, and each (query, head) row's lse and delta into `lse`
// and `delta` (B Hkv Sq G floats each, row order of the group), on
// `stream`; returns cudaGetLastError() (0 on success).  is_bf16 selects
// bfloat16 q, k, v, o, dout and dq, otherwise all are float32.  No rows:
// nothing launched, 0.  A shape out of range: cudaErrorInvalidValue.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const void* q_pos,
                           const void* kv_pos, void* dq, void* lse,
                           void* delta, int B, int Sq, int Sk, int Hq,
                           int Hkv, int D, int causal, int window,
                           float scale, int is_bf16, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (bad_shape(B, Sq, Sk, Hq, Hkv, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
#define FLASH_BWD_DQ(T, MAXD)                                               \
  launch_dq<T, MAXD>(q, k, v, o, dout, qp, kp, dq, l, dl, B, Sq, Sk, Hq,   \
                     Hkv, D, causal, window, scale, s)
  cudaError_t err;
  if (is_bf16)
    err = D <= 64 ? FLASH_BWD_DQ(__nv_bfloat16, 64)
        : D <= 128 ? FLASH_BWD_DQ(__nv_bfloat16, 128)
                   : FLASH_BWD_DQ(__nv_bfloat16, 256);
  else
    err = D <= 64 ? FLASH_BWD_DQ(float, 64)
        : D <= 128 ? FLASH_BWD_DQ(float, 128)
                   : FLASH_BWD_DQ(float, 256);
#undef FLASH_BWD_DQ
  return static_cast<int>(err);
}

// dK and dV of one call from the lse and delta flash_attention_bwd_dq wrote
// (launched after it on the same stream); returns cudaGetLastError().  No
// keys or no rows: nothing launched, 0 (the caller zeroes dk and dv).
int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                             const void* dout, const void* q_pos,
                             const void* kv_pos, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int Sq, int Sk, int Hq, int Hkv, int D,
                             int causal, int window, float scale, int is_bf16,
                             void* stream) {
  if (B <= 0 || Sk <= 0 || Sq <= 0) return 0;
  if (bad_shape(B, Sq, Sk, Hq, Hkv, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define FLASH_BWD_DKDV(T, MAXD)                                             \
  launch_dkdv<T, MAXD>(q, k, v, dout, qp, kp, l, dl, dk, dv, B, Sq, Sk, Hq, \
                       Hkv, D, causal, window, scale, s)
  cudaError_t err;
  if (is_bf16)
    err = D <= 64 ? FLASH_BWD_DKDV(__nv_bfloat16, 64)
        : D <= 128 ? FLASH_BWD_DKDV(__nv_bfloat16, 128)
                   : FLASH_BWD_DKDV(__nv_bfloat16, 256);
  else
    err = D <= 64 ? FLASH_BWD_DKDV(float, 64)
        : D <= 128 ? FLASH_BWD_DKDV(float, 128)
                   : FLASH_BWD_DKDV(float, 256);
#undef FLASH_BWD_DKDV
  return static_cast<int>(err);
}

}  // extern "C"
