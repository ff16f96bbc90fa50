// Grouped-query flash attention over explicit positions, for Hopper (sm_90a):
//   o (B, Sq, Hq, D) = softmax(mask(q k^T * scale)) v
//
// It replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py: flash_attention (:83,
//   its pallas_call at :121; _fa_kernel),
// and serves every attention of the port's dense transformer: the prefill's
// self attention (arange positions) and each decode step's attention against
// the KV cache (the cache's positions, -1 on an unwritten slot).
//
// The C entry point at the end launches one of three kernels, one launch a
// call, by the rule of kernel.py: kernel_for:
//   * (query, head) rows a KV head Sq * G <= 64, float32 or bf16: kernel B,
//     the split-Sk decode (flash_decode.cu);
//   * otherwise bf16 with D % 8 == 0: kernel A, the wgmma + TMA prefill
//     (flash_prefill.cu);
//   * otherwise (a float32 prefill, bf16 with D % 8 != 0): the SIMT kernel
//     of this file.
//
// Layouts are the port's public ones, row-major and contiguous, with no
// transpose and no repeat of the KV heads:
//   q      (B, Sq, Hq, D)  float32 or bfloat16
//   k, v   (B, Sk, Hkv, D) in q's type
//   q_pos  (B, Sq) int32
//   kv_pos (B, Sk) int32, -1 marks a slot that was never written
//   o      (B, Sq, Hq, D)  in q's type
// Query head hq reads KV head hq / (Hq / Hkv).  A slot counts for a query
// when kv_pos >= 0, and with `causal` when kv_pos <= q_pos, and with
// `window` > 0 when q_pos - kv_pos < window: exactly the mask of the
// reference's models/attention.py: attend.  The statistics are the
// reference's online softmax in float32 (running max m, sum l, accumulator
// acc; a fully masked row keeps m at -1e30 and returns acc / max(l, 1e-30)
// = 0); bf16 inputs are converted to float32 on load, exp is expf.  With
// p_bf16 (the reference's attend(p_dtype=bfloat16)) p and v are rounded to
// bf16 before the P V product, which accumulates in f32.
//
// The SIMT kernel.  What bounds it: its own arithmetic.  At the served
// float32 shapes the bytes (~38 MB for a TinyLlama-1.1B prefill layer) set
// the function's bound, but this kernel runs every product as an f32 FMA
// on the CUDA cores (67 TFLOP/s at most): float32 stays off the tensor
// cores, since TF32 would break the float32 tolerance.  Its design:
//   * one block of 256 threads owns 64 rows of one (batch, KV head): the
//     rows are the (query, head) pairs of that KV head's group, query-major,
//     so a K/V tile staged once in shared memory serves all G query heads
//     of the group (GQA reads each K/V byte once per block, not G times);
//   * a loop over K/V tiles of 64 keys inside the block; per tile three
//     phases: scores (a 4 x 4 register tile a thread, into shared memory,
//     masked by position), the online-softmax update (one warp per row),
//     and P V (each thread a quarter of one row's D columns, kept in
//     registers across the whole loop);
//   * a tile whose every slot is masked for every row of the block is
//     skipped (positions are read first); skipping is exact, since a fully
//     masked tile leaves m, l and acc as they were;
//   * every ragged edge is guarded: any Sq and Sk, any D <= 256 (D = 120
//     included), no padding copies.  The instances for D <= 64, 128 and
//     256 keep D / 4 columns a thread in registers; at D = 256 the staged
//     q, K and V rows take 210 KB of the 227 KB of shared memory.
#include "hopper.cuh"

#include <limits.h>

namespace {

constexpr int kRows = 64;      // (query, head) rows per block
constexpr int kKeys = 64;      // keys per staged K/V tile: two per lane
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
using flash::kNegInf;
static_assert(kKeys == 64, "the softmax phase gives each lane two keys");
static_assert(kRows * 4 == kThreads, "P V gives each row four threads");
static_assert(kRows * kKeys == kThreads * 16, "scores: 4 x 4 a thread");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Row stride of the staged q and K rows: odd, so the 16 keys (and the rows
// 4 apart) a warp reads at one d fall in distinct banks.
__host__ __device__ __forceinline__ int odd_stride(int D) {
  return (D % 2 == 0) ? D + 1 : D;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int D) {
  const int ks = odd_stride(D);
  return sizeof(float) * (static_cast<size_t>(kRows) * ks   // q rows
                          + static_cast<size_t>(kKeys) * ks // K tile
                          + static_cast<size_t>(kKeys) * D  // V tile
                          + kRows * (kKeys + 1)             // scores, then p
                          + 3 * kRows)                      // m, l, corr
         + sizeof(int) * (kRows + kKeys);                   // positions
}

template <typename T, int kMaxD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ kv_pos, T* __restrict__ o,
                       int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                       int window, float scale, int p_bf16) {
  extern __shared__ float smem[];
  const int ks = odd_stride(D);
  float* qs = smem;                         // [kRows][ks]
  float* kt = qs + kRows * ks;              // [kKeys][ks]
  float* vt = kt + kKeys * ks;              // [kKeys][D]
  float* st = vt + kKeys * D;               // [kRows][kKeys + 1]
  float* m_s = st + kRows * (kKeys + 1);    // [kRows]
  float* l_s = m_s + kRows;                 // [kRows]
  float* corr_s = l_s + kRows;              // [kRows]
  int* qpos_s = reinterpret_cast<int*>(corr_s + kRows);  // [kRows]
  int* kpos_s = qpos_s + kRows;                          // [kKeys]
  __shared__ int q_lo, q_hi;  // least and largest query position of the block

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int hkv = blockIdx.y;
  const int G = Hq / Hkv;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, Sq * G - row0);  // live rows of this block

  // row r is the pair (query i, head hkv * G + g), (i, g) = divmod(row0+r, G)
  for (int e = tid; e < kRows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float val = 0.0f;
    if (r < rows) {
      const int i = (row0 + r) / G, g = (row0 + r) % G;
      val = to_f32(q[((static_cast<long long>(b) * Sq + i) * Hq + hkv * G + g)
                         * D + d]);
    }
    qs[r * ks + d] = val;
  }
  if (tid < kRows) {
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

  constexpr int kCols = kMaxD / 4;  // D columns a thread keeps in P V
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
  const int pr = tid / 4, part = tid % 4;     // P V: row, column phase
  const int sr = tid / 16, sk = tid % 16;     // scores: rows 4sr.., keys sk+16j
  const int warp = tid / 32, lane = tid % 32;

  for (int k0 = 0; k0 < Sk; k0 += kKeys) {
    const int nk = min(kKeys, Sk - k0);
    __syncthreads();  // the last tile's readers are done; q_lo, q_hi visible
    int live = 0;
    if (tid < kKeys) {
      const int p = tid < nk
          ? kv_pos[static_cast<long long>(b) * Sk + k0 + tid] : -1;
      kpos_s[tid] = p;
      // some row of the block may attend slot p (a superset test)
      live = p >= 0 && (!causal || p <= q_hi) &&
             (window <= 0 || q_lo - p < window);
    }
    if (!__syncthreads_or(live)) continue;  // uniform: every row masked

    for (int e = tid; e < kKeys * D; e += kThreads) {
      const int j = e / D, d = e % D;
      float kx = 0.0f, vx = 0.0f;
      if (j < nk) {
        const long long off =
            ((static_cast<long long>(b) * Sk + k0 + j) * Hkv + hkv) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      kt[j * ks + d] = kx;
      vt[j * D + d] = p_bf16 ? flash::round_bf16(vx) : vx;
    }
    __syncthreads();

    // scores, masked by position: rows 4sr..4sr+3, keys sk + 16 jj
    {
      float sacc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sacc[i][jj] = 0.0f;
      if (sr * 4 < rows) {
        for (int d = 0; d < D; ++d) {
          float a[4], bk[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qs[(sr * 4 + i) * ks + d];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) bk[jj] = kt[(sk + 16 * jj) * ks + d];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              sacc[i][jj] = fmaf(a[i], bk[jj], sacc[i][jj]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = sr * 4 + i;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = sk + 16 * jj;
          float s = kNegInf;
          if (r < rows) {
            const int kp = kpos_s[j], qp = qpos_s[r];
            if (kp >= 0 && (!causal || kp <= qp) &&
                (window <= 0 || qp - kp < window))
              s = sacc[i][jj] * scale;
          }
          st[r * (kKeys + 1) + j] = s;
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per row, rows dealt round the warps (a
    // decode block's G live rows then run on G warps): p replaces s in place
    for (int rr = 0; rr < kRows / kWarps; ++rr) {
      const int r = rr * kWarps + warp;
      if (r >= rows) break;  // uniform within the warp
      float* srow = st + r * (kKeys + 1);
      const float s0 = srow[lane], s1 = srow[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      // keep m finite for exp on a row masked so far
      const float m_safe = m_new <= kNegInf / 2 ? 0.0f : m_new;
      const float p0 = s0 > kNegInf / 2 ? expf(s0 - m_safe) : 0.0f;
      const float p1 = s1 > kNegInf / 2 ? expf(s1 - m_safe) : 0.0f;
      srow[lane] = p_bf16 ? flash::round_bf16(p0) : p0;
      srow[lane + 32] = p_bf16 ? flash::round_bf16(p1) : p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = m_old <= kNegInf / 2 ? 0.0f : expf(m_old - m_safe);
        corr_s[r] = corr;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
      }
    }
    __syncthreads();

    // acc = acc * corr + p V; thread (pr, part) owns columns part + 4c
    if (pr < rows) {
      const float corr = corr_s[pr];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] *= corr;
      const float* prow = st + pr * (kKeys + 1);
      for (int j = 0; j < nk; ++j) {
        const float p = prow[j];
        const float* vrow = vt + j * D;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = part + 4 * c;
          if (d < D) acc[c] = fmaf(p, vrow[d], acc[c]);
        }
      }
    }
  }

  if (pr < rows) {
    const float denom = fmaxf(l_s[pr], 1e-30f);
    const int i = (row0 + pr) / G, g = (row0 + pr) % G;
    T* orow = o + ((static_cast<long long>(b) * Sq + i) * Hq + hkv * G + g) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = part + 4 * c;
      if (d < D) store(orow + d, acc[c] / denom);
    }
  }
}

template <typename T, int kMaxD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_pos, const void* kv_pos, void* o, int B,
                   int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                   int window, float scale, int p_bf16, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, kMaxD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(Sq) * (Hq / Hkv);
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows), Hkv, B);
  flash_attention_kernel<T, kMaxD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<T*>(o), Sq, Sk, Hq, Hkv, D,
      causal, window, scale, p_bf16);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* q_pos, const void* kv_pos, void* o, int B,
                     int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                     int window, float scale, int p_bf16,
                     cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, q_pos, kv_pos, o, B, Sq, Sk, Hq, Hkv, D,
                         causal, window, scale, p_bf16, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, q_pos, kv_pos, o, B, Sq, Sk, Hq, Hkv, D,
                          causal, window, scale, p_bf16, stream);
  return launch<T, 256>(q, k, v, q_pos, kv_pos, o, B, Sq, Sk, Hq, Hkv, D,
                        causal, window, scale, p_bf16, stream);
}

}  // namespace

extern "C" {

// Launches kernel `kernel` (flash::Kernel: 0 the SIMT kernel, 1 the wgmma
// prefill, 2 the split decode) on `stream` and returns cudaGetLastError()
// (0 on success).  is_bf16 selects bfloat16 q, k, v and o, otherwise all
// four are float32; p_bf16 rounds p and v to bf16 before P V.  The split
// decode takes `scratch` (2 + D floats for each of the B Hkv Sq G rows and
// each split of 64 keys) and `counters` (B Hkv ints, zero before the first
// call, left zero by every call); the others take null.  A kernel that
// cannot take the call (A: float32, D % 8 != 0 or a k or v not 16-byte
// aligned; B: more than 64 rows a KV head) is refused with
// cudaErrorInvalidValue, as is a shape out of range.
int flash_attention_forward(const void* q, const void* k, const void* v,
                            const void* q_pos, const void* kv_pos, void* o,
                            int B, int Sq, int Sk, int Hq, int Hkv, int D,
                            int causal, int window, float scale, int is_bf16,
                            int p_bf16, int kernel, void* scratch,
                            void* counters, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Sk < 0 || Hkv < 1 || Hq % Hkv != 0 || D < 1 || D > 256 || B > 65535 ||
      Hkv > 65535 ||
      (static_cast<long long>(Sq) * (Hq / Hkv) + kRows - 1) / kRows >
          INT_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  switch (kernel) {
    case flash::kSimt:
      return static_cast<int>(
          is_bf16 ? launch_d<__nv_bfloat16>(q, k, v, q_pos, kv_pos, o, B, Sq,
                                            Sk, Hq, Hkv, D, causal, window,
                                            scale, p_bf16, s)
                  : launch_d<float>(q, k, v, q_pos, kv_pos, o, B, Sq, Sk, Hq,
                                    Hkv, D, causal, window, scale, p_bf16, s));
    case flash::kPrefillWgmma:
      if (!is_bf16) return cudaErrorInvalidValue;
      return static_cast<int>(flash_prefill_wgmma_launch(
          q, k, v, qp, kp, o, B, Sq, Sk, Hq, Hkv, D, causal, window, scale,
          p_bf16, s));
    case flash::kDecodeSplit:
      return static_cast<int>(flash_decode_split_launch(
          q, k, v, qp, kp, o, static_cast<float*>(scratch),
          static_cast<int*>(counters), B, Sq, Sk, Hq, Hkv, D, causal, window,
          scale, is_bf16, p_bf16, s));
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
