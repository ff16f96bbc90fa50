// Kernel B of flash attention: the split-Sk decode (flash-decoding) with a
// fixed-order combine in the same launch, for sm_90a.
//   o (B, Sq, Hq, D) = softmax(mask(q k^T * scale)) v
//
// It replaces, for calls with at most 64 (query, head) rows a KV head
// (every decode step, float32 or bf16, rows of 16-byte multiples, D <=
// 256), the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py: flash_attention (:83,
//   its pallas_call at :121),
// and computes the function of the SIMT kernel (flash_attention.cu): GQA
// over explicit positions, kv_pos = -1 on an unwritten slot, `causal`,
// `window` and `scale`, the statistics in f32, a fully masked row exactly 0.
//
// What bounds it: a decode step reads the KV cache once, 2.2 MB (GQA) to
// 17.8 MB (MHA) of bf16 at the served shapes, 0.68-5.3 us at 3.35 TB/s; the
// products are a few MFLOP.  The SIMT kernel gave the step B x Hkv blocks
// of 64 rows (16 blocks with 8 live rows for TinyLlama, 128 with 1 live row
// for Zamba2's MHA) on 132 SMs, each walking every key tile in series.
// This design spreads the keys instead:
//   * the grid is (key splits of 64, groups of KV heads, B): a block holds
//     one split of one group's rows, 8 warps, a warp one row at a time;
//     at G = 1 a block packs 8 KV heads (one row each), so no warp idles;
//     the served steps launch 144 blocks, not 16 or 128;
//   * a warp scores its row against the split's 64 keys, takes the split's
//     max and sum, and accumulates p v, all on the CUDA cores in f32: the
//     step is bound by its bytes, and the tensor cores would buy nothing.
//     The warp splits into groups of lanes, a group on one key's row and
//     a lane on 16 bytes of it (on 32 bytes, two pieces 512 bytes apart,
//     where a row is longer than 512 bytes: float32 at D > 128), q's
//     bytes held in registers: each load is one 16-byte vector, the
//     scores reduce over the group by shuffles, and p v sums over the
//     groups by a butterfly in a fixed order.  So
//     rows must be 16-byte multiples (D % 8 == 0 in bf16, D % 4 == 0 in
//     float32) from 16-byte aligned starts: kernel_for sends other D to
//     the SIMT kernel, and the wrapper copies an unaligned view once;
//   * a row reads K only for the slots it attends and V only where p > 0:
//     a row with no slot in a split writes empty statistics (m = -1e30,
//     l = 0) and reads no K or V there;
//   * each split writes (m, l, acc[D]) in f32 to scratch the wrapper
//     allocates; the last block of each (batch, head group) to finish, told
//     by an arrival counter (atomicAdd after a __threadfence), combines
//     every split in split-index order and resets the counter to 0, so one
//     once-zeroed counter buffer a device serves every call.  The counter
//     only elects the block that combines; the sum's order is fixed, so a
//     rerun is bit-identical.  Calls on one stream run in order; two calls
//     in flight at once on two streams must not share a counter buffer,
//     so the wrapper keeps one a (device, stream).
// With p_bf16 (the reference's attend(p_dtype=bfloat16)) p and v are
// rounded to bf16 before the product, accumulated in f32.
#include "hopper.cuh"

namespace {

using flash::kNegInf;

constexpr int kSplit = 64;     // keys a split
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// kL: lanes a key row (the 16-byte chunks of a row, rounded up to a power
// of two, at most 32); kP: chunks a lane (2 where a row has more than 32)
template <typename T, int kL, int kP>
__global__ void __launch_bounds__(kThreads, 2)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ q_pos,
                          const int* __restrict__ kv_pos, T* __restrict__ o,
                          float* __restrict__ part, int* __restrict__ counters,
                          int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                          int window, float scale, int p_bf16, int heads) {
  __shared__ int kpos_s[kSplit];
  __shared__ float p_s[kWarps][kSplit];
  __shared__ float w_s[kWarps][32], lw_s[kWarps][32];  // the combine's
  __shared__ int last_s;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int b = blockIdx.z;
  const int G = Hq / Hkv, R = Sq * G;
  const int h0 = blockIdx.y * heads;
  const int rows = min(heads, Hkv - h0) * R;  // rows of this block
  const int k0 = split * kSplit;
  const int nk = max(0, min(kSplit, Sk - k0));
  // scratch: m and l [B Hkv R][nsplit], then acc [B Hkv R][nsplit][D]
  const long long nrows = static_cast<long long>(gridDim.z) * Hkv * R;
  float* part_m = part;
  float* part_l = part + nrows * nsplit;
  float* part_acc = part + 2 * nrows * nsplit;

  if (tid < kSplit)
    kpos_s[tid] =
        tid < nk ? kv_pos[static_cast<long long>(b) * Sk + k0 + tid] : -1;
  __syncthreads();

  // groups of kL lanes, a group on one key's row, a lane on 16 bytes a
  // piece (chunks sub + kL c, c < kP, of the row's C); 32 / kL keys a step
  constexpr int kN = 16 / sizeof(T), kGroups = 32 / kL;
  const int C = D / kN;
  const int sub = lane % kL, kg = lane / kL;
  bool has[kP];
#pragma unroll
  for (int c = 0; c < kP; ++c) has[c] = sub + kL * c < C;

  // a row loads a key's K only where it attends the slot, and V only for
  // the keys with p > 0: a row with no slot in this split reads no K or V
  // and writes empty statistics
  for (int rr = warp; rr < rows; rr += kWarps) {
    const int h = h0 + rr / R, r = rr % R;
    const int i = r / G, hq = h * G + r % G;
    const long long rowid = (static_cast<long long>(b) * Hkv + h) * R + r;
    const long long slot = rowid * nsplit + split;
    const int qp = q_pos[static_cast<long long>(b) * Sq + i];
    const T* qrow = q + ((static_cast<long long>(b) * Sq + i) * Hq + hq) * D;
    // key j of the split at kbase + j * stride, v likewise
    const long long stride = static_cast<long long>(Hkv) * D;
    const long long off0 = (static_cast<long long>(b) * Sk + k0) * stride +
                           static_cast<long long>(h) * D;
    const T* kbase = k + off0;
    const T* vbase = v + off0;
    float* acc_out = part_acc + slot * D;

    float qv[kP][kN];
#pragma unroll
    for (int c = 0; c < kP; ++c) {
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (has[c])
        raw = *reinterpret_cast<const uint4*>(qrow + (sub + kL * c) * kN);
      const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kN; ++e) qv[c][e] = to_f32(x[e]);
    }
#pragma unroll
    for (int j0 = 0; j0 < kSplit; j0 += kGroups) {
      const int j = j0 + kg;
      const bool ok =
          j < nk && flash::attends(kpos_s[j], qp, causal, window);
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < kP; ++c) {
        if (ok && has[c]) {
          const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
              kbase + j * stride + (sub + kL * c) * kN));
          const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < kN; ++e)
            dot = fmaf(qv[c][e], to_f32(x[e]), dot);
        }
      }
#pragma unroll
      for (int o = 1; o < kL; o <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (sub == 0) p_s[warp][j] = ok ? dot * scale : kNegInf;
    }
    __syncwarp();

    // the split's max and sum of the row; p replaces s in p_s
    const float s0 = p_s[warp][lane], s1 = p_s[warp][lane + 32];
    float mx = fmaxf(s0, s1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (mx <= kNegInf / 2) {  // no slot of this split for this row
      if (lane == 0) {
        part_m[slot] = kNegInf;
        part_l[slot] = 0.0f;
      }
      __syncwarp();
      continue;
    }
    const float p0 = s0 > kNegInf / 2 ? expf(s0 - mx) : 0.0f;
    const float p1 = s1 > kNegInf / 2 ? expf(s1 - mx) : 0.0f;
    float sum = p0 + p1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    p_s[warp][lane] = p_bf16 ? flash::round_bf16(p0) : p0;
    p_s[warp][lane + 32] = p_bf16 ? flash::round_bf16(p1) : p1;
    __syncwarp();

    // a lane sums p v over its group's keys for its 16 bytes of D, then
    // the groups' sums meet by a butterfly, in a fixed order
    float acc[kP][kN];
#pragma unroll
    for (int c = 0; c < kP; ++c)
#pragma unroll
      for (int e = 0; e < kN; ++e) acc[c][e] = 0.0f;
#pragma unroll
    for (int j0 = 0; j0 < kSplit; j0 += kGroups) {
      const int j = j0 + kg;
      const float p = p_s[warp][j];
#pragma unroll
      for (int c = 0; c < kP; ++c) {
        if (p != 0.0f && has[c]) {  // masked and j >= nk have p = 0
          const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
              vbase + j * stride + (sub + kL * c) * kN));
          const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < kN; ++e) {
            const float vx = to_f32(x[e]);
            acc[c][e] =
                fmaf(p, p_bf16 ? flash::round_bf16(vx) : vx, acc[c][e]);
          }
        }
      }
    }
#pragma unroll
    for (int o = kL; o < 32; o <<= 1)
#pragma unroll
      for (int c = 0; c < kP; ++c)
#pragma unroll
        for (int e = 0; e < kN; ++e)
          acc[c][e] += __shfl_xor_sync(0xffffffffu, acc[c][e], o);
    if (kg == 0) {
#pragma unroll
      for (int c = 0; c < kP; ++c)
        if (has[c]) {
#pragma unroll
          for (int e = 0; e < kN; ++e)
            acc_out[(sub + kL * c) * kN + e] = acc[c][e];
        }
    }
    if (lane == 0) {
      part_m[slot] = mx;
      part_l[slot] = sum;
    }
    __syncwarp();  // p_s is free for the warp's next row
  }

  // the last block of this (batch, head group) to arrive combines
  __threadfence();
  __syncthreads();
  int* counter = counters + static_cast<long long>(b) * gridDim.y + blockIdx.y;
  if (tid == 0) {
    const int prev = atomicAdd(counter, 1);
    last_s = prev == nsplit - 1;
    if (last_s) *counter = 0;  // every split has arrived: ready for reuse
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  // o = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30), M the
  // largest m_s, each sum in split-index order; splits with no slot (whose
  // acc was never written) left out.  A warp a row: its lanes read 32
  // splits' statistics at once, then sum over them in order, a lane on
  // each of D's columns
  for (int rr = warp; rr < rows; rr += kWarps) {
    const int h = h0 + rr / R, r = rr % R;
    const int i = r / G, hq = h * G + r % G;
    const long long rowid = (static_cast<long long>(b) * Hkv + h) * R + r;
    const float* pm = part_m + rowid * nsplit;
    const float* pl = part_l + rowid * nsplit;
    const float* pa = part_acc + rowid * nsplit * D;
    T* orow = o + ((static_cast<long long>(b) * Sq + i) * Hq + hq) * D;
    // the first 32 splits' m and l stay in the lanes' registers
    float m0 = kNegInf, l0 = 0.0f;
    if (lane < nsplit) {
      m0 = __ldcg(pm + lane);
      l0 = __ldcg(pl + lane);
    }
    float M = m0;
    for (int sp = lane + 32; sp < nsplit; sp += 32)
      M = fmaxf(M, __ldcg(pm + sp));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    if (M <= kNegInf / 2) {  // a fully masked row
      for (int d = lane; d < D; d += 32) store(orow + d, 0.0f);
      continue;
    }
    float L = 0.0f, acc[kMaxD / 32];
#pragma unroll
    for (int c = 0; c < kMaxD / 32; ++c) acc[c] = 0.0f;
    for (int s0 = 0; s0 < nsplit; s0 += 32) {
      const int sp = s0 + lane;
      float w = 0.0f, lw = 0.0f;
      if (sp < nsplit) {
        const float ms = s0 == 0 ? m0 : __ldcg(pm + sp);
        if (ms > kNegInf / 2) {
          w = expf(ms - M);
          lw = (s0 == 0 ? l0 : __ldcg(pl + sp)) * w;
        }
      }
      w_s[warp][lane] = w;
      lw_s[warp][lane] = lw;
      __syncwarp();
      const int n = min(32, nsplit - s0);
#pragma unroll 8
      for (int t = 0; t < n; ++t) {
        const float wt = w_s[warp][t];
        L += lw_s[warp][t];
        if (wt != 0.0f) {
          const float* at = pa + static_cast<long long>(s0 + t) * D;
#pragma unroll
          for (int c = 0; c < kMaxD / 32; ++c) {
            const int d = lane + 32 * c;
            if (d < D) acc[c] = fmaf(__ldcg(at + d), wt, acc[c]);
          }
        }
      }
      __syncwarp();
    }
    const float inv = 1.0f / fmaxf(L, 1e-30f);
#pragma unroll
    for (int c = 0; c < kMaxD / 32; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store(orow + d, acc[c] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* o, float* scratch,
                   int* counters, int B, int Sq, int Sk, int Hq, int Hkv,
                   int D, int causal, int window, float scale, int p_bf16,
                   cudaStream_t stream) {
  const int R = Sq * (Hq / Hkv);
  const int heads = R >= kWarps ? 1 : min(Hkv, kWarps / R);
  const int nsplit = Sk > 0 ? (Sk + kSplit - 1) / kSplit : 1;
  const dim3 grid(nsplit, (Hkv + heads - 1) / heads, B);
  // rows of 16-byte multiples from 16-byte aligned bases, or no launch
  if ((D * sizeof(T)) % 16 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return cudaErrorInvalidValue;
  const int chunks = static_cast<int>(D * sizeof(T) / 16);
  void (*kernel)(const T*, const T*, const T*, const int*, const int*, T*,
                 float*, int*, int, int, int, int, int, int, int, float, int,
                 int) = chunks <= 1    ? flash_decode_split_kernel<T, 1, 1>
                        : chunks <= 2  ? flash_decode_split_kernel<T, 2, 1>
                        : chunks <= 4  ? flash_decode_split_kernel<T, 4, 1>
                        : chunks <= 8  ? flash_decode_split_kernel<T, 8, 1>
                        : chunks <= 16 ? flash_decode_split_kernel<T, 16, 1>
                                       : flash_decode_split_kernel<T, 32, 1>;
  // two chunks a lane: float32 rows of 129 to 256 (a bf16 row of D <=
  // 256 has at most 32 chunks, so that instance is not built for bf16)
  if constexpr (sizeof(T) == 4)
    if (chunks > 32) kernel = flash_decode_split_kernel<T, 32, 2>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, static_cast<T*>(o), scratch,
      counters, Sq, Sk, Hq, Hkv, D, causal, window, scale, p_bf16, heads);
  return cudaGetLastError();
}

}  // namespace

cudaError_t flash_decode_split_launch(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* kv_pos, void* o, float* scratch, int* counters, int B, int Sq,
    int Sk, int Hq, int Hkv, int D, int causal, int window, float scale,
    int is_bf16, int p_bf16, cudaStream_t stream) {
  if (static_cast<long long>(Sq) * (Hq / Hkv) > 64 || D > kMaxD ||
      scratch == nullptr || counters == nullptr)
    return cudaErrorInvalidValue;
  return is_bf16
             ? launch<__nv_bfloat16>(q, k, v, q_pos, kv_pos, o, scratch,
                                     counters, B, Sq, Sk, Hq, Hkv, D, causal,
                                     window, scale, p_bf16, stream)
             : launch<float>(q, k, v, q_pos, kv_pos, o, scratch, counters, B,
                             Sq, Sk, Hq, Hkv, D, causal, window, scale, p_bf16,
                             stream);
}
