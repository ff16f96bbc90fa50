// Kernel A of flash attention: the bf16 prefill on Hopper's tensor cores
// (wgmma) with K and V tiles streamed by TMA, for sm_90a.
//   o (B, Sq, Hq, D) = softmax(mask(q k^T * scale)) v
//
// It replaces, for bf16 calls with more than 64 (query, head) rows a KV
// head and D % 8 == 0, the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py: flash_attention (:83,
//   its pallas_call at :121),
// and computes the function of the SIMT kernel (flash_attention.cu) and of
// the reference's models/attention.py: attend: GQA over explicit positions
// without repeating the KV heads, kv_pos = -1 on an unwritten slot,
// `causal`, `window` and `scale`, the online-softmax statistics in f32, a
// fully masked row exactly 0.
//
// What bounds it: at the served prefills (TinyLlama-1.1B GQA and Zamba2's
// MHA shared block, 4 x 512 x 32 heads of 64) the bytes of q, k, v and o,
// ~5.6-10 us at 3.35 TB/s; the causal products are ~4.3 GFLOP, ~4.4 us at
// the bf16 tensor-core rate.  The SIMT kernel spent ~0.52 ms in f32 FMAs
// on the CUDA cores.  This design moves the products to the tensor cores
// and the copies to TMA:
//   * a block holds 128 rows, the (query, head) pairs of one (batch, KV
//     head) query-major as the SIMT kernel's, in two consumer warpgroups
//     of 64; a K/V tile serves all G query heads of the group;
//   * q is loaded once, straight into the registers of wgmma's A operand;
//   * K and V tiles of 64 keys come through TMA into a ring of two stages
//     tracked by mbarriers.  The tensor maps address the (B, Sk, Hkv, D)
//     layout as it is, box (64 of D, 1 head, 64 keys, 1 batch), in the
//     128-byte swizzle; D is padded to 64, 128 or 256 by the box, whose
//     columns beyond D TMA fills with zeros, so D = 120 needs nothing
//     more.  TMA needs 16-byte strides, so D % 8 != 0 goes to the SIMT
//     kernel;
//   * D up to 256 (PaliGemma's heads), four 64-column panels: the output
//     columns split across two blocks.  Each block of a pair computes the
//     whole S = q K^T over all four panels (q's 16 A fragments, 64
//     registers) by the same instruction sequence, so both hold the same
//     m, l and P, and accumulates P V into its own two panels (64
//     registers, as at D = 128): four panels' accumulators and q's
//     fragments would pass 255 registers a thread.  A pair's blocks read
//     all of K and their half of V: 96 KB of shared memory for two stages.
//     The pair costs S twice, which a later redesign may spend once;
//   * S = q K^T is wgmma m64n64k16, A from registers, B the K tile
//     K-major; scale applies to S in f32; the element mask is the SIMT
//     kernel's;
//   * P stays in f32 as the reference's bf16 model keeps it: P = P_hi +
//     P_lo, two bf16 register fragments (the accumulator's layout is the A
//     operand's; P_hi is P's top 16 bits, P_lo the rest rounded to bf16),
//     two wgmmas against the V tile MN-major (the transposed B of 16-bit
//     types), ~16 bits of P for 1.5x the products.  With p_bf16 (the
//     reference's attend(p_dtype=bfloat16)) bf16(P) alone;
//   * tile skipping, exact and general: the block first finds the tiles
//     some row may attend (a written slot, <= its largest q position when
//     causal, > its least q position - window when windowed) and TMA
//     streams only those: the causal prefill reads about half the keys.
//     A tile that every row attends whole skips the element mask too;
//   * two blocks an SM at D <= 64: occupancy is what hides the latency of
//     this design's serial S -> softmax -> P V chain.  (Issuing the next
//     tile's S before this tile's softmax needs 32 more registers a
//     thread: at two blocks an SM ptxas then serializes the wgmmas, at one
//     the lost occupancy costs more than the overlap gains.)
// One __syncthreads a tile frees the stage just read for the load two
// tiles ahead.  Warp specialization, setmaxnreg, persistent blocks and
// clusters are later work.
//
// The tensor maps are encoded on the host in the launcher with
// cuTensorMapEncodeTiled, a driver function reached through the runtime's
// cudaGetDriverEntryPoint(ByVersion): the library links no libcuda.
#include "hopper.cuh"

#include <limits.h>

namespace {

using flash::kNegInf;

constexpr int kKeys = 64;             // keys a tile
constexpr int kWgRows = 64;           // rows a consumer warpgroup
constexpr int kRows = 2 * kWgRows;    // rows a block
constexpr int kThreads = 2 * 128;     // two warpgroups
constexpr int kPanelBytes = kKeys * 128;  // 64 keys x 64 bf16 of D

// A stage of the ring: the K tile's kPanels panels of D, then the V
// tile's kOut panels (the output columns of this block).
template <int kPanels, int kOut>
__host__ __device__ constexpr int stage_bytes() {
  return (kPanels + kOut) * kPanelBytes;
}

template <int kPanels, int kOut>
size_t smem_bytes(int ntiles) {
  return 1024                                   // alignment slack
         + 2 * stage_bytes<kPanels, kOut>()     // two stages of K and V
         + 2 * sizeof(uint64_t)                 // their mbarriers
         + sizeof(int) * static_cast<size_t>(ntiles);  // live tiles
}

// Tile `tile` of K and V (keys 64 tile ..) into stage `st` of the ring:
// one arrival on the stage's mbarrier announcing its bytes, then one TMA
// box of each panel of D for K, and of each of this block's kOut panels,
// from panel v0, for V.
template <int kPanels, int kOut>
__device__ __forceinline__ void issue(const CUtensorMap* mk,
                                      const CUtensorMap* mv,
                                      unsigned char* smem, uint64_t* full,
                                      int tile, int st, int hkv, int b,
                                      int v0) {
  unsigned char* kt = smem + st * stage_bytes<kPanels, kOut>();
  flash::mbar_arrive_expect_tx(&full[st], stage_bytes<kPanels, kOut>());
#pragma unroll
  for (int pnl = 0; pnl < kPanels; ++pnl)
    flash::tma_load_4d(kt + pnl * kPanelBytes, mk, &full[st], 64 * pnl, hkv,
                       tile * kKeys, b);
#pragma unroll
  for (int pnl = 0; pnl < kOut; ++pnl)
    flash::tma_load_4d(kt + (kPanels + pnl) * kPanelBytes, mv, &full[st],
                       64 * (v0 + pnl), hkv, tile * kKeys, b);
}

// kPanels: the 64-column panels of D in S = q K^T; kOut: the panels of the
// output (and of V) a block accumulates, kPanels or, at four panels, two,
// with kPanels / kOut blocks a row block.  Two blocks an SM at D <= 64 (at
// most 128 registers a thread), one above; kPbf16 (one bf16 pass of P) is
// a template argument, so that no branch sits between two wgmmas
template <int kPanels, int kOut, bool kPbf16>
__global__ void __launch_bounds__(kThreads, kPanels == 1 ? 2 : 1)
flash_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_k,
                           const __grid_constant__ CUtensorMap tmap_v,
                           const __nv_bfloat16* __restrict__ q,
                           const int* __restrict__ q_pos,
                           const int* __restrict__ kv_pos,
                           __nv_bfloat16* __restrict__ o, int Sq, int Sk,
                           int Hq, int Hkv, int D, int causal, int window,
                           float scale) {
  constexpr int kStage = stage_bytes<kPanels, kOut>();
  constexpr int kSplitD = kPanels / kOut;  // blocks a row block
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // stage s: K at smem + s kStage, V right after its kPanels panels
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * kStage);
  int* tiles = reinterpret_cast<int*>(full + 2);
  __shared__ int q_lo, q_hi, n_live;

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int hkv = blockIdx.y;
  const int G = Hq / Hkv;
  const int R = Sq * G;  // rows of this (batch, KV head)
  const int row0 = (blockIdx.x / kSplitD) * kRows;
  const int v0 = (blockIdx.x % kSplitD) * kOut;  // this block's panels
  const int rows = min(kRows, R - row0);
  const int ntiles = (Sk + kKeys - 1) / kKeys;
  const int warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    q_lo = INT_MAX;
    q_hi = INT_MIN;
    flash::mbar_init(&full[0], 1);
    flash::mbar_init(&full[1], 1);
    flash::mbar_fence_init();
  }
  __syncthreads();
  // the least and largest query position of the block's rows
  {
    const int i0 = row0 / G, i1 = (row0 + rows - 1) / G;
    int lo = INT_MAX, hi = INT_MIN;
    for (int i = i0 + tid; i <= i1; i += kThreads) {
      const int p = q_pos[static_cast<long long>(b) * Sq + i];
      lo = min(lo, p);
      hi = max(hi, p);
    }
    if (lo <= hi) {
      atomicMin(&q_lo, lo);
      atomicMax(&q_hi, hi);
    }
  }
  __syncthreads();
  // the tiles some row may attend (a superset test, exact to skip), and
  // which of them every row attends whole (every slot written, none after
  // the least query when causal, all inside the window of the largest):
  // those need no element mask.  Then the live ones in order as 2 t +
  // whole, compacted in place by warp 0
  {
    const int lo = q_lo, hi = q_hi;
    for (int t = warp; t < ntiles; t += kThreads / 32) {
      bool live = false, whole = true;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = t * kKeys + lane + 32 * h;
        const int p =
            j < Sk ? kv_pos[static_cast<long long>(b) * Sk + j] : -1;
        live |= p >= 0 && (!causal || p <= hi) &&
                (window <= 0 || lo - p < window);
        whole &= p >= 0 && (!causal || p <= lo) &&
                 (window <= 0 || hi - p < window);
      }
      live = __any_sync(0xffffffffu, live);
      whole = __all_sync(0xffffffffu, whole);
      if (lane == 0) tiles[t] = live | (whole << 1);
    }
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int t0 = 0; t0 < ntiles; t0 += 32) {
      const int t = t0 + lane;
      const int code = t < ntiles ? tiles[t] : 0;
      const bool f = code & 1;
      const unsigned ballot = __ballot_sync(0xffffffffu, f);
      __syncwarp();
      if (f) tiles[n + __popc(ballot & ((1u << lane) - 1u))] =
          2 * t + (code >> 1);
      n += __popc(ballot);
      __syncwarp();
    }
    if (lane == 0) n_live = n;
  }
  __syncthreads();
  const int nl = n_live;

  if (tid == 0) {
    for (int it = 0; it < min(2, nl); ++it)
      issue<kPanels, kOut>(&tmap_k, &tmap_v, smem, full, tiles[it] >> 1,
                           it & 1, hkv, b, v0);
  }

  // this thread's two rows, ra and ra + 8, of its warpgroup's 64
  const int wg = tid / 128, wl = tid % 128;
  const int g4 = lane / 4, t4 = lane % 4;
  const int ra = row0 + wg * kWgRows + (wl / 32) * 16 + g4;
  int qp[2];
  uint32_t qf[4 * kPanels][4];  // q as A fragments, one per 16 of D
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    const bool ok = r < R;
    const int i = ok ? r / G : 0, gq = ok ? r % G : 0;
    qp[h] = ok ? q_pos[static_cast<long long>(b) * Sq + i] : 0;
    const __nv_bfloat16* qrow =
        q + ((static_cast<long long>(b) * Sq + i) * Hq + hkv * G + gq) * D;
#pragma unroll
    for (int kk = 0; kk < 4 * kPanels; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = 16 * kk + 2 * t4 + 8 * half;  // even; D % 8 == 0
        qf[kk][h + 2 * half] =
            ok && c < D ? *reinterpret_cast<const uint32_t*>(qrow + c) : 0u;
      }
    }
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[kOut][32];
#pragma unroll
  for (int pnl = 0; pnl < kOut; ++pnl)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[pnl][e] = 0.0f;
  const int* kvp = kv_pos + static_cast<long long>(b) * Sk;

  for (int it = 0; it < nl; ++it) {
    const int st = it & 1;
    const unsigned char* kt = smem + st * kStage;
    const unsigned char* vt = kt + kPanels * kPanelBytes;
    const int code = tiles[it];
    const int k0 = (code >> 1) * kKeys;
    flash::mbar_wait(&full[st], (it >> 1) & 1);

    // S = q K^T: K-major B, 16 of D a step, 32 bytes along the swizzled row
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.0f;
    flash::wgmma_fence();
    // every step of the padded D: q's registers and K's box are zero past
    // D, so the steps beyond it add 0, and the sequence has no branch
    // (a branch between wgmmas would make ptxas serialize them)
#pragma unroll
    for (int kk = 0; kk < 4 * kPanels; ++kk) {
      flash::wgmma_m64n64k16<0>(
          s, qf[kk],
          flash::smem_desc(kt + (kk / 4) * kPanelBytes + (kk % 4) * 32, 16,
                           1024),
          kk > 0);
    }
    flash::wgmma_commit();
    flash::wgmma_wait_all();
    flash::fence_regs(s);

    // scale, mask (only a tile that some row does not attend whole), and
    // the online-softmax update of the two rows
    float mx[2] = {kNegInf, kNegInf};
    if (code & 1) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        s[e] *= scale;
        mx[(e / 2) % 2] = fmaxf(mx[(e / 2) % 2], s[e]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + 8 * j + 2 * t4 + e;
          const int kp = kj < Sk ? kvp[kj] : -1;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& x = s[4 * j + 2 * h + e];
            x = flash::attends(kp, qp[h], causal, window) ? x * scale
                                                          : kNegInf;
            mx[h] = fmaxf(mx[h], x);
          }
        }
      }
    }
    float corr[2], m_safe[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      m_safe[h] = m_new <= kNegInf / 2 ? 0.0f : m_new;
      corr[h] = m[h] <= kNegInf / 2 ? 0.0f : expf(m[h] - m_safe[h]);
      m[h] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * h + e];
          x = x > kNegInf / 2 ? expf(x - m_safe[h]) : 0.0f;
          sum[h] += x;
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * corr[h] + sum[h];
    }
#pragma unroll
    for (int pnl = 0; pnl < kOut; ++pnl)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[pnl][4 * j + e] *= corr[e / 2];

    // P as A fragments, 16 keys each.  Two passes: P_hi = P cut to its top
    // 16 bits (a bf16, by a byte permute, no conversion), P_lo =
    // bf16(P - P_hi), exact to ~2^-16 of P.  One pass (p_bf16): bf16(P),
    // rounded to nearest as the reference's astype
    uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = s[8 * kc + 2 * r], x1 = s[8 * kc + 2 * r + 1];
        if (kPbf16) {
          p_hi[kc][r] = flash::pack_bf16(x0, x1);
        } else {
          const uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
          p_hi[kc][r] = __byte_perm(u0, u1, 0x7632);
          p_lo[kc][r] =
              flash::pack_bf16(x0 - __uint_as_float(u0 & 0xFFFF0000u),
                               x1 - __uint_as_float(u1 & 0xFFFF0000u));
        }
      }
    }

    // acc += P V: V MN-major, 16 keys (two 1024-byte atoms) a step
#pragma unroll
    for (int pnl = 0; pnl < kOut; ++pnl) flash::fence_regs(acc[pnl]);
    flash::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int pnl = 0; pnl < kOut; ++pnl) {
        const uint64_t dv = flash::smem_desc(
            vt + pnl * kPanelBytes + kc * 2048, kPanelBytes, 1024);
        flash::wgmma_m64n64k16<1>(acc[pnl], p_hi[kc], dv, 1);
        if (!kPbf16) flash::wgmma_m64n64k16<1>(acc[pnl], p_lo[kc], dv, 1);
      }
    }
    flash::wgmma_commit();
    flash::wgmma_wait_all();
#pragma unroll
    for (int pnl = 0; pnl < kOut; ++pnl) flash::fence_regs(acc[pnl]);

    __syncthreads();  // both warpgroups are done with this stage
    if (tid == 0 && it + 2 < nl)
      issue<kPanels, kOut>(&tmap_k, &tmap_v, smem, full, tiles[it + 2] >> 1,
                           st, hkv, b, v0);
  }

  // o = acc / max(l, 1e-30), two bf16 a store
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    if (r >= R) continue;
    const int i = r / G, gq = r % G;
    __nv_bfloat16* orow =
        o + ((static_cast<long long>(b) * Sq + i) * Hq + hkv * G + gq) * D;
    const float inv = 1.0f / fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int pnl = 0; pnl < kOut; ++pnl)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * (v0 + pnl) + 8 * j + 2 * t4;
        if (c < D)
          *reinterpret_cast<uint32_t*>(orow + c) =
              flash::pack_bf16(acc[pnl][4 * j + 2 * h] * inv,
                               acc[pnl][4 * j + 2 * h + 1] * inv);
      }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of k or v (B, Sk, Hkv, D) bf16 as dims (D, Hkv, Sk, B), boxes of
// (64, 1, 64, 1) in the 128-byte swizzle, zeros beyond every edge.
bool encode_kv_map(CUtensorMap* map, const void* base, int B, int Sk, int Hkv,
                   int D) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(Sk > 0 ? Sk : 1),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {D * e, static_cast<cuuint64_t>(Hkv) * D * e,
                                 static_cast<cuuint64_t>(Sk > 0 ? Sk : 1) *
                                     Hkv * D * e};
  const cuuint32_t box[4] = {64, 1, kKeys, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kPanels, int kOut, bool kPbf16>
cudaError_t launch(const CUtensorMap& mk, const CUtensorMap& mv,
                   const void* q, const int* q_pos, const int* kv_pos, void* o,
                   int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                   int window, float scale, cudaStream_t stream) {
  const int ntiles = (Sk + kKeys - 1) / kKeys;
  const size_t smem = smem_bytes<kPanels, kOut>(ntiles);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_wgmma_kernel<kPanels, kOut, kPbf16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long R = static_cast<long long>(Sq) * (Hq / Hkv);
  const long long blocks = (R + kRows - 1) / kRows * (kPanels / kOut);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), Hkv, B);
  flash_prefill_wgmma_kernel<kPanels, kOut, kPbf16>
      <<<grid, kThreads, smem, stream>>>(
          mk, mv, static_cast<const __nv_bfloat16*>(q), q_pos, kv_pos,
          static_cast<__nv_bfloat16*>(o), Sq, Sk, Hq, Hkv, D, causal, window,
          scale);
  return cudaGetLastError();
}

template <int kPanels, int kOut>
cudaError_t launch_p(const CUtensorMap& mk, const CUtensorMap& mv,
                     const void* q, const int* q_pos, const int* kv_pos,
                     void* o, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                     int causal, int window, float scale, int p_bf16,
                     cudaStream_t stream) {
  return p_bf16 ? launch<kPanels, kOut, true>(mk, mv, q, q_pos, kv_pos, o, B,
                                              Sq, Sk, Hq, Hkv, D, causal,
                                              window, scale, stream)
                : launch<kPanels, kOut, false>(mk, mv, q, q_pos, kv_pos, o,
                                               B, Sq, Sk, Hq, Hkv, D, causal,
                                               window, scale, stream);
}

}  // namespace

cudaError_t flash_prefill_wgmma_launch(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* kv_pos, void* o, int B, int Sq, int Sk, int Hq, int Hkv, int D,
    int causal, int window, float scale, int p_bf16, cudaStream_t stream) {
  if (D % 8 != 0 || D > 256 || (reinterpret_cast<uintptr_t>(k) % 16) ||
      (reinterpret_cast<uintptr_t>(v) % 16) ||
      (reinterpret_cast<uintptr_t>(q) % 4) ||
      (reinterpret_cast<uintptr_t>(o) % 4))
    return cudaErrorInvalidValue;
  CUtensorMap mk, mv;
  if (!encode_kv_map(&mk, k, B, Sk, Hkv, D) ||
      !encode_kv_map(&mv, v, B, Sk, Hkv, D))
    return cudaErrorInvalidValue;
  if (D <= 64)
    return launch_p<1, 1>(mk, mv, q, q_pos, kv_pos, o, B, Sq, Sk, Hq, Hkv, D,
                          causal, window, scale, p_bf16, stream);
  if (D <= 128)
    return launch_p<2, 2>(mk, mv, q, q_pos, kv_pos, o, B, Sq, Sk, Hq, Hkv, D,
                          causal, window, scale, p_bf16, stream);
  return launch_p<4, 2>(mk, mv, q, q_pos, kv_pos, o, B, Sq, Sk, Hq, Hkv, D,
                        causal, window, scale, p_bf16, stream);
}
