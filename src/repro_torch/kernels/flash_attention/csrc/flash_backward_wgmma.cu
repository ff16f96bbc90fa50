// Backward of grouped-query flash attention over explicit positions on
// Hopper's tensor cores (wgmma), fed by TMA, for bf16 and sm_90a: given q,
// k, v, the forward's output o and its gradient dO, the gradients
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O)
//   dQ = scale dS K,  dK = scale dS^T Q
// with P = softmax(mask(q k^T * scale)) recomputed here.
//
// It replaces no Pallas kernel: the reference's Pallas flash attention
//   src/repro/kernels/flash_attention/kernel.py: flash_attention (:83)
// has no backward, and the reference trains through XLA's autodiff of
// src/repro/models/attention.py: attend.  It is the bf16 route of the
// port's backward of kernel #6, the counterpart of flash_prefill.cu's
// forward; float32 calls and rows that are not 16-byte multiples take the
// SIMT pair of flash_backward.cu.  Both routes compute one function:
// kernel.py's bwd_kernel_for picks the route.
//
// What bounds it: at TinyLlama-1.1B's training shape (B 4, S 512, 32:4
// heads, D 64, causal) the bytes of q, k, v, o, dO and the three gradients,
// ~0.011 ms at 3.35 TB/s, and about as long for the five products at the
// bf16 tensor-core rate.  The SIMT pair ran every product as an f32 FMA
// from shared memory (2.3 ms there).  This design:
//   * every product on wgmma m64n64k16 with f32 accumulators: S = q K^T
//     and dP = dO V^T (and their transposes) with both operands in shared
//     memory; dQ += dS K, dV += P^T dO and dK += dS^T q with P and dS as
//     register A fragments (the accumulator's layout is the A operand's),
//     so neither goes through shared memory.  q, dO, K and V are A
//     operands from shared memory, not registers: the registers go to the
//     accumulators (at D = 256 q's and dO's fragments alone would take 128
//     a thread);
//   * P and dS stay f32 as the float32 closed form keeps them: each is fed
//     to its product as hi + lo, two bf16 fragments (hi = the top 16 bits,
//     lo = bf16(x - hi)), ~16 bits of the value for twice those products;
//     one bf16 rounding of P or dS would miss the bf16 gate the route is
//     held to (ref.flash_attend_bwd_tc_ref is this arithmetic in PyTorch);
//   * K, V, q and dO tiles arrive by TMA in the 128-byte swizzle, 64
//     columns of D a panel (D = 120 padded to 128 by the box's zero fill).
//     One q or dO tile serves two products through two descriptors:
//     K-major as the B of S^T = K q^T (dP^T = V dO^T), MN-major (the
//     transposed B of 16-bit types) as the B of dK += dS^T q (dV += P^T dO);
//     K likewise in bwd_dq;
//   * the forward saves nothing, so the scores are computed three times:
//     bwd_dq's first pass gives each row's m and l, hence lse, its second
//     pass P and dQ, and bwd_dkdv recomputes S^T (a forward that saves lse
//     would spare the first);
//   * exact tile skipping, as the forward's: a tile of keys (bwd_dq) or of
//     rows (bwd_dkdv) that no pair can attend is never loaded, found from
//     the positions by a superset test; a tile every pair attends skips
//     the element mask;
//   * each tile is a serial chain (TMA, the S and dP products, the softmax
//     on the CUDA cores, the products into the accumulators), which other
//     blocks on the SM hide: at D <= 64 two bwd_dq blocks an SM (at most
//     128 registers a thread) and three bwd_dkdv blocks (at most 168),
//     one each above.  The exponentials are exp2f of an fma, with the
//     scores scaled by scale log2 e and lse kept in base 2: a few
//     instructions fewer than expf's range reduction each (15% of the
//     pair's time at TinyLlama's shape).
//
// bwd_dq: a block holds 128 (query, head) rows of one (batch, KV head) in
// the forward's query-major row order (row i G + g is query i, head hkv G +
// g), two consumer warpgroups of 64, as prefill_wgmma; 64 rows and one
// warpgroup at D = 256, where q, dO and two stages of K and V take 192 KB.
// q and dO are copied into shared memory in the prologue, where delta =
// rowsum(dO * O) is summed in a fixed order.  K (first pass) and K with V
// (second pass) stream through a two-stage TMA ring.  It writes dq, and
// each row's (lse, delta) to the statistics scratch for bwd_dkdv.
//
// bwd_dkdv: a block holds 64 keys of one (batch, KV head), one warpgroup;
// K and V are loaded once.  The group's Sq G rows are cut into row tiles
// of gb heads x qt queries, at most 64 rows (kernel.bwd_tiling picks gb
// and qt and passes them in), which one 5-d TMA box reads from the (B, Sq,
// Hq, D) layout as it is; the statistics scratch is laid out by row tile,
// 64 (lse, delta) slots each, so a bulk copy brings a tile's with its q
// and dO.  A slot that holds no row (a tile of fewer than 64 rows, past
// Sq or past G) is never written, and P and dS are 0 there whatever it
// holds.  The tiles some row attends are split into
// `runs` runs of equal count (kernel.bwd_tiling picks runs from the shape,
// so that the grid fills two waves of 132 SMs; under a causal mask each
// key tile splits its own live range); each run is a block.  With one run
// the block writes dk and dv; with more each writes its f32 partial dK and
// dV to scratch, and the last block of a key tile to arrive, elected by an
// arrival counter (an atomicAdd after a __threadfence, reset to 0 by the
// last, as flash_decode.cu's split combine), sums them in run order.  No
// atomics touch data: reruns are bit-identical.
//
// D above 128 (PaliGemma's 256, four panels): a thread cannot hold the
// accumulators of all four panels beside S and dP, so the output columns
// split across a pair of blocks, as prefill_wgmma's.  Each block of a pair
// computes the whole S and dP (bwd_dq: both passes; bwd_dkdv: S^T and
// dP^T) by the same instruction sequence and accumulates its two panels
// of dQ, or of dK and dV: the pair repeats those two products and the
// loads of q, dO, K and V.
//
// Layouts are the forward's, row-major and contiguous, bf16:
//   q, o, dO, dq  (B, Sq, Hq, D);  k, v, dk, dv  (B, Sk, Hkv, D)
//   q_pos (B, Sq), kv_pos (B, Sk)  int32, -1 marks an unwritten slot
//   stats  (B, Hkv, row tiles, 64) pairs of f32 (lse / ln 2, delta)
// A row that attends no slot has zero gradient (its P is 0 by the mask).
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
// reached through the runtime's cudaGetDriverEntryPoint(ByVersion).
#include "hopper.cuh"

#include <limits.h>

namespace {

using flash::attends;
using flash::kNegInf;

constexpr int kKeys = 64;                 // keys a K/V tile, a dkdv block
constexpr int kTileRows = 64;             // rows of a dkdv row tile, padded
constexpr int kPanelBytes = 64 * 128;     // 64 rows x 64 bf16 of D
constexpr float kLog2e = 1.4426950408889634f;

// wgmma descriptors of a tile of 64-column panels in the 128-byte swizzle
// whose panels are `panel_bytes` apart.  K-major: step kk (16 of D, 32
// bytes along the swizzled row) of the 64 rows at `tile`.  MN-major: the
// 16 rows from row 16 kc of panel pnl (two 1024-byte atoms a step).
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile, int kk,
                                           int panel_bytes) {
  return flash::smem_desc(tile + (kk / 4) * panel_bytes + (kk % 4) * 32, 16,
                          1024);
}
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* tile, int pnl,
                                            int kc) {
  return flash::smem_desc(tile + pnl * kPanelBytes + kc * 2048, kPanelBytes,
                          1024);
}

// x (f32) as two bf16 A-fragment halves, for the pair (x0, x1): hi = the top
// 16 bits (a byte permute, no conversion), lo = bf16(x - hi), nearest
__device__ __forceinline__ void hi_lo(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
  hi = __byte_perm(u0, u1, 0x7632);
  lo = flash::pack_bf16(x0 - __uint_as_float(u0 & 0xFFFF0000u),
                        x1 - __uint_as_float(u1 & 0xFFFF0000u));
}

// The accumulator x[32] (64 rows x 64 columns) as the A fragments of a
// product over its columns, 16 a step: hi[kc], lo[kc]
__device__ __forceinline__ void to_frags(const float (&x)[32],
                                         uint32_t (&hi)[4][4],
                                         uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      hi_lo(x[8 * kc + 2 * r], x[8 * kc + 2 * r + 1], hi[kc][r], lo[kc][r]);
}

// Row tile geometry of bwd_dkdv (kernel.bwd_tiling): gb heads x qt queries,
// head_tiles = ceil(G / gb) tiles across the heads of one query run.
struct RowTiles {
  int G, gb, qt, head_tiles;
  // row tile of group row r, and r's slot (0..63) in it
  __device__ __forceinline__ void slot(int r, int& t, int& n) const {
    const int i = r / G, g = r % G;
    t = (i / qt) * head_tiles + g / gb;
    n = (i % qt) * gb + g % gb;
  }
};

// ---- bwd_dq ----------------------------------------------------------------

template <int kPanels, int kWgs>
struct DqLayout {
  static constexpr int kRows = 64 * kWgs;                    // rows a block
  static constexpr int kChunks = 8 * kPanels;                // 16 B a row
  static constexpr int kRowPanel = kRows * 128;              // a q panel
  static constexpr int kQBytes = kPanels * kRowPanel;        // q (or dO)
  static constexpr int kStage = 2 * kPanels * kPanelBytes;   // K then V
  static constexpr int kRing = 2 * kQBytes;                  // after q, dO
  static constexpr int kBars = kRing + 2 * kStage;
  static constexpr int kPart = kBars + 2 * 8;                // delta parts
  static constexpr int kTiles = kPart + 4 * kRows * kChunks;
  static size_t bytes(int ntiles) {
    return 1024 + kTiles + sizeof(int) * static_cast<size_t>(ntiles);
  }
};

// Item `it` of bwd_dq's ring into stage it & 1: the first nl items are the
// first pass's K tiles, the next nl the second pass's K and V tiles.
template <int kPanels>
__device__ __forceinline__ void dq_fetch(const CUtensorMap* mk,
                                         const CUtensorMap* mv,
                                         unsigned char* ring, uint64_t* full,
                                         const int* tiles, int nl, int it,
                                         int hkv, int b) {
  constexpr int kStage = 2 * kPanels * kPanelBytes;
  const int st = it & 1;
  const bool with_v = it >= nl;
  const int k0 = (tiles[with_v ? it - nl : it] >> 1) * kKeys;
  unsigned char* kt = ring + st * kStage;
  flash::mbar_arrive_expect_tx(&full[st],
                               (with_v ? 2 : 1) * kPanels * kPanelBytes);
#pragma unroll
  for (int pnl = 0; pnl < kPanels; ++pnl)
    flash::tma_load_4d(kt + pnl * kPanelBytes, mk, &full[st], 64 * pnl, hkv,
                       k0, b);
  if (with_v) {
#pragma unroll
    for (int pnl = 0; pnl < kPanels; ++pnl)
      flash::tma_load_4d(kt + (kPanels + pnl) * kPanelBytes, mv, &full[st],
                         64 * pnl, hkv, k0, b);
  }
}

// kPanels: the 64-column panels of D; kOut: the panels of dQ a block
// accumulates (kPanels, or two of four, kPanels / kOut blocks a row
// block); kWgs: consumer warpgroups (64 rows each).
template <int kPanels, int kOut, int kWgs>
__global__ void __launch_bounds__(kWgs * 128, kPanels == 1 ? 2 : 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_k,
                          const __grid_constant__ CUtensorMap tmap_v,
                          const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout,
                          const int* __restrict__ q_pos,
                          const int* __restrict__ kv_pos,
                          __nv_bfloat16* __restrict__ dq,
                          float2* __restrict__ stats, int Sq, int Sk, int Hq,
                          int Hkv, int D, int causal, int window, float scale,
                          RowTiles rt, int n_row_tiles) {
  using L = DqLayout<kPanels, kWgs>;
  constexpr int kThreads = kWgs * 128;
  constexpr int kSplitD = kPanels / kOut;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;                  // [kPanels][kRows][128 B]
  unsigned char* dos = smem + L::kQBytes;    // the same for dO
  unsigned char* ring = smem + L::kRing;     // 2 stages of K, V
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  float* part = reinterpret_cast<float*>(smem + L::kPart);  // [kRows][kChunks]
  int* tiles = reinterpret_cast<int*>(smem + L::kTiles);
  __shared__ int q_lo, q_hi, n_live;

  const int tid = threadIdx.x;
  const int b = blockIdx.z, hkv = blockIdx.y;
  const int G = Hq / Hkv;
  const int R = Sq * G;
  const int row0 = (blockIdx.x / kSplitD) * L::kRows;
  const int v0 = (blockIdx.x % kSplitD) * kOut;  // this block's dQ panels
  const int rows = min(L::kRows, R - row0);
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
  // the key tiles some row may attend, and those every row attends whole,
  // as 2 t + whole in order (the forward's test, flash_prefill.cu)
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
  if (tid == 0)
    for (int it = 0; it < min(2, 2 * nl); ++it)
      dq_fetch<kPanels>(&tmap_k, &tmap_v, ring, full, tiles, nl, it, hkv, b);

  // q and dO of the block's rows into shared memory in the 128-byte swizzle
  // (16-byte chunk c of row r at chunk c ^ (r % 8) of its 128-byte row),
  // zeros past D and past the group's rows; and dO * O summed over each
  // chunk's 8 columns
  for (int idx = tid; idx < L::kRows * L::kChunks; idx += kThreads) {
    const int row = idx / L::kChunks, c = idx % L::kChunks;
    const int r = row0 + row;
    uint4 qv = make_uint4(0u, 0u, 0u, 0u), dv = qv;
    float sum = 0.0f;
    if (r < R && 8 * c < D) {
      const long long off =
          ((static_cast<long long>(b) * Sq + r / G) * Hq + hkv * G + r % G) *
              D + 8 * c;
      qv = *reinterpret_cast<const uint4*>(q + off);
      dv = *reinterpret_cast<const uint4*>(dout + off);
      const uint4 ov = *reinterpret_cast<const uint4*>(o + off);
      const __nv_bfloat16* d8 = reinterpret_cast<const __nv_bfloat16*>(&dv);
      const __nv_bfloat16* o8 = reinterpret_cast<const __nv_bfloat16*>(&ov);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        sum = fmaf(__bfloat162float(d8[e]), __bfloat162float(o8[e]), sum);
    }
    const int at = (c / 8) * L::kRowPanel + row * 128 +
                   (((c % 8) ^ (row % 8)) * 16);
    *reinterpret_cast<uint4*>(qs + at) = qv;
    *reinterpret_cast<uint4*>(dos + at) = dv;
    part[row * L::kChunks + c] = sum;
  }
  flash::fence_proxy_async();
  __syncthreads();

  // this thread's two rows, ra and ra + 8, of its warpgroup's 64
  const int wg = tid / 128, wl = tid % 128;
  const int g4 = lane / 4, t4 = lane % 4;
  const int la = wg * 64 + (wl / 32) * 16 + g4;  // row in the block
  const int ra = row0 + la;
  int qp[2];
  float delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    qp[h] = r < R ? q_pos[static_cast<long long>(b) * Sq + r / G] : 0;
    float sum = 0.0f;  // the chunks in order
    for (int c = 0; c < L::kChunks; ++c)
      sum += part[(la + 8 * h) * L::kChunks + c];
    delta[h] = sum;
  }
  const unsigned char* qa = qs + wg * 64 * 128;   // this warpgroup's rows
  const unsigned char* doa = dos + wg * 64 * 128;
  const int* kvp = kv_pos + static_cast<long long>(b) * Sk;

  // first pass: each row's max m and sum l of 2^(s - m), online, in base 2
  // (s scaled by scale log2 e; exp2f is one instruction after the scale's
  // fma)
  const float scale2 = scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  for (int it = 0; it < nl; ++it) {
    const int st = it & 1;
    const unsigned char* kt = ring + st * L::kStage;
    const int code = tiles[it];
    const int k0 = (code >> 1) * kKeys;
    flash::mbar_wait(&full[st], (it >> 1) & 1);
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.0f;
    flash::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * kPanels; ++kk)
      flash::wgmma_m64n64k16_ss(s, kmajor(qa, kk, L::kRowPanel),
                                kmajor(kt, kk, kPanelBytes), kk > 0);
    flash::wgmma_commit();
    flash::wgmma_wait_all();
    flash::fence_regs(s);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * j + 2 * t4 + e;
        const int kp = (code & 1) ? 0 : (kj < Sk ? kvp[kj] : -1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& x = s[4 * j + 2 * h + e];
          x = (code & 1) || attends(kp, qp[h], causal, window) ? x * scale2
                                                               : kNegInf;
          mx[h] = fmaxf(mx[h], x);
        }
      }
    float sum[2] = {0.0f, 0.0f}, m_safe[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      m_safe[h] = m_new <= kNegInf / 2 ? 0.0f : m_new;
      const float corr =
          m[h] <= kNegInf / 2 ? 0.0f : exp2f(m[h] - m_safe[h]);
      l[h] *= corr;
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[4 * j + 2 * h + e];
          sum[h] += x > kNegInf / 2 ? exp2f(x - m_safe[h]) : 0.0f;
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] += sum[h];
    }
    __syncthreads();  // both warpgroups are done with this stage
    if (tid == 0 && it + 2 < 2 * nl)
      dq_fetch<kPanels>(&tmap_k, &tmap_v, ring, full, tiles, nl, it + 2, hkv,
                        b);
  }
  // lse in base 2, lse / ln 2 (0 for a row that attends no slot: its p is
  // 0 by the mask), and the row's (lse, delta) to the statistics scratch,
  // once a pair of blocks
  float lse[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse[h] = m[h] > kNegInf / 2 ? m[h] + log2f(l[h]) : 0.0f;
    const int r = ra + 8 * h;
    if (r < R && t4 == 0 && v0 == 0) {
      int t, n;
      rt.slot(r, t, n);
      stats[((static_cast<long long>(b) * Hkv + hkv) * n_row_tiles + t) *
                kTileRows + n] = make_float2(lse[h], delta[h]);
    }
  }

  // second pass: S and dP, then P = exp(s scale - lse) = 2^(s scale log2 e
  // - lse / ln 2), dS = P (dP - delta), dQ += dS K with dS as hi + lo
  // fragments
  float acc[kOut][32];
#pragma unroll
  for (int pnl = 0; pnl < kOut; ++pnl)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[pnl][e] = 0.0f;
  for (int it = nl; it < 2 * nl; ++it) {
    const int st = it & 1;
    const unsigned char* kt = ring + st * L::kStage;
    const unsigned char* vt = kt + kPanels * kPanelBytes;
    const int code = tiles[it - nl];
    const int k0 = (code >> 1) * kKeys;
    flash::mbar_wait(&full[st], (it >> 1) & 1);
    float s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.0f;
    flash::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * kPanels; ++kk)
      flash::wgmma_m64n64k16_ss(s, kmajor(qa, kk, L::kRowPanel),
                                kmajor(kt, kk, kPanelBytes), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4 * kPanels; ++kk)
      flash::wgmma_m64n64k16_ss(dp, kmajor(doa, kk, L::kRowPanel),
                                kmajor(vt, kk, kPanelBytes), kk > 0);
    flash::wgmma_commit();
    flash::wgmma_wait_all();
    flash::fence_regs(s);
    flash::fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * j + 2 * t4 + e;
        const int kp = (code & 1) ? 0 : (kj < Sk ? kvp[kj] : -1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = 4 * j + 2 * h + e;
          const float p = (code & 1) || attends(kp, qp[h], causal, window)
                              ? exp2f(fmaf(s[at], scale2, -lse[h]))
                              : 0.0f;
          s[at] = p * (dp[at] - delta[h]);  // dS
        }
      }
    uint32_t ds_hi[4][4], ds_lo[4][4];
    to_frags(s, ds_hi, ds_lo);
#pragma unroll
    for (int pnl = 0; pnl < kOut; ++pnl) flash::fence_regs(acc[pnl]);
    flash::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int pnl = 0; pnl < kOut; ++pnl) {
        const uint64_t dk = mnmajor(kt, v0 + pnl, kc);
        flash::wgmma_m64n64k16<1>(acc[pnl], ds_hi[kc], dk, 1);
        flash::wgmma_m64n64k16<1>(acc[pnl], ds_lo[kc], dk, 1);
      }
    flash::wgmma_commit();
    flash::wgmma_wait_all();
#pragma unroll
    for (int pnl = 0; pnl < kOut; ++pnl) flash::fence_regs(acc[pnl]);
    __syncthreads();
    if (tid == 0 && it + 2 < 2 * nl)
      dq_fetch<kPanels>(&tmap_k, &tmap_v, ring, full, tiles, nl, it + 2, hkv,
                        b);
  }

  // dq = scale acc, two bf16 a store
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    if (r >= R) continue;
    __nv_bfloat16* row =
        dq + ((static_cast<long long>(b) * Sq + r / G) * Hq + hkv * G + r % G) *
                 D;
#pragma unroll
    for (int pnl = 0; pnl < kOut; ++pnl)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * (v0 + pnl) + 8 * j + 2 * t4;
        if (c < D)
          *reinterpret_cast<uint32_t*>(row + c) =
              flash::pack_bf16(acc[pnl][4 * j + 2 * h] * scale,
                               acc[pnl][4 * j + 2 * h + 1] * scale);
      }
  }
}

// ---- bwd_dkdv --------------------------------------------------------------

template <int kPanels>
struct DkdvLayout {
  static constexpr int kTile = kPanels * kPanelBytes;      // K, V, q or dO
  static constexpr int kStage = 2 * kTile;                 // q then dO
  static constexpr int kRing = 2 * kTile;                  // after K, V
  static constexpr int kStats = kRing + 2 * kStage;        // 2 x 64 float2
  static constexpr int kBars = kStats + 2 * kTileRows * 8;
  static constexpr int kTiles = kBars + 3 * 8;
  static size_t bytes(int n_row_tiles) {
    return 1024 + kTiles + sizeof(int) * static_cast<size_t>(n_row_tiles);
  }
};

// Run item `it` (row tile tiles[it] >> 1) into stage it & 1: q's and dO's
// boxes of gb x qt rows for every panel of D, and the tile's 64 (lse,
// delta) pairs
template <int kPanels>
__device__ __forceinline__ void dkdv_fetch(
    const CUtensorMap* mq, const CUtensorMap* mdo, unsigned char* ring,
    float2* stats_s, uint64_t* full, const int* tiles, int it,
    const float2* stats_tiles, RowTiles rt, int hkv, int b) {
  constexpr int kTile = kPanels * kPanelBytes;
  const int st = it & 1;
  const int t = tiles[it] >> 1;
  const int i0 = (t / rt.head_tiles) * rt.qt, g0 = (t % rt.head_tiles) * rt.gb;
  unsigned char* qt = ring + st * 2 * kTile;
  flash::mbar_arrive_expect_tx(
      &full[st], 2 * kPanels * rt.gb * rt.qt * 128 + kTileRows * 8);
#pragma unroll
  for (int pnl = 0; pnl < kPanels; ++pnl) {
    flash::tma_load_5d(qt + pnl * kPanelBytes, mq, &full[st], 64 * pnl, g0,
                       hkv, i0, b);
    flash::tma_load_5d(qt + kTile + pnl * kPanelBytes, mdo, &full[st],
                       64 * pnl, g0, hkv, i0, b);
  }
  flash::bulk_load(stats_s + st * kTileRows,
                   stats_tiles + static_cast<long long>(t) * kTileRows,
                   kTileRows * 8, &full[st]);
}

template <int kPanels, int kOut>
__global__ void __launch_bounds__(128, kPanels == 1 ? 3 : 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_k,
                            const __grid_constant__ CUtensorMap tmap_v,
                            const __grid_constant__ CUtensorMap tmap_q,
                            const __grid_constant__ CUtensorMap tmap_do,
                            const float2* __restrict__ stats,
                            const int* __restrict__ q_pos,
                            const int* __restrict__ kv_pos,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv,
                            float* __restrict__ partial,
                            int* __restrict__ counters, int Sq, int Sk,
                            int Hq, int Hkv, int D, int causal, int window,
                            float scale, RowTiles rt, int n_row_tiles,
                            int runs) {
  using L = DkdvLayout<kPanels>;
  constexpr int kSplitD = kPanels / kOut;
  constexpr int kAcc = 2 * 32 * kOut;  // a thread's dK and dV
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ks = smem;                    // [kPanels][64 keys][128 B]
  unsigned char* vs = smem + L::kTile;
  unsigned char* ring = smem + L::kRing;       // 2 stages of q, dO
  float2* stats_s = reinterpret_cast<float2*>(smem + L::kStats);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* kvbar = full + 2;
  int* tiles = reinterpret_cast<int*>(smem + L::kTiles);
  __shared__ int k_lo, k_hi, k_all, n_live, last_s;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z, hkv = blockIdx.y;
  const int run = blockIdx.x % runs;
  const int unit = blockIdx.x / runs;          // key tile x panel half
  const int kt = unit / kSplitD;
  const int v0 = (unit % kSplitD) * kOut;      // this block's panels
  const int key0 = kt * kKeys;
  const int G = rt.G;
  const long long group = static_cast<long long>(b) * Hkv + hkv;

  if (tid == 0) {
    k_lo = INT_MAX;
    k_hi = INT_MIN;
    k_all = 1;
    flash::mbar_init(&full[0], 1);
    flash::mbar_init(&full[1], 1);
    flash::mbar_init(kvbar, 1);
    flash::mbar_fence_init();
  }
  // a tile of fewer than 64 rows leaves the rest of each panel to zeros,
  // which TMA never writes (P and dS are 0 there, and must meet finite q
  // and dO)
  if (rt.gb * rt.qt < kTileRows) {
    for (int e = tid; e < 2 * L::kStage / 16; e += 128)
      reinterpret_cast<uint4*>(ring)[e] = make_uint4(0u, 0u, 0u, 0u);
    flash::fence_proxy_async();
  }
  __syncthreads();
  if (tid == 0) {
    flash::mbar_arrive_expect_tx(kvbar, 2 * L::kTile);
#pragma unroll
    for (int pnl = 0; pnl < kPanels; ++pnl) {
      flash::tma_load_4d(ks + pnl * kPanelBytes, &tmap_k, kvbar, 64 * pnl, hkv,
                         key0, b);
      flash::tma_load_4d(vs + pnl * kPanelBytes, &tmap_v, kvbar, 64 * pnl, hkv,
                         key0, b);
    }
  }
  // the block's keys: written positions' least and largest, all written?
  if (tid < kKeys) {
    const int j = key0 + tid;
    const int p = j < Sk ? kv_pos[static_cast<long long>(b) * Sk + j] : -1;
    if (p >= 0) {
      atomicMin(&k_lo, p);
      atomicMax(&k_hi, p);
    } else {
      k_all = 0;
    }
  }
  __syncthreads();
  // the row tiles some pair may attend, and those every pair attends whole
  // (every row valid and of a full tile, every key written, none after the
  // least query when causal, all inside the window of the largest), as
  // 2 t + whole in order
  {
    const int klo = k_lo, khi = k_hi, kall = k_all;
    const bool any_key = klo <= khi;
    for (int t = warp; t < n_row_tiles; t += 4) {
      const int i0 = (t / rt.head_tiles) * rt.qt;
      const int g0 = (t % rt.head_tiles) * rt.gb;
      int lo = INT_MAX, hi = INT_MIN;
      for (int qq = lane; qq < rt.qt; qq += 32) {
        if (i0 + qq >= Sq) break;
        const int p = q_pos[static_cast<long long>(b) * Sq + i0 + qq];
        lo = min(lo, p);
        hi = max(hi, p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      }
      const bool live = any_key && (!causal || klo <= hi) &&
                        (window <= 0 || lo - khi < window);
      const bool whole = kall && rt.gb * rt.qt == kTileRows &&
                         i0 + rt.qt <= Sq && g0 + rt.gb <= G &&
                         (!causal || khi <= lo) &&
                         (window <= 0 || hi - klo < window);
      if (lane == 0) tiles[t] = live | (whole << 1);
    }
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int t0 = 0; t0 < n_row_tiles; t0 += 32) {
      const int t = t0 + lane;
      const int code = t < n_row_tiles ? tiles[t] : 0;
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
  // this run's share of the live row tiles: [n run / runs, n (run+1) / runs)
  const int lo_t = static_cast<int>(static_cast<long long>(n_live) * run / runs);
  const int hi_t =
      static_cast<int>(static_cast<long long>(n_live) * (run + 1) / runs);
  const int* mine = tiles + lo_t;
  const int nm = hi_t - lo_t;
  const float2* stats_tiles = stats + group * n_row_tiles * kTileRows;
  if (tid == 0)
    for (int it = 0; it < min(2, nm); ++it)
      dkdv_fetch<kPanels>(&tmap_q, &tmap_do, ring, stats_s, full, mine, it,
                          stats_tiles, rt, hkv, b);

  // this thread's keys, 16 w + g4 and + 8, the rows of S^T it holds
  const int g4 = lane / 4, t4 = lane % 4;
  const int kr = warp * 16 + g4;
  int kp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = key0 + kr + 8 * h;
    kp[h] = j < Sk ? kv_pos[static_cast<long long>(b) * Sk + j] : -1;
  }
  float acc_k[kOut][32], acc_v[kOut][32];
#pragma unroll
  for (int pnl = 0; pnl < kOut; ++pnl)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc_k[pnl][e] = acc_v[pnl][e] = 0.0f;
  const float scale2 = scale * kLog2e;
  flash::mbar_wait(kvbar, 0);

  for (int it = 0; it < nm; ++it) {
    const int st = it & 1;
    const unsigned char* qt = ring + st * L::kStage;
    const unsigned char* dot = qt + L::kTile;
    const float2* sts = stats_s + st * kTileRows;
    const int code = mine[it];
    const int t = code >> 1;
    flash::mbar_wait(&full[st], (it >> 1) & 1);

    // S^T = K q^T and dP^T = V dO^T: keys x rows
    float s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.0f;
    flash::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * kPanels; ++kk)
      flash::wgmma_m64n64k16_ss(s, kmajor(ks, kk, kPanelBytes),
                                kmajor(qt, kk, kPanelBytes), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4 * kPanels; ++kk)
      flash::wgmma_m64n64k16_ss(dp, kmajor(vs, kk, kPanelBytes),
                                kmajor(dot, kk, kPanelBytes), kk > 0);
    flash::wgmma_commit();
    flash::wgmma_wait_all();
    flash::fence_regs(s);
    flash::fence_regs(dp);

    // P^T = 2^(s scale log2 e - lse / ln 2) where the pair attends (the
    // statistics hold lse in base 2), dS^T = P^T (dP^T -
    // delta); row n of the tile is query i0 + n / gb, head g0 + n % gb.
    // Each 16 rows become P's and dS's hi and lo fragments as they are
    // done, so S^T and dP^T die as the fragments grow
    const int i0 = (t / rt.head_tiles) * rt.qt;
    const int g0 = (t % rt.head_tiles) * rt.gb;
    uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int j = 2 * kc; j < 2 * kc + 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 8 * j + 2 * t4 + e;
          const float2 ld = sts[n];
          int qpn = 0;
          bool valid = true;
          if (!(code & 1)) {
            const int i = i0 + n / rt.gb;
            valid = n < rt.gb * rt.qt && i < Sq && g0 + n % rt.gb < G;
            qpn = valid ? q_pos[static_cast<long long>(b) * Sq + i] : 0;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int at = 4 * j + 2 * h + e;
            const bool ok =
                (code & 1) || (valid && attends(kp[h], qpn, causal, window));
            // a slot that holds no row of the tile was never written by
            // bwd_dq (the scratch is not cleared): its statistics, any
            // bits at all, must not reach S^T or dP^T (0 NaN is NaN)
            const float p = ok ? exp2f(fmaf(s[at], scale2, -ld.x)) : 0.0f;
            s[at] = p;
            dp[at] = ok ? p * (dp[at] - ld.y) : 0.0f;
          }
        }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        hi_lo(s[8 * kc + 2 * r], s[8 * kc + 2 * r + 1], p_hi[kc][r],
              p_lo[kc][r]);
        hi_lo(dp[8 * kc + 2 * r], dp[8 * kc + 2 * r + 1], ds_hi[kc][r],
              ds_lo[kc][r]);
      }
    }

    // dV += P^T dO, dK += dS^T q: the tile's rows are K, MN-major B
#pragma unroll
    for (int pnl = 0; pnl < kOut; ++pnl) {
      flash::fence_regs(acc_k[pnl]);
      flash::fence_regs(acc_v[pnl]);
    }
    flash::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int pnl = 0; pnl < kOut; ++pnl) {
        const uint64_t ddo = mnmajor(dot, v0 + pnl, kc);
        const uint64_t dq_ = mnmajor(qt, v0 + pnl, kc);
        flash::wgmma_m64n64k16<1>(acc_v[pnl], p_hi[kc], ddo, 1);
        flash::wgmma_m64n64k16<1>(acc_v[pnl], p_lo[kc], ddo, 1);
        flash::wgmma_m64n64k16<1>(acc_k[pnl], ds_hi[kc], dq_, 1);
        flash::wgmma_m64n64k16<1>(acc_k[pnl], ds_lo[kc], dq_, 1);
      }
    flash::wgmma_commit();
    flash::wgmma_wait_all();
#pragma unroll
    for (int pnl = 0; pnl < kOut; ++pnl) {
      flash::fence_regs(acc_k[pnl]);
      flash::fence_regs(acc_v[pnl]);
    }
    __syncthreads();  // the stage is free
    if (tid == 0 && it + 2 < nm)
      dkdv_fetch<kPanels>(&tmap_q, &tmap_do, ring, stats_s, full, mine, it + 2,
                          stats_tiles, rt, hkv, b);
  }

  // with more than one run: this run's partial to scratch (element-major,
  // a thread's kAcc floats at stride 128), and the last block of the key
  // tile to arrive sums every run's in run order
  if (runs > 1) {
    const long long cell =
        (group * gridDim.x / runs + unit) * runs;  // (key tile, half) runs
    float* mine_p = partial + (cell + run) * kAcc * 128;
#pragma unroll
    for (int pnl = 0; pnl < kOut; ++pnl)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        mine_p[(pnl * 32 + e) * 128 + tid] = acc_k[pnl][e];
        mine_p[((kOut + pnl) * 32 + e) * 128 + tid] = acc_v[pnl][e];
      }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* counter = counters + group * gridDim.x / runs + unit;
      const int prev = atomicAdd(counter, 1);
      last_s = prev == runs - 1;
      if (last_s) *counter = 0;  // every run has arrived: ready for reuse
    }
    __syncthreads();
    if (!last_s) return;
    __threadfence();
#pragma unroll
    for (int pnl = 0; pnl < kOut; ++pnl)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        float sk = 0.0f, sv = 0.0f;
        for (int rr = 0; rr < runs; ++rr) {
          const float* pr = partial + (cell + rr) * kAcc * 128;
          sk += __ldcg(pr + (pnl * 32 + e) * 128 + tid);
          sv += __ldcg(pr + ((kOut + pnl) * 32 + e) * 128 + tid);
        }
        acc_k[pnl][e] = sk;
        acc_v[pnl][e] = sv;
      }
  }

  // dk = scale acc_k, dv = acc_v, two bf16 a store
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = key0 + kr + 8 * h;
    if (j >= Sk) continue;
    const long long off = ((static_cast<long long>(b) * Sk + j) * Hkv + hkv) * D;
#pragma unroll
    for (int pnl = 0; pnl < kOut; ++pnl)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = 64 * (v0 + pnl) + 8 * jj + 2 * t4;
        if (c < D) {
          const int at = 4 * jj + 2 * h;
          *reinterpret_cast<uint32_t*>(dk + off + c) = flash::pack_bf16(
              acc_k[pnl][at] * scale, acc_k[pnl][at + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + off + c) =
              flash::pack_bf16(acc_v[pnl][at], acc_v[pnl][at + 1]);
        }
      }
  }
}

// ---- host ------------------------------------------------------------------

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

// A bf16 tensor map of `rank` dims (innermost first, dims[0] = D
// contiguous), boxes of `box`, in the 128-byte swizzle, zeros beyond every
// edge.
bool encode_map(CUtensorMap* map, const void* base, int rank,
                const cuuint64_t* dims, const cuuint32_t* box) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t strides[4];
  cuuint64_t stride = sizeof(__nv_bfloat16);
  for (int i = 0; i + 1 < rank; ++i) strides[i] = stride *= dims[i];
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// k or v (B, Sk, Hkv, D) as dims (D, Hkv, Sk, B), boxes of 64 keys of one
// head, 64 columns of D
bool encode_kv(CUtensorMap* map, const void* base, int B, int Sk, int Hkv,
               int D) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(Sk > 0 ? Sk : 1),
                              static_cast<cuuint64_t>(B)};
  const cuuint32_t box[4] = {64, 1, kKeys, 1};
  return encode_map(map, base, 4, dims, box);
}

// q or dO (B, Sq, Hq, D) as dims (D, G, Hkv, Sq, B), boxes of gb heads x qt
// queries of one KV head's group, 64 columns of D: a row tile
bool encode_rows(CUtensorMap* map, const void* base, int B, int Sq, int Hq,
                 int Hkv, int D, int gb, int qt) {
  const cuuint64_t dims[5] = {
      static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(Hq / Hkv),
      static_cast<cuuint64_t>(Hkv), static_cast<cuuint64_t>(Sq),
      static_cast<cuuint64_t>(B)};
  const cuuint32_t box[5] = {64, static_cast<cuuint32_t>(gb), 1,
                             static_cast<cuuint32_t>(qt), 1};
  return encode_map(map, base, 5, dims, box);
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

// A shape out of range, or row tiles (kernel.bwd_tiling picks them) that
// do not fit a 64-slot tile or do not number n_row_tiles
bool bad_call(int B, int Sq, int Sk, int Hq, int Hkv, int D, int gb, int qt,
              int n_row_tiles) {
  if (Sq < 0 || Sk < 0 || Hkv < 1 || Hq % Hkv != 0 || D % 8 != 0 || D < 8 ||
      D > 256 || B > 65535 || Hkv > 65535 ||
      static_cast<long long>(Sq) * (Hq / Hkv) > INT_MAX)
    return true;
  const int G = Hq / Hkv;
  return gb < 1 || qt < 1 || gb > G || gb * qt > kTileRows ||
         static_cast<long long>(n_row_tiles) !=
             static_cast<long long>((Sq + qt - 1) / qt) * ((G + gb - 1) / gb);
}

int panels_of(int D) { return D <= 64 ? 1 : D <= 128 ? 2 : 4; }

RowTiles row_tiles(int Hq, int Hkv, int gb, int qt) {
  const int G = Hq / Hkv;
  return RowTiles{G, gb, qt, (G + gb - 1) / gb};
}

template <int kPanels, int kOut, int kWgs>
cudaError_t launch_dq(const CUtensorMap& mk, const CUtensorMap& mv,
                      const void* q, const void* o, const void* dout,
                      const int* q_pos, const int* kv_pos, void* dq,
                      float2* stats, int B, int Sq, int Sk, int Hq, int Hkv,
                      int D, int causal, int window, float scale,
                      RowTiles rt, int n_row_tiles, cudaStream_t stream) {
  using L = DqLayout<kPanels, kWgs>;
  const size_t smem = L::bytes((Sk + kKeys - 1) / kKeys);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<kPanels, kOut, kWgs>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long R = static_cast<long long>(Sq) * (Hq / Hkv);
  const long long blocks = (R + L::kRows - 1) / L::kRows * (kPanels / kOut);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), Hkv, B);
  flash_bwd_dq_wgmma_kernel<kPanels, kOut, kWgs>
      <<<grid, kWgs * 128, smem, stream>>>(
          mk, mv, static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(o),
          static_cast<const __nv_bfloat16*>(dout), q_pos, kv_pos,
          static_cast<__nv_bfloat16*>(dq), stats, Sq, Sk, Hq, Hkv, D, causal,
          window, scale, rt, n_row_tiles);
  return cudaGetLastError();
}

template <int kPanels, int kOut>
cudaError_t launch_dkdv(const CUtensorMap& mk, const CUtensorMap& mv,
                        const CUtensorMap& mq, const CUtensorMap& mdo,
                        const float2* stats, const int* q_pos,
                        const int* kv_pos, void* dk, void* dv, float* partial,
                        int* counters, int B, int Sq, int Sk, int Hq, int Hkv,
                        int D, int causal, int window, float scale,
                        RowTiles rt, int n_row_tiles, int runs,
                        cudaStream_t stream) {
  using L = DkdvLayout<kPanels>;
  const size_t smem = L::bytes(n_row_tiles);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma_kernel<kPanels, kOut>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>((Sk + kKeys - 1) / kKeys) * (kPanels / kOut) *
      runs;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), Hkv, B);
  flash_bwd_dkdv_wgmma_kernel<kPanels, kOut><<<grid, 128, smem, stream>>>(
      mk, mv, mq, mdo, stats, q_pos, kv_pos, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), partial, counters, Sq, Sk, Hq, Hkv, D,
      causal, window, scale, rt, n_row_tiles, runs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dQ of one bf16 call on the tensor cores, and each (query, head) row's
// (lse, delta) into `stats` ((B, Hkv, n_row_tiles, 64) float pairs, the row
// tiles of gb heads x qt queries that kernel.bwd_tiling lays out), on
// `stream`; returns cudaGetLastError() (0 on success).  No rows: nothing
// launched, 0.  A shape or tiling out of range, a pointer not 16-byte
// aligned: cudaErrorInvalidValue.
int flash_attention_bwd_dq_wgmma(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* q_pos, const void* kv_pos,
                                 void* dq, void* stats, int B, int Sq, int Sk,
                                 int Hq, int Hkv, int D, int causal,
                                 int window, float scale, int gb, int qt,
                                 int n_row_tiles, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (bad_call(B, Sq, Sk, Hq, Hkv, D, gb, qt, n_row_tiles) ||
      misaligned(q) || misaligned(k) || misaligned(v) || misaligned(o) ||
      misaligned(dout) || misaligned(dq) || misaligned(stats))
    return cudaErrorInvalidValue;
  // no keys: no tile to load, and no map to encode
  CUtensorMap mk{}, mv{};
  if (Sk > 0 &&
      (!encode_kv(&mk, k, B, Sk, Hkv, D) || !encode_kv(&mv, v, B, Sk, Hkv, D)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  float2* st = static_cast<float2*>(stats);
  const RowTiles rt = row_tiles(Hq, Hkv, gb, qt);
  cudaError_t err;
  switch (panels_of(D)) {
    case 1:
      err = launch_dq<1, 1, 2>(mk, mv, q, o, dout, qp, kp, dq, st, B, Sq, Sk,
                               Hq, Hkv, D, causal, window, scale, rt,
                               n_row_tiles, s);
      break;
    case 2:
      err = launch_dq<2, 2, 2>(mk, mv, q, o, dout, qp, kp, dq, st, B, Sq, Sk,
                               Hq, Hkv, D, causal, window, scale, rt,
                               n_row_tiles, s);
      break;
    default:
      err = launch_dq<4, 2, 1>(mk, mv, q, o, dout, qp, kp, dq, st, B, Sq, Sk,
                               Hq, Hkv, D, causal, window, scale, rt,
                               n_row_tiles, s);
  }
  return static_cast<int>(err);
}

// dK and dV of one bf16 call on the tensor cores, from the statistics
// flash_attention_bwd_dq_wgmma wrote (launched after it on the same
// stream), the row tiles split into `runs` runs a key tile; with runs > 1
// `partial` holds 8192 x (panels a block) floats for each (batch, KV head,
// key tile, panel half, run) and `counters` one int for each (batch, KV
// head, key tile, panel half), all zero, left zero.  Returns
// cudaGetLastError().  No keys or no rows: nothing launched, 0.
int flash_attention_bwd_dkdv_wgmma(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* q_pos, const void* kv_pos,
                                   const void* stats, void* dk, void* dv,
                                   void* partial, void* counters, int B,
                                   int Sq, int Sk, int Hq, int Hkv, int D,
                                   int causal, int window, float scale, int gb,
                                   int qt, int n_row_tiles, int runs,
                                   void* stream) {
  if (B <= 0 || Sk <= 0 || Sq <= 0) return 0;
  if (bad_call(B, Sq, Sk, Hq, Hkv, D, gb, qt, n_row_tiles) ||
      runs < 1 || (runs > 1 && (partial == nullptr || counters == nullptr)) ||
      misaligned(q) || misaligned(k) || misaligned(v) || misaligned(dout) ||
      misaligned(dk) || misaligned(dv) || misaligned(stats))
    return cudaErrorInvalidValue;
  CUtensorMap mk, mv, mq, mdo;
  if (!encode_kv(&mk, k, B, Sk, Hkv, D) || !encode_kv(&mv, v, B, Sk, Hkv, D) ||
      !encode_rows(&mq, q, B, Sq, Hq, Hkv, D, gb, qt) ||
      !encode_rows(&mdo, dout, B, Sq, Hq, Hkv, D, gb, qt))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  const float2* st = static_cast<const float2*>(stats);
  float* part = static_cast<float*>(partial);
  int* cnt = static_cast<int*>(counters);
  const RowTiles rt = row_tiles(Hq, Hkv, gb, qt);
  cudaError_t err;
  switch (panels_of(D)) {
    case 1:
      err = launch_dkdv<1, 1>(mk, mv, mq, mdo, st, qp, kp, dk, dv, part, cnt,
                              B, Sq, Sk, Hq, Hkv, D, causal, window, scale, rt,
                              n_row_tiles, runs, s);
      break;
    case 2:
      err = launch_dkdv<2, 2>(mk, mv, mq, mdo, st, qp, kp, dk, dv, part, cnt,
                              B, Sq, Sk, Hq, Hkv, D, causal, window, scale, rt,
                              n_row_tiles, runs, s);
      break;
    default:
      err = launch_dkdv<4, 2>(mk, mv, mq, mdo, st, qp, kp, dk, dv, part, cnt,
                              B, Sq, Sk, Hq, Hkv, D, causal, window, scale, rt,
                              n_row_tiles, runs, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
