// Whole-sequence LSTM backward for Hopper (sm_90a), two kernels, launched
// back to back on one stream, over a stream axis S (a fleet of S
// independent LSTMs, each with its own weights; one LSTM is S = 1):
//   lstm_bwd_time_kernel     the reverse-time loop of a tile of batch rows of
//                            one stream: dx (B,T,F), and the tile's partial
//                            weight gradient [x; h_prev; 1]^T dz, (F+H+1, 4H)
//   lstm_bwd_combine_kernel  each stream's partials summed in block order ->
//                            dwx (F,4H), dwh (H,4H), db (4H) of the stream
// Every array below carries a leading S; the grids are (tiles, S) and
// (elements, S), and a block offsets its pointers by its stream
// (blockIdx.y), so one stream's sums are those of an S = 1 launch.
//
// Together they replace the Pallas TPU kernel
//   src/repro/kernels/lstm_cell/kernel.py: lstm_sequence_bwd
//                                          (_sequence_bwd_kernel).
//
// Inputs, per stream, are the primal x (B,T,F) in float32 or bfloat16 and the residuals
// of the training forward (lstm_sequence.cu): post-activation gates
// (B,T,4H) in the order i, f, g, o, c_seq and h_seq (B,T,H), all float32;
// wx (F,4H) and wh (H,4H); dh and dc (B,H), the cotangents of the final
// (h, c).  Every output is float32.  At t = 0, h_prev and c_prev are zero.
//
// What bounds them: at the speed-training shape (B=64, T=5, F=5, H=40) a
// call is ~8.5 MFLOP over ~0.4 MB, well under a microsecond of the card's
// float32 or memory rate.  Latency sets the time: the round trip of the
// loads in front of the chain, the serial T-step chain (a barrier, a 4H-long
// dot and a reduction across lanes a step), the weight-gradient product of
// the tile, and the combine's round trips to memory.
//
// The reference sums the weight gradients over its batch grid into one
// output block, which works only because the TPU runs the grid in order.
// Blocks on Hopper run concurrently, and float atomics would add in an
// order that changes from run to run.  So each block writes the partial
// gradient of its own rows to a workspace, and the combine kernel sums the
// partials in a fixed order: no atomics, reruns bit-identical, and no loop
// over all B*T rows anywhere.
//
// Design of the time kernel (one 1-d block of R*4H threads, rounded up to
// whole warps, for a tile of R = max(1, 320/4H) batch rows: 2 at H = 40):
//   * wx and wh arrive in shared memory by two cp.async.bulk copies on one
//     mbarrier (async_copy.cuh); meanwhile every thread starts its loads of
//     the chunk's residuals (into registers) and of [x; h_prev; 1] (into
//     shared memory) together, one round trip for all.
//   * Thread p of row r is lane q = p % 4 of unit j = p / 4.  A step, lane q
//     forms dz of gate q of unit j into shared memory; after one barrier
//     the row's units take dh_j = sum_col dz[col] wh[j, col].  Where H is a
//     multiple of 8 and at most kRegH, a warp's 8 units split the 4H
//     columns over its 32 lanes, each lane holding its H/8 columns of the 8
//     rows of wh in registers and reading H/8 values of dz, and a transpose
//     reduction by __shfl_xor_sync (unit_sums) leaves each unit's sum on
//     its quad; otherwise lane q takes H columns from shared memory and the
//     quad adds the four pieces.  Either way the order is fixed.  dc_j stays
//     in registers, and the residuals shift through registers a step.
//   * dz of the chunk stays in shared memory (R x chunk x 4H floats); no
//     (B,T,4H) workspace goes to global memory.
//   * After the chunk's steps, off the chain: dx of every (row, t), one
//     warp a (row, t) with the lanes over the columns, two k at a time;
//     then the tile's partial [x; h_prev; 1]^T dz, one thread a 4 x 4 block
//     (a 16-byte load of each operand feeds 16 FMAs), summed over the
//     tile's rows, then steps, in order, and added to the earlier chunks'.
//   * The time loop runs in chunks of up to kChunk steps, fewer where the
//     weights leave less shared memory, so any T runs; at T <= kChunk it is
//     one chunk.
// The combine cuts the partials into kRuns runs of consecutive blocks,
// sums each run in block order with up to 32 loads in flight, and adds the
// runs in order: one round trip for up to 32 * kRuns partials.
// Float32 FMAs throughout, no tensor cores: TF32 would break the tolerance.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

// dynamic shared memory one block may use on Hopper (227 KB)
constexpr size_t kSmemLimit = 232448;
// steps of residuals a thread holds in registers: the longest chunk
constexpr int kChunk = 8;
constexpr int kMaxThreads = 512;
// rows of threads a block aims for: R = max(1, kTargetThreads / 4H)
constexpr int kTargetThreads = 320;
constexpr int kCombineThreads = 128;
// runs of consecutive blocks the combine sums apart, then adds in order
constexpr int kRuns = 4;
// the longest piece of a row of wh a lane holds in registers
constexpr int kRegH = 64;
// elements of [x; h_prev; 1] a thread stages at once
constexpr int kStage = 4;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The warp's 8 units' sums over its 32 lanes, from lane L's pieces pu[u] of
// every unit: a transpose reduction by __shfl_xor_sync with offsets 16, 8
// and 4, each halving the units a lane carries, then 2 and 1 over the quad.
// Lane L ends with the sum of unit L / 4, as do the other lanes of its quad;
// every unit's pieces are added as the butterfly with offsets 16, 8, 4, 2,
// 1 adds them.
__device__ __forceinline__ float unit_sums(const float (&pu)[8], int lane) {
  const unsigned full = 0xffffffffu;
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float v4[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v4[i] = (b4 ? pu[i + 4] : pu[i]) +
            __shfl_xor_sync(full, b4 ? pu[i] : pu[i + 4], 16);
  float v2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    v2[i] = (b3 ? v4[i + 2] : v4[i]) +
            __shfl_xor_sync(full, b3 ? v4[i] : v4[i + 2], 8);
  float v = (b2 ? v2[1] : v2[0]) + __shfl_xor_sync(full, b2 ? v2[0] : v2[1], 4);
  v += __shfl_xor_sync(full, v, 2);
  v += __shfl_xor_sync(full, v, 1);
  return v;
}

struct Tiling {
  int rows;    // batch rows a block of the time kernel takes
  int chunk;   // steps a chunk of its time loop takes
  int blocks;  // its blocks: one partial each
  size_t smem;
};

// The mbarrier (16 bytes), wx and wh (multiples of 16 bytes, as the bulk
// copies need), then dz and [x; h_prev; 1] of R rows over `chunk` steps,
// the latter's rows padded to a multiple of 4 floats (16-byte loads).
size_t smem_bytes(int F, int H, int R, int chunk) {
  const size_t G = 4 * static_cast<size_t>(H), K = (F + H + 4) / 4 * 4;
  return 16 + sizeof(float) * ((F + H) * G +
                               static_cast<size_t>(R) * chunk * (G + K));
}

// R rows a block (fewer where shared memory runs out), then the longest
// chunk that fits; {0, ...} where not even one row and one step fit.
Tiling tiling(int B, int T, int F, int H) {
  const int G = 4 * H;
  int R = kTargetThreads / G;
  R = R < 1 ? 1 : R;
  while (R > 1 && smem_bytes(F, H, R, 1) > kSmemLimit) --R;
  int chunk = T < kChunk ? T : kChunk;
  while (chunk > 1 && smem_bytes(F, H, R, chunk) > kSmemLimit) --chunk;
  if (smem_bytes(F, H, R, chunk) > kSmemLimit) return {0, 0, 0, 0};
  return {R, chunk, (B + R - 1) / R, smem_bytes(F, H, R, chunk)};
}

// Whether the lanes hold wh in registers and split dh over a warp: H <=
// kRegH, and H a multiple of 8, so that a row's 4H threads are whole warps
// and each lane takes H/8 columns.
bool registers_hold_wh(int H) { return H <= kRegH && H % 8 == 0; }

// kRegW: lane L of a warp holds, in registers, the columns L*H/8 ..
// (L+1)*H/8 - 1 of the rows of wh of the warp's 8 units, and takes their
// pieces of dh over those columns (unit_sums); otherwise lane q of unit j
// takes the columns qH .. qH + H - 1 from shared memory, and the quad adds
// the four pieces.  kStreams = false is the S = 1 instance of the same
// body (no stream offsets), as in lstm_sequence.cu.
template <typename Tin, bool kRegW, bool kStreams>
__global__ void __launch_bounds__(kRegW ? kTargetThreads : kMaxThreads)
    lstm_bwd_time_kernel(const Tin* __restrict__ x,
                         const float* __restrict__ gates,
                         const float* __restrict__ c_seq,
                         const float* __restrict__ h_seq,
                         const float* __restrict__ wx,
                         const float* __restrict__ wh,
                         const float* __restrict__ dh_in,
                         const float* __restrict__ dc_in,
                         float* __restrict__ dx, float* __restrict__ part,
                         int B, int T, int F, int H, int R, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = 4 * H, K = F + H + 1, KA = (K + 3) / 4 * 4;
  // the block's stream: its slices of every array, and its own run of
  // partials (gridDim.x of them a stream)
  if (kStreams) {
    const long long s = blockIdx.y, BT = static_cast<long long>(B) * T;
    x += s * BT * F;
    gates += s * BT * G;
    c_seq += s * BT * H;
    h_seq += s * BT * H;
    wx += s * F * G;
    wh += s * H * G;
    dh_in += s * B * H;
    dc_in += s * B * H;
    dx += s * BT * F;
    part += s * gridDim.x * static_cast<long long>(K) * G;
  }
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  float* s_wx = reinterpret_cast<float*>(smem_raw + 16);  // (F, 4H)
  float* s_wh = s_wx + F * G;                 // (H, 4H), unless kRegW
  float* s_dz = s_wh + H * G;                 // (R, chunk, 4H)
  float* s_a = s_dz + R * chunk * G;          // (R, chunk, KA)

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  if (tid == 0) {
    lstm::mbar_init(bar, 1);
    const uint32_t wx_bytes = 4u * F * G, wh_bytes = 4u * H * G;
    lstm::mbar_arrive_expect_tx(bar, wx_bytes + wh_bytes);
    lstm::bulk_copy_g2s(s_wx, wx, wx_bytes, bar);
    lstm::bulk_copy_g2s(s_wh, wh, wh_bytes, bar);
  }

  // threads past R*4H only keep the warps whole: they meet every barrier
  // and share the work after each chunk
  const bool has_row = tid < R * G;
  const int r = has_row ? tid / G : 0;
  const int p = tid - r * G;
  const int j = p >> 2, q = p & 3;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const long long row = row0 + r;
  const bool active = has_row && row < B;
  const unsigned quad = lstm::quad_mask();
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  float* my_part = part + static_cast<long long>(blockIdx.x) * K * G;

  // wh[j0 + v, L*H/8 + c] at [v * kRegH/8 + c] (j0 the warp's first unit,
  // L its lane), once the weights have landed
  float w[kRegW ? kRegH : 1];
  float dh = 0.0f, dc = 0.0f;
  if (active) {
    dh = dh_in[row * H + j];
    dc = dc_in[row * H + j];
  }
  for (int t1 = T; t1 > 0; t1 -= chunk) {
    const int t0 = t1 > chunk ? t1 - chunk : 0;
    const int n = t1 - t0;
    // the chunk's residuals of unit j, into registers in the order the
    // steps use them: index u is step t1 - 1 - u
    float gi[kChunk], gf[kChunk], gg[kChunk], go[kChunk], cs[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      gi[u] = gf[u] = gg[u] = go[u] = cs[u] = 0.0f;
      if (u < n && active) {
        const long long rt = row * T + t1 - 1 - u;
        const float* g4 = gates + rt * G;
        gi[u] = __ldg(g4 + j);
        gf[u] = __ldg(g4 + H + j);
        gg[u] = __ldg(g4 + 2 * H + j);
        go[u] = __ldg(g4 + 3 * H + j);
        cs[u] = __ldg(c_seq + rt * H + j);
      }
    }
    // c of step t0 - 1, the c_prev of the chunk's last step
    const float c_before =
        active && t0 > 0 ? __ldg(c_seq + (row * T + t0 - 1) * H + j) : 0.0f;
    // [x_t; h_{t-1}; 1] of the tile's rows for the weight gradients; zero
    // for rows past B, whose dz is zero too, and for the padding; each
    // thread's loads started together
    for (int i0 = tid; i0 < R * n * KA; i0 += kStage * nthreads) {
      float v[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = i0 + u * nthreads;
        const int rr = i / (n * KA), rem = i - rr * n * KA;
        const int s = rem / KA, k = rem - s * KA;
        const long long rrow = row0 + rr;
        const int t = t0 + s;
        v[u] = 0.0f;
        if (i < R * n * KA && rrow < B) {
          if (k < F)
            v[u] = load_f32(x + (rrow * T + t) * F + k);
          else if (k < F + H)
            v[u] = t > 0 ? __ldg(h_seq + (rrow * T + t - 1) * H + (k - F))
                         : 0.0f;
          else if (k == F + H)
            v[u] = 1.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = i0 + u * nthreads;
        if (i < R * n * KA) {
          const int rr = i / (n * KA), rem = i - rr * n * KA;
          s_a[rr * chunk * KA + rem] = v[u];
        }
      }
    }
    if (t1 == T) {
      __syncthreads();  // the barrier's initialisation
      lstm::mbar_wait(bar, 0);
      if (kRegW) {
        const int cpl = H / 8, j0 = j & ~7;
#pragma unroll
        for (int v = 0; v < 8; ++v) {
#pragma unroll
          for (int c = 0; c < kRegH / 8; ++c)
            w[v * (kRegH / 8) + c] =
                has_row && c < cpl ? s_wh[(j0 + v) * G + lane * cpl + c]
                                   : 0.0f;
        }
      }
    }

    // the steps, a runtime loop: the residuals shift down one register a
    // step
#pragma unroll 1
    for (int u = 0; u < n; ++u) {
      const int s = n - 1 - u;  // the step's index in the chunk
      const float ig = gi[0], fg = gf[0], gt = gg[0], og = go[0], c_t = cs[0];
      const float c_prev = u + 1 < n ? cs[1] : c_before;
#pragma unroll
      for (int i = 0; i + 1 < kChunk; ++i) {
        gi[i] = gi[i + 1];
        gf[i] = gf[i + 1];
        gg[i] = gg[i + 1];
        go[i] = go[i + 1];
        cs[i] = cs[i + 1];
      }
      float* sd = s_dz + (r * chunk + s) * G;
      float dct = 0.0f;
      if (has_row) {
        const float tanh_c = tanhf(c_t);
        dct = dc + dh * og * (1.0f - tanh_c * tanh_c);
        float dz;
        if (q == 0)
          dz = dct * gt * ig * (1.0f - ig);
        else if (q == 1)
          dz = dct * c_prev * fg * (1.0f - fg);
        else if (q == 2)
          dz = dct * ig * (1.0f - gt * gt);
        else
          dz = dh * tanh_c * og * (1.0f - og);
        sd[q * H + j] = active ? dz : 0.0f;
      }
      // the row's dz is complete before any lane reads it
      __syncthreads();
      if (has_row && t0 + s > 0) {
        if (kRegW) {
          // lane L's piece of dh for each of the warp's 8 units: the
          // columns L*H/8 .. (L+1)*H/8 - 1
          const int cpl = H / 8;
          float d[kRegH / 8];
#pragma unroll
          for (int c = 0; c < kRegH / 8; ++c)
            d[c] = c < cpl ? sd[lane * cpl + c] : 0.0f;
          float pu[8];
#pragma unroll
          for (int v = 0; v < 8; ++v) {
            float acc = 0.0f;
#pragma unroll
            for (int c = 0; c < kRegH / 8; ++c)
              if (c < cpl) acc += d[c] * w[v * (kRegH / 8) + c];
            pu[v] = acc;
          }
          dh = unit_sums(pu, lane);
        } else {
          // lane q's piece of dh_j: the columns qH .. qH + H - 1
          const float* d = sd + q * H;
          const float* ws = s_wh + j * G + q * H;
          float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
          int m = 0;
          for (; m + 4 <= H; m += 4) {
            a0 += d[m] * ws[m];
            a1 += d[m + 1] * ws[m + 1];
            a2 += d[m + 2] * ws[m + 2];
            a3 += d[m + 3] * ws[m + 3];
          }
          for (; m < H; ++m) a0 += d[m] * ws[m];
          float piece = (a0 + a1) + (a2 + a3);
          piece += __shfl_xor_sync(quad, piece, 2);
          piece += __shfl_xor_sync(quad, piece, 1);
          dh = piece;
        }
        dc = dct * fg;
      }
    }
    // every dz of the chunk and s_a are in place: the steps' barriers
    // ordered them before this point

    // dx of the chunk: one warp a (row, step), its lanes over the columns,
    // two k at a time
    for (int m = warp; m < R * n; m += nwarps) {
      const int rr = m / n, s = m - rr * n;
      const float* d = s_dz + (rr * chunk + s) * G;
      float dv[kMaxThreads / 32];
#pragma unroll
      for (int i = 0; i < kMaxThreads / 32; ++i)
        dv[i] = lane + 32 * i < G ? d[lane + 32 * i] : 0.0f;
      const long long rt = (row0 + rr) * T + t0 + s;
      for (int k = 0; k < F; k += 2) {
        const float* w0 = s_wx + k * G;
        const float* w1 = s_wx + (k + 1 < F ? k + 1 : k) * G;
        float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
        for (int i = 0; i < kMaxThreads / 32; ++i) {
          if (lane + 32 * i < G) {
            a0 += dv[i] * w0[lane + 32 * i];
            a1 += dv[i] * w1[lane + 32 * i];
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          a0 += __shfl_xor_sync(0xffffffffu, a0, off);
          a1 += __shfl_xor_sync(0xffffffffu, a1, off);
        }
        if (lane == 0 && row0 + rr < B) {
          dx[rt * F + k] = a0;
          if (k + 1 < F) dx[rt * F + k + 1] = a1;
        }
      }
    }

    // the tile's partial weight gradient, one thread a block of 4 rows k of
    // [x; h_prev; 1] by 4 columns: per (row, step) one 16-byte load of s_a
    // and one of dz, then 16 FMAs; summed over the tile's rows, then steps,
    // in order; the first chunk stores, the later ones add
    const int cblocks = G / 4;
    for (int e = tid; e < KA / 4 * cblocks; e += nthreads) {
      const int k = 4 * (e / cblocks), col = 4 * (e - (e / cblocks) * cblocks);
      float acc[4][4] = {};
      for (int rr = 0; rr < R; ++rr) {
        const float* arow = s_a + rr * chunk * KA + k;
        const float* drow = s_dz + rr * chunk * G + col;
        for (int s = 0; s < n; ++s) {
          const float4 a = *reinterpret_cast<const float4*>(arow + s * KA);
          const float4 d = *reinterpret_cast<const float4*>(drow + s * G);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] += av[u] * dv[v];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (k + u < K) {
          float4* out = reinterpret_cast<float4*>(
              my_part + static_cast<long long>(k + u) * G + col);
          float4 sum = make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
          if (t1 != T) {
            const float4 old = *out;
            sum.x += old.x;
            sum.y += old.y;
            sum.z += old.z;
            sum.w += old.w;
          }
          *out = sum;
        }
      }
    }
    // the next chunk overwrites s_dz and s_a
    __syncthreads();
  }
}

// The combine: element e = k * 4H + col of [dwx; dwh; db] is the sum of the
// blocks' partials, cut into kRuns runs of consecutive blocks.  A block of
// kCombineThreads threads takes kCombineThreads / kRuns elements: thread
// (run, element) sums its run in block order, up to 32 loads in flight, and
// the first run's thread adds the runs' sums in run order.  A run of 32 or
// fewer partials costs one round trip to memory.
template <bool kStreams>
__global__ void __launch_bounds__(kCombineThreads) lstm_bwd_combine_kernel(
    const float* __restrict__ part, int blocks, int F, int H,
    float* __restrict__ dwx, float* __restrict__ dwh,
    float* __restrict__ db) {
  __shared__ float s_run[kRuns][kCombineThreads / kRuns];
  const int G = 4 * H;
  const long long n = static_cast<long long>(F + H + 1) * G;
  // the block's stream (blockIdx.y): its `blocks` partials and its outputs
  if (kStreams) {
    const long long s = blockIdx.y;
    part += s * blocks * n;
    dwx += s * F * G;
    dwh += s * H * G;
    db += s * G;
  }
  const int per_block = kCombineThreads / kRuns;
  const int run = threadIdx.x / per_block, slot = threadIdx.x % per_block;
  const long long e = static_cast<long long>(blockIdx.x) * per_block + slot;
  const int per_run = (blocks + kRuns - 1) / kRuns;
  const int b0 = run * per_run;
  const int b1 = b0 + per_run < blocks ? b0 + per_run : blocks;
  float acc = 0.0f;
  if (e < n) {
    for (int blk0 = b0; blk0 < b1; blk0 += 32) {
      float v[32];
#pragma unroll
      for (int i = 0; i < 32; ++i)
        v[i] = blk0 + i < b1 ? __ldg(part + (blk0 + i) * n + e) : 0.0f;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc += v[i];
    }
  }
  s_run[run][slot] = acc;
  __syncthreads();
  if (run != 0 || e >= n) return;
  float sum = s_run[0][slot];
#pragma unroll
  for (int i = 1; i < kRuns; ++i) sum += s_run[i][slot];
  if (e < static_cast<long long>(F) * G)
    dwx[e] = sum;
  else if (e < static_cast<long long>(F + H) * G)
    dwh[e - static_cast<long long>(F) * G] = sum;
  else
    db[e - static_cast<long long>(F + H) * G] = sum;
}

template <typename Tin, bool kRegW, bool kStreams>
cudaError_t launch_time(const Tiling& tl, int S, int threads,
                        cudaStream_t stream,
                        const void* x, const void* gates, const void* c_seq,
                        const void* h_seq, const void* wx, const void* wh,
                        const void* dh, const void* dc, void* dx, void* part,
                        int B, int T, int F, int H) {
  if (tl.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lstm_bwd_time_kernel<Tin, kRegW, kStreams>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(tl.smem));
    if (err != cudaSuccess) return err;
  }
  lstm_bwd_time_kernel<Tin, kRegW, kStreams>
      <<<dim3(tl.blocks, S), threads, tl.smem, stream>>>(
      static_cast<const Tin*>(x), static_cast<const float*>(gates),
      static_cast<const float*>(c_seq), static_cast<const float*>(h_seq),
      static_cast<const float*>(wx), static_cast<const float*>(wh),
      static_cast<const float*>(dh), static_cast<const float*>(dc),
      static_cast<float*>(dx), static_cast<float*>(part), B, T, F, H,
      tl.rows, tl.chunk);
  return cudaGetLastError();
}

template <typename Tin, bool kStreams>
cudaError_t launch(const void* x, const void* gates, const void* c_seq,
                   const void* h_seq, const void* wx, const void* wh,
                   const void* dh, const void* dc, void* dx, void* part,
                   void* dwx, void* dwh, void* db, int S, int B, int T, int F,
                   int H, cudaStream_t stream) {
  const Tiling tl = tiling(B, T, F, H);
  if (tl.rows == 0) return cudaErrorInvalidValue;
  const int threads = (tl.rows * 4 * H + 31) / 32 * 32;
  const cudaError_t err =
      registers_hold_wh(H)
          ? launch_time<Tin, true, kStreams>(tl, S, threads, stream, x, gates,
                                             c_seq, h_seq, wx, wh, dh, dc, dx,
                                             part, B, T, F, H)
          : launch_time<Tin, false, kStreams>(tl, S, threads, stream, x,
                                              gates, c_seq, h_seq, wx, wh, dh,
                                              dc, dx, part, B, T, F, H);
  if (err != cudaSuccess) return err;
  const long long n_out = static_cast<long long>(F + H + 1) * 4 * H;
  const int per_block = kCombineThreads / kRuns;
  const dim3 grid(static_cast<int>((n_out + per_block - 1) / per_block), S);
  lstm_bwd_combine_kernel<kStreams><<<grid, kCombineThreads, 0, stream>>>(
      static_cast<const float*>(part), tl.blocks, F, H,
      static_cast<float*>(dwx), static_cast<float*>(dwh),
      static_cast<float*>(db));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory the time kernel needs for (F, H) at its smallest
// tiling (one row, one step a chunk); larger tilings are used where they fit.
long long lstm_sequence_bwd_smem_bytes(int F, int H) {
  return static_cast<long long>(smem_bytes(F, H, 1, 1));
}

// The time kernel's tiling of one stream's (B, T, F, H): out = {rows,
// chunk, lanes a piece of dh is split over, blocks a stream};
// returns the floats of one stream's partials, blocks * (F+H+1) * 4H, or
// -1 where (F, H) does not fit.  The workspace of an S-stream call is S
// times that.
long long lstm_sequence_bwd_tiling(int B, int T, int F, int H, int* out) {
  const Tiling tl = tiling(B, T, F, H);
  out[0] = tl.rows;
  out[1] = tl.chunk;
  out[2] = registers_hold_wh(H) ? 32 : 4;
  out[3] = tl.blocks;
  if (tl.rows == 0) return -1;
  return static_cast<long long>(tl.blocks) * (F + H + 1) * 4 * H;
}

// Launches both kernels over S streams on `stream`, in order, and returns
// the first cudaGetLastError() that is not 0 (0 on success).  part is the
// workspace, S times lstm_sequence_bwd_tiling's size; wx and wh must be
// 16-byte aligned (the bulk copies; each stream's slice then is).
// x_is_bf16 selects a bfloat16 x; everything else is float32.  Launches
// nothing at S = 0 or B = 0 (the caller zeroes the weight gradients).
int lstm_sequence_backward(const void* x, const void* gates,
                           const void* c_seq, const void* h_seq,
                           const void* wx, const void* wh, const void* dh,
                           const void* dc, void* dx, void* part, void* dwx,
                           void* dwh, void* db, int S, int B, int T, int F,
                           int H, int x_is_bf16, void* stream) {
  if (S <= 0 || B <= 0) return 0;
  if (S > 65535 || T < 1 || F < 1 || H < 1 || 4 * H > kMaxThreads)
    return cudaErrorInvalidValue;
  if (!lstm::aligned16(wx) || !lstm::aligned16(wh))
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // S = 1 takes the instances without stream offsets
  auto run = S > 1 ? (x_is_bf16 ? launch<__nv_bfloat16, true>
                                : launch<float, true>)
                   : (x_is_bf16 ? launch<__nv_bfloat16, false>
                                : launch<float, false>);
  const cudaError_t err = run(x, gates, c_seq, h_seq, wx, wh, dh, dc, dx,
                              part, dwx, dwh, db, S, B, T, F, H, s);
  return static_cast<int>(err);
}

}  // extern "C"
