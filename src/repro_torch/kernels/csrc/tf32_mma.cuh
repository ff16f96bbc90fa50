// Warp-level tensor-core products in three-pass TF32 (3xTF32), sm_80 and
// later: the products of the chunked selective scan (ssm_scan/csrc/
// ssm_chunked.cu) and of the chunked WKV scan (rwkv6_scan/csrc/
// rwkv6_chunked.cu).  Every library's build includes this directory and
// hashes its headers (kernels/_build.py).
//
// mma.sync m16n8k8 with tf32 operands multiplies a 16x8 tile of A by an 8x8
// tile of B into a 16x8 float32 accumulator held by the 32 lanes of a warp.
// TF32 keeps 10 of float32's 23 mantissa bits, too few for the port's 1e-4:
// each operand v is split as v = hi + lo (hi = v rounded to TF32, lo the
// rest, exact in float32), and a product is a_lo b_hi + a_hi b_lo + a_hi b_hi
// into the same float32 accumulator (the a_lo b_lo term, ~2^-22 of the
// product, is dropped).  hi is rounded with two integer instructions (a half
// unit added to the bits, the low 13 cleared: to nearest, ties away from
// zero), not cvt.rna.tf32.f32, which issues at a quarter of their rate and
// took most of the time of the selective scan's products; lo goes to the
// tensor core as float32 bits, whose low 13 it ignores (rounds toward
// zero), as CUTLASS's fast 3xTF32 passes it.  kernels/_fp.py: matmul(...,
// "tf32x3") rounds the same way on the CPU.
//
// Fragments, lane = 4 g + q (g = lane / 4, q = lane % 4), as PTX lays out
// m16n8k8 .tf32:
//   A (16 x 8, row r, column k): a0 (g, q), a1 (g+8, q), a2 (g, q+4),
//                                a3 (g+8, q+4)
//   B (8 x 8, row k, column n):  b0 (q, g), b1 (q+4, g)
//   C (16 x 8, row r, column n): c0 (g, 2q), c1 (g, 2q+1), c2 (g+8, 2q),
//                                c3 (g+8, 2q+1)
// The loaders take an element's address as base + r*rs + k*ks (A) or
// base + k*ks + n*ns (B), so one loader reads a tile stored either way.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// v = hi + lo: hi rounded to TF32 (to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds), lo = v - hi exact, its low 13 bits left for the
// tensor core to drop
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// The A fragment's four raw values at rows (g, g+8), columns (q, q+4).
__device__ __forceinline__ void load_a(const float* base, int rs, int ks,
                                       int g, int q, float (&v)[4]) {
  v[0] = base[g * rs + q * ks];
  v[1] = base[(g + 8) * rs + q * ks];
  v[2] = base[g * rs + (q + 4) * ks];
  v[3] = base[(g + 8) * rs + (q + 4) * ks];
}

__device__ __forceinline__ FragA split_a(const float (&v)[4]) {
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(v[i], f.hi[i], f.lo[i]);
  return f;
}

// The B fragment at rows (q, q+4), column g, split.
__device__ __forceinline__ FragB load_b(const float* base, int ks, int ns,
                                        int g, int q) {
  FragB f;
  split_tf32(base[q * ks + g * ns], f.hi[0], f.lo[0]);
  split_tf32(base[(q + 4) * ks + g * ns], f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[j] += a b[j] in 3xTF32 for J tiles side by side: the small terms
// first, each pass over the J independent accumulators, so that J products
// are in flight where one tile's three would wait on each other
template <int J>
__device__ __forceinline__ void mma_3xtf32(float (&d)[J][4], const FragA& a,
                                           const FragB (&b)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) mma_tf32(d[j], a.lo, b[j].hi);
#pragma unroll
  for (int j = 0; j < J; ++j) mma_tf32(d[j], a.hi, b[j].lo);
#pragma unroll
  for (int j = 0; j < J; ++j) mma_tf32(d[j], a.hi, b[j].hi);
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace tf32x3
