// Float32 products on Hopper's TF32 tensor cores, each as three TF32
// products: v = hi + lo, hi = tf32(v), lo = tf32(v - hi) (round to
// nearest, ties away from zero: add 0x1000 to the bits and clear the low
// 13), and a b = hi.hi + hi.lo + lo.hi, the small terms first, with
// mma.sync m16n8k8 into float32 accumulators.  The dropped lo.lo and the
// roundings leave an error of a few float32 steps of |a||b| per product,
// where one TF32 product (10-bit mantissas) leaves about 2^-10.  Shared by
// the tc kernels of mamba2_ssd.cu, rwkv6_wkv.cu, mamba2_ssd_bwd_tc.cu and
// rwkv6_wkv_bwd_tc.cu; the fragment loads and mma3_rn below by the two
// backward ones.
#pragma once

#include <cstdint>

namespace {

// v as hi + lo, both TF32 (rounded to nearest, ties away from zero)
__device__ __forceinline__ uint32_t tf32_bits(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(v);
  lo = tf32_bits(v - __uint_as_float(hi));
}

__device__ __forceinline__ void frag_a(FragA& f, float a0, float a1,
                                       float a2, float a3) {
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
}

__device__ __forceinline__ void frag_b(FragB& f, float b0, float b1) {
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b as three TF32 products, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// acc += a b as three TF32 products, each k step's hi.hi and its two small
// terms summed from zero on the tensor cores and added to acc in float32
// with round to nearest (the tensor cores' own accumulation rounds toward
// zero: mamba2_ssd_bwd_tc.cu)
__device__ __forceinline__ void mma3_rn(float (&acc)[4], const FragA& a,
                                        const FragB& b) {
  float big[4] = {0.f, 0.f, 0.f, 0.f};
  float small[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(small, a.lo, b.hi);
  mma_tf32(small, a.hi, b.lo);
  mma_tf32(big, a.hi, b.hi);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += big[e] + small[e];
}

__device__ __forceinline__ void zero(float (&acc)[4]) {
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
}

// Fragments of mma.sync m16n8k8 (g = lane / 4, q = lane % 4), k read as
// 2q and 2q + 1: A (row r, k) at (g, 2q), (g + 8, 2q), (g, 2q + 1),
// (g + 8, 2q + 1); B (k, col) at (2q, g), (2q + 1, g); the accumulator
// (g, 2q), (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1).  A pair along a
// row is one 8-byte load.
//
// A read along its rows (row-major, row stride `ld`), rows r0 ..
__device__ __forceinline__ void frag_rows(FragA& f, const float* m, int ld,
                                          int r0, int k0, int g, int q) {
  const float2 u =
      *reinterpret_cast<const float2*>(m + (r0 + g) * ld + k0 + 2 * q);
  const float2 v =
      *reinterpret_cast<const float2*>(m + (r0 + g + 8) * ld + k0 + 2 * q);
  frag_a(f, u.x, v.x, u.y, v.y);
}

// A read down the columns of a row-major m: A(r, k) = m[k][r]
__device__ __forceinline__ void frag_cols(FragA& f, const float* m, int ld,
                                          int r0, int k0, int g, int q) {
  const float* p = m + (k0 + 2 * q) * ld + r0 + g;
  frag_a(f, p[0], p[8], p[ld], p[ld + 8]);
}

// B(k, col) = m[k][col] of a row-major m
__device__ __forceinline__ void frag_kmajor(FragB& f, const float* m, int ld,
                                            int k0, int c0, int g, int q) {
  const float* p = m + (k0 + 2 * q) * ld + c0 + g;
  frag_b(f, p[0], p[ld]);
}

// B(k, col) = m[col][k] of a row-major m
__device__ __forceinline__ void frag_nmajor(FragB& f, const float* m, int ld,
                                            int k0, int c0, int g, int q) {
  const float2 u =
      *reinterpret_cast<const float2*>(m + (c0 + g) * ld + k0 + 2 * q);
  frag_b(f, u.x, u.y);
}

}  // namespace
