// Float32 products on Hopper's TF32 tensor cores, each as three TF32
// products: v = hi + lo, hi = tf32(v), lo = tf32(v - hi) (round to
// nearest, ties away from zero: add 0x1000 to the bits and clear the low
// 13), and a b = hi.hi + hi.lo + lo.hi, the small terms first, with
// mma.sync m16n8k8 into float32 accumulators.  The dropped lo.lo and the
// roundings leave an error of a few float32 steps of |a||b| per product,
// where one TF32 product (10-bit mantissas) leaves about 2^-10.  Shared by
// the tc kernels of mamba2_ssd.cu and rwkv6_wkv.cu.
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

}  // namespace
