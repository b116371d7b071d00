// Split-fp32 (3xTF32) products on Hopper's tensor cores; shared by
// chimera_attention.cu and window_attention.cu.
//
// An fp32 product a b runs as three TF32 mma.sync: a = a_hi + a_lo and
// b = b_hi + b_lo, both halves TF32, and a_lo b_hi + a_hi b_lo + a_hi b_hi is
// summed in fp32, the small products first.  One TF32 pass keeps about three
// decimal digits, which is beyond the fp32 tolerance the kernels are held to;
// the split keeps about 21 bits of each operand and stays within it.  The
// tensor cores truncate when they sum, so a kernel adds each tile's products
// into a fresh accumulator and that into its running sum with fp32 adds.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace split_fp32 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

struct Split {
  uint32_t hi, lo;
};
// x = hi + lo, hi the TF32 value of x's top 11 significant bits (its low
// 13 mantissa bits cleared) and lo = x - hi, exact in fp32.  The tensor
// cores read lo's top 11 bits, so a product keeps about 21 bits of each
// operand.  Two instructions; rounding hi to nearest (Veltkamp's split, or
// cvt.rna.tf32.f32) costs four and measured slower on an H100.
__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = __float_as_uint(x) & 0xFFFFE000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

// The rounding split: hi is x rounded to the nearest TF32 value (on the
// magnitude's bit pattern, halves away from zero) and lo = x - hi, exact in
// fp32, rounded to TF32 too, so the tensor cores read both as they are.  A
// product then errs by about 3 * 2^-24 of |a b| (the truncating split's
// 3 * 2^-22), for two more integer instructions per operand: for products
// of large running sums, such as a stream state against its features.
__device__ __forceinline__ Split split_rn(float x) {
  const uint32_t hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  const uint32_t lo = __float_as_uint(x - __uint_as_float(hi));
  return {hi, (lo + 0x1000u) & 0xFFFFE000u};
}

template <bool RN>
__device__ __forceinline__ Split split_as(float x) {
  return RN ? split_rn(x) : split(x);
}

template <bool RN = false>
__device__ __forceinline__ void split4(const float a[4], uint32_t hi[4], uint32_t lo[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split s = split_as<RN>(a[i]);
    hi[i] = s.hi;
    lo[i] = s.lo;
  }
}

// c += a b on the tensor cores (m16n8k8, TF32 operands, fp32 accumulator)
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[j] += a b_j in split fp32 for the n-tiles j < n (of N): the small
// products first, each pass over all n-tiles so that consecutive mma.sync
// are independent.  a is 16 x 8 (a0 (g, t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4)); b_j is 8 x 8 with b0 (t, g) = bv[j][0], b1 (t+4, g) =
// bv[j][1]; c is 16 x 8 (c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
// c3 (g+8, 2t+1)); g = lane / 4, t = lane % 4.  RN: b split by split_rn.
template <int N, bool RN = false>
__device__ __forceinline__ void mma3_n(float (*c)[4], const uint32_t ahi[4], const uint32_t alo[4],
                                       const float (*bv)[2], int n = N) {
  uint32_t bh[N][2], bl[N][2];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j < n) {
      const Split s0 = split_as<RN>(bv[j][0]), s1 = split_as<RN>(bv[j][1]);
      bh[j][0] = s0.hi; bh[j][1] = s1.hi; bl[j][0] = s0.lo; bl[j][1] = s1.lo;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < n) mma(c[j], alo, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < n) mma(c[j], ahi, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < n) mma(c[j], ahi, bh[j][0], bh[j][1]);
}
}  // namespace split_fp32
