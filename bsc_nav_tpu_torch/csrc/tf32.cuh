// The split of the three-pass TF32 product, shared by the f32 paths on the
// tensor cores: the attention tile of K1, K3, K5 and K6
// (attention_tf32.cuh) and K8's implicit GEMM (conv3x3_s1.cu).  Every
// product of two f32 operands a, b is taken as three TF32 products,
//   a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi   (small terms first),
//   a_hi = rna(a), a_lo = rna(a - a_hi),
// summed in f32.  rna rounds to TF32's 10-bit mantissa, to nearest with
// ties away from zero, on the bits: (bits + 2^12) with the low 13 bits
// cleared, i.e. cvt.rna.tf32.f32 with its don't-care bits cleared, so
// every operand reaches the tensor cores with those 13 bits zero and how
// they would treat raw f32 (truncation) never matters.  The split leaves
// |a - a_hi - a_lo| <= 2^-22 |a| and drops a_lo b_lo (<= 2^-22 |a b|):
// plain f32's error, where one TF32 product has 2^-11.  The tensor cores
// truncate each sum they accumulate, so the callers add a short run of
// products into a zeroed accumulator and that into the result in f32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tc {

// f32 rounded to TF32 (10-bit mantissa), to nearest, ties away from zero;
// the low 13 bits cleared
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|), both TF32
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

}  // namespace tc
}  // namespace
