// Packed bf16x2 arithmetic with explicit round-to-nearest-even, for the
// bf16 depthwise chain (B11, conv_fwd_wide.cuh) and the probe P1
// (probe_bf16.cu). PTX mul/add without a rounding modifier may be fused into
// an fma by ptxas; the `.rn` forms are never contracted, so each product and
// each sum is rounded once, as the JAX reference rounds each bf16 operation.
// Two bf16 values travel in one 32-bit register, the first in the low half.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace dbfr {

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint16_t bf16_bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)bf16_bits(lo) | ((uint32_t)bf16_bits(hi) << 16);
}

// f32 -> bf16 bits, round to nearest even
__device__ __forceinline__ uint16_t to_bf16_bits(float v) {
  return bf16_bits(__float2bfloat16_rn(v));
}

// the f32 value of the low / high bf16 half
__device__ __forceinline__ float lo_f32(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f32(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

}  // namespace dbfr
