// LLR updates and tree-index helpers shared by the per-codeword routines of
// the kernels (scl_subtree.cuh, sc_subtree.cuh, bp.cuh). Each routine is
// __host__ __device__ code: nvcc builds it for the card, g++ for the CPU
// tests. Mirrors polar_torch/ops/fg.py.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define PT_HD __host__ __device__
#define PT_INLINE __forceinline__
#else
#define PT_HD
#define PT_INLINE inline
#endif

namespace polar_torch {

// trailing zeros of i != 0
PT_HD PT_INLINE int ctz(int i) {
#ifdef __CUDA_ARCH__
  return __ffs(i) - 1;
#else
  return __builtin_ctz((unsigned)i);
#endif
}

// trailing ones of i (i != -1)
PT_HD PT_INLINE int cto(int i) { return ctz(~i); }

PT_HD PT_INLINE float clipf(float x, float m) { return fminf(fmaxf(x, -m), m); }

// log(1 + e^x)
PT_HD PT_INLINE float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

PT_HD PT_INLINE float logaddexp(float x, float y) {
  return fmaxf(x, y) + log1pf(expf(-fabsf(x - y)));
}

PT_HD PT_INLINE float sgn(float x) { return (float)((x > 0.0f) - (x < 0.0f)); }

// min-sum check-node update after clipping to +-m, sgn(x) sgn(y)
// min(|x|, |y|) with the same bits: its magnitude is min(|x|, |y|, m); its
// sign is negative exactly when x < 0 and y < 0 differ (a product with
// sgn(0) = +0 carries the other factor's sign onto a zero), so -0.0 comes
// out where the product gives it
PT_HD PT_INLINE float minsum(float x, float y, float m) {
  const float a = fminf(fminf(fabsf(x), fabsf(y)), m);
  return (x < 0.0f) != (y < 0.0f) ? -a : a;
}

// check-node update after clipping to +-m: exact boxplus or min-sum
PT_HD PT_INLINE float f_op(float x, float y, float m, int exact) {
  if (!exact) return minsum(x, y, m);
  x = clipf(x, m);
  y = clipf(y, m);
  return logaddexp(0.0f, x + y) - logaddexp(x, y);
}

// the bits of a float and back
PT_HD PT_INLINE uint32_t f32_bits(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(x);
#else
  uint32_t u;
  memcpy(&u, &x, sizeof u);
  return u;
#endif
}

PT_HD PT_INLINE float f32_of(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float x;
  memcpy(&x, &u, sizeof x);
  return x;
#endif
}

// x rounded to the nearest bf16 value, ties to even, widened back to a
// float; a NaN becomes the quiet NaN 0x7fc0, as torch's conversion gives.
// Integer arithmetic on the bits, so nvcc and g++ round alike and no
// rounding can be contracted away.
PT_HD PT_INLINE float bf16_round(float x) {
  if (x != x) return f32_of(0x7fc00000u);
  const uint32_t u = f32_bits(x);
  return f32_of((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}

// jnp.logaddexp's formula with every op rounded to bf16 (p, q bf16 values)
PT_HD PT_INLINE float logaddexp_bf16(float p, float q) {
  const float e = bf16_round(expf(-fabsf(bf16_round(p - q))));
  return bf16_round(fmaxf(p, q) + bf16_round(log1pf(e)));
}

// the exact boxplus of f_op in bf16, one rounding per op (x, y bf16
// values, m a bf16 value)
PT_HD PT_INLINE float f_exact_bf16(float x, float y, float m) {
  x = clipf(x, m);
  y = clipf(y, m);
  return bf16_round(logaddexp_bf16(0.0f, bf16_round(x + y))
                    - logaddexp_bf16(x, y));
}

// (1 - 2u) x + y; the product is exact, so the select is bit-identical
// (and no multiply is left for the compiler to contract into an FMA)
PT_HD PT_INLINE float g_op(float x, float y, int u) { return u ? y - x : y + x; }

}  // namespace polar_torch
