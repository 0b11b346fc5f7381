// Polar transform of the columns of a block of rows, with each column's
// bits packed into 32-bit words. Shared by the CUDA kernel (butterfly.cu,
// nvcc for sm_90a) and a host build (butterfly_host.cpp, g++) that the CPU
// tests hold against the plain PyTorch version.
//
// Contract (polar_torch/models/polar/cuda_butterfly.py, butterfly_rows):
// x [m, w, C] int32 or int8, w = 2^b (1 <= b <= kBflyMaxB), unit stride
// along C; u [m, w, C] int8 is the polar transform along w of bit 0 of x,
// u[j, i, c] = XOR of (x[j, r, c] & 1) over the rows r with r & i == i:
// bit for bit polar_transform(x.to(int8) & 1, axis=1). Only bit 0 of an
// element is read.
//
// A column's rows are cut into Q = w / R slices of R = min(w, kBflyRows)
// rows; on the card one thread takes one slice of one column. A slice's
// bits go into K = max(R / 32, 1) words, row 32 k + i of the slice at bit
// i of word k, and its R-row transform runs on the words: a stage of span
// 2^s < 32 rows inside every word (a shift, a mask, an XOR), a stage of
// span >= 32 rows between words. The transform of w rows is that of R rows
// in each slice, then of Q slices: slice q's words XOR those of every
// slice p whose index holds q's bits (p & q == q), read as they stood
// before. The word arrays are indexed only by unrolled loop counters, so
// the card keeps them in registers.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "fg.cuh"

namespace polar_torch {

constexpr int kBflyMaxB = 12;
constexpr int kBflyRows = 128;        // rows of a slice: 4 words

// rows of a slice and slices of a column at w = 2^b
PT_HD PT_INLINE int bfly_slice_rows(int b) {
  return (1 << b) < kBflyRows ? 1 << b : kBflyRows;
}
PT_HD PT_INLINE int bfly_slices(int b) { return (1 << b) / bfly_slice_rows(b); }

// columns of a block on the card: 256 threads a block, 512 at 32 slices
PT_HD PT_INLINE int bfly_block_columns(int slices) {
  return slices <= 16 ? 256 / slices : 16;
}

// the bits of a word whose row has bit s clear (s < 5): stage s XORs into
// each of them the bit 2^s rows above
PT_HD PT_INLINE uint32_t bfly_word_mask(int s) {
  return s == 0 ? 0x55555555u
       : s == 1 ? 0x33333333u
       : s == 2 ? 0x0f0f0f0fu
       : s == 3 ? 0x00ff00ffu
                : 0x0000ffffu;
}

// the stages of span 2^s < per inside a word that holds per rows (row i
// at bit i; the bits from per up are 0)
PT_HD PT_INLINE uint32_t bfly_word_stages(uint32_t w, int per) {
#pragma unroll
  for (int s = 0; s < 5; ++s)
    if ((1 << s) < per) w ^= (w >> (1 << s)) & bfly_word_mask(s);
  return w;
}

// the stages between K words of 32 rows each (word k: rows 32 k .. 32 k +
// 31), spans 32 .. 16 K
template <int K>
PT_HD PT_INLINE void bfly_words_stages(uint32_t (&word)[K]) {
#pragma unroll
  for (int h = 1; h < K; h <<= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (!(k & h)) word[k] ^= word[k + h];
  }
}

// bit 0 of an element; each is read and each output written once, so the
// card streams them (evict first)
template <typename T>
PT_HD PT_INLINE uint32_t bfly_load_bit(const T* p) {
#ifdef __CUDA_ARCH__
  return (uint32_t)__ldcs(p) & 1u;
#else
  return (uint32_t)*p & 1u;
#endif
}

PT_HD PT_INLINE void bfly_store_bit(int8_t* p, uint32_t bit) {
#ifdef __CUDA_ARCH__
  __stcs(reinterpret_cast<signed char*>(p), (signed char)bit);
#else
  *p = (int8_t)bit;
#endif
}

// the R-row transform of one slice of one column: x points at its first
// row, rows lie x_row_stride elements apart
template <typename T, int K>
PT_HD PT_INLINE void bfly_slice(const T* x, long long x_row_stride, int R,
                                uint32_t (&word)[K]) {
  const int per = R < 32 ? R : 32;    // rows a word holds
#pragma unroll
  for (int k = 0; k < K; ++k) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (i < per)
        acc |= bfly_load_bit(x + (long long)(32 * k + i) * x_row_stride) << i;
    word[k] = acc;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) word[k] = bfly_word_stages(word[k], per);
  bfly_words_stages<K>(word);
}

// slice q's words after the transform across the Q slices of a column:
// slices[p * slice_stride + k * word_stride] is slice p's word k before it
template <int K>
PT_HD PT_INLINE void bfly_across(int q, int Q, const uint32_t* slices,
                                 int slice_stride, int word_stride,
                                 uint32_t (&word)[K]) {
  for (int p = q + 1; p < Q; ++p)
    if ((p & q) == q) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        word[k] ^= slices[p * slice_stride + k * word_stride];
    }
}

// the decisions of one slice of one column: u points at its first row,
// rows lie C elements apart
template <int K>
PT_HD PT_INLINE void bfly_store_slice(const uint32_t (&word)[K], int R,
                                      int8_t* u, long long C) {
  const int per = R < 32 ? R : 32;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (i < per) bfly_store_bit(u + (long long)(32 * k + i) * C,
                                  (word[k] >> i) & 1u);
  }
}

// f(T{}, std::integral_constant<int, K>{}) for the input's element type
// (in_bytes 4: int32, 1: int8) and b; 1 (cudaErrorInvalidValue) for any
// other
template <typename T, typename F>
int bfly_dispatch_k(int b, F f) {
  const int R = bfly_slice_rows(b);
  switch (R <= 32 ? 1 : R / 32) {
    case 1: return f(T{}, std::integral_constant<int, 1>{});
    case 2: return f(T{}, std::integral_constant<int, 2>{});
    case 4: return f(T{}, std::integral_constant<int, 4>{});
    default: return 1;
  }
}

template <typename F>
int bfly_dispatch(int in_bytes, int b, F f) {
  if (b < 1 || b > kBflyMaxB) return 1;
  if (in_bytes == 4) return bfly_dispatch_k<int32_t>(b, f);
  if (in_bytes == 1) return bfly_dispatch_k<int8_t>(b, f);
  return 1;
}

}  // namespace polar_torch
