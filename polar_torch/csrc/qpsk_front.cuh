// The plain polar transmitter over QPSK and AWGN: a codeword's bits stay
// in 32-bit words from the scatter of its info bits to its LLRs. Shared by
// the CUDA kernel (qpsk_front.cu, nvcc for sm_90a) and a host build
// (qpsk_front_host.cpp, g++) that the CPU tests hold against the composed
// PyTorch chain.
//
// Contract (polar_torch/models/polar/cuda_front.py, qpsk_front):
// u [bs, k] f32 info bits (0 or 1; a bit is u != 0); table [n] int16, where
// position p carries u[:, table[p]] if table[p] < k and is frozen (0)
// otherwise; xr, xi [bs, n / 2] f32 the real and imaginary noise draws.
// cw [bs, n] f32 is the polar transform of the scattered bits, and
// llr [bs, n] f32 the exact QPSK LLRs (positive means 1): bit 2j of a
// codeword on the real axis of its symbol j with draw xr[j], bit 2j + 1 on
// the imaginary axis with xi[j], each
//   x = (1 - 2 c) a,  y = x + (s2 r) sqrt_no,  llr = scale y,
// every product and sum rounded to f32 on its own (no fused multiply-add),
// as the composed chain's Mapper, AWGN and Demapper round them.
//
// Layout: n = 2^m, 1 <= m <= kQfMaxM. A word holds per = min(n, 32)
// positions of one codeword, position 32 q + i at bit i of the codeword's
// word q. A warp takes a tile of 32 K words (K = max(n / 1024, 1)) that lie
// one after another in cw: tile word w = 32 s + l sits in lane l, slot s,
// and tile t covers cw's flat bits [t * 32 K per, (t + 1) * 32 K per),
// which is 1024 / n codewords at 32 <= n <= 1024, 32 below and one above.
// The transform's stages of span < per run inside each word (a shift, a
// mask, an XOR: butterfly.cuh), those between a lane's slots inside the
// lane, the rest between lanes. The word arrays are indexed only by
// unrolled loop counters, so the card keeps them in registers.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "butterfly.cuh"

namespace polar_torch {

constexpr int kQfMaxM = 12;

// the scalars of the arithmetic, computed on the host as the composed
// chain computes them: a the QPSK amplitude, s2 = sqrt(0.5), sqrt_no =
// sqrt(N0), scale = -4 sqrt(0.5) / N0
struct QfScalars {
  float a, s2, sqrt_no, scale;
};

// the layout at n = 2^m: bits a word, words and lanes a codeword, a lane's
// slots (K), the bits of a lane's chunk (V) and the codewords of a tile
PT_HD constexpr int qf_per(int m) { return m < 5 ? 1 << m : 32; }
PT_HD constexpr int qf_words(int m) { return m < 5 ? 1 : 1 << (m - 5); }
PT_HD constexpr int qf_lanes(int m) {
  return qf_words(m) < 32 ? qf_words(m) : 32;
}
PT_HD constexpr int qf_slots(int m) { return m <= 10 ? 1 : 1 << (m - 10); }
PT_HD constexpr int qf_chunk(int m) { return m == 1 ? 2 : 4; }
PT_HD constexpr int qf_tile_codewords(int m) {
  return (32 * qf_slots(m) * qf_per(m)) >> m;
}

// bit i of tile word w of tile t: the info bit that position 32 q + i of
// its codeword (q = w mod words) carries; 0 where it is frozen, where the
// codeword lies past the batch, and from per up
template <int M>
PT_HD PT_INLINE uint32_t qf_info_bit(const float* u, const int16_t* table,
                                     long long bs, int k, long long t, int w,
                                     int i) {
  const long long c = t * qf_tile_codewords(M) + w / qf_words(M);
  if (i >= qf_per(M) || c >= bs) return 0;
  const int j = table[(w % qf_words(M)) * 32 + i];
  if (j >= k) return 0;
#ifdef __CUDA_ARCH__
  return __ldg(u + c * k + j) != 0.0f;
#else
  return u[c * k + j] != 0.0f;
#endif
}

PT_HD PT_INLINE float qf_mul(float x, float y) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(x, y);
#else
  return x * y;
#endif
}

PT_HD PT_INLINE float qf_add(float x, float y) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(x, y);
#else
  return x + y;
#endif
}

// the LLR of codeword bit c sent on an axis whose noise draw is r
PT_HD PT_INLINE float qf_llr(uint32_t c, float r, const QfScalars& s) {
  const float x = c ? -s.a : s.a;
  return qf_mul(s.scale, qf_add(x, qf_mul(qf_mul(s.s2, r), s.sqrt_no)));
}

// lane i's V bits of chunk h of a slot start at this bit of the slot's
// 32 words; they lie in one word
PT_HD PT_INLINE int qf_chunk_offset(int h, int i, int V) {
  return h * 32 * V + i * V;
}

// cw and llr at flat bits f .. f + V - 1 (f a multiple of V) from the V
// codeword bits in `bits` (bit j at f + j) and the draws of symbols f / 2 ..
template <int V>
PT_HD PT_INLINE void qf_emit(uint32_t bits, long long f, const float* xr,
                             const float* xi, float* cw, float* llr,
                             const QfScalars& s) {
#ifdef __CUDA_ARCH__
  if constexpr (V == 4) {
    // two symbols: 8 bytes of each draw, 16 of each output
    const float2 r = __ldcs(reinterpret_cast<const float2*>(xr + f / 2));
    const float2 q = __ldcs(reinterpret_cast<const float2*>(xi + f / 2));
    const uint32_t b0 = bits & 1u, b1 = bits >> 1 & 1u, b2 = bits >> 2 & 1u,
                   b3 = bits >> 3 & 1u;
    __stcs(reinterpret_cast<float4*>(cw + f),
           make_float4((float)b0, (float)b1, (float)b2, (float)b3));
    __stcs(reinterpret_cast<float4*>(llr + f),
           make_float4(qf_llr(b0, r.x, s), qf_llr(b1, q.x, s),
                       qf_llr(b2, r.y, s), qf_llr(b3, q.y, s)));
    return;
  }
#endif
  for (int j = 0; j < V; ++j) {
    const uint32_t c = bits >> j & 1u;
    cw[f + j] = (float)c;
    llr[f + j] = qf_llr(c, (j & 1 ? xi : xr)[f / 2 + j / 2], s);
  }
}

// f(std::integral_constant<int, m>{}) for 1 <= m <= kQfMaxM; 1
// (cudaErrorInvalidValue) for any other m
template <typename F>
int qf_dispatch(int m, F f) {
  using std::integral_constant;
  switch (m) {
    case 1: return f(integral_constant<int, 1>{});
    case 2: return f(integral_constant<int, 2>{});
    case 3: return f(integral_constant<int, 3>{});
    case 4: return f(integral_constant<int, 4>{});
    case 5: return f(integral_constant<int, 5>{});
    case 6: return f(integral_constant<int, 6>{});
    case 7: return f(integral_constant<int, 7>{});
    case 8: return f(integral_constant<int, 8>{});
    case 9: return f(integral_constant<int, 9>{});
    case 10: return f(integral_constant<int, 10>{});
    case 11: return f(integral_constant<int, 11>{});
    case 12: return f(integral_constant<int, 12>{});
    default: return 1;
  }
}

}  // namespace polar_torch
