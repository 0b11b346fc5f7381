// The probe kernels' arithmetic, one routine per probe over one column,
// shared by the card's kernels (probes.cu) and the host build that the CPU
// tests run (probes_host.cpp). Each routine is __host__ __device__ code:
// nvcc builds it for the card, g++ for the CPU. Mirrors the plain versions
// in polar_torch/probes.py, which round as the JAX package's Pallas probes
// (benchmarks/probe_r4.py) do on the CPU.
//
// A column of an f32 probe is 64 rows (k_big's scratch 1,024), strided by
// the row length ld; a bf16 or int8 column is the tensor's rows. bf16
// values travel as their 16 bits (uint16_t).
#pragma once

#include "fg.cuh"

namespace polar_torch {

// the probes, in the order of the script's variants; the ids of the C ABI
enum ProbeId {
  kProbeFori = 0,
  kProbeBcast,
  kProbeRoll,
  kProbeReduce,
  kProbeShift,
  kProbeScratchFori,
  kProbeSweepCombo,
  kProbeBigSweep,
  kProbeBigSweepNoLoop,
  kProbeArith,
  kProbeGather,
  kProbeInt8,
  kProbeCount
};

constexpr int kProbeRows = 64;        // rows of an f32 probe's block
constexpr int kProbeBlockCols = 128;  // columns of a TPU grid step's block
constexpr int kProbeBigRows = 1024;   // k_big's scratch rows
constexpr int kProbeBigStages = 8;    // k_big's stages a sweep
constexpr int kProbeComboStages = 3;  // k_sweepcombo's stages a sweep
constexpr int kProbeComboSweeps = 4;  // k_sweepcombo's fori_loop count
constexpr int kProbeLoopSweeps = 4;   // bigsweep's fori_loop count
constexpr int kProbeFoldCount = 5;    // k_fori's and k_scratchfori's loops

// jnp.sign: +-1, and x itself at +-0 and NaN (torch.sign gives +0 there)
PT_HD PT_INLINE float probe_sign(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// jnp.minimum: a NaN on either side propagates (fminf drops it)
PT_HD PT_INLINE float probe_min(float x, float y) {
  return (x != x || x < y) ? x : y;
}

// min(|a|, |p|) sign(a) sign(p), multiplied in the probes' order. Both
// factors are +-1 or +-0, so the products are exact and the value is
// symmetric in a and p, sign bits included (a product's sign is the XOR of
// its factors').
PT_HD PT_INLINE float probe_minsum(float a, float p) {
  return probe_min(fabsf(a), fabsf(p)) * probe_sign(a) * probe_sign(p);
}

// One stage-s update of pair p (0 <= p < rows / 2) of a column: row r, the
// p-th row whose bit s is 0, and its partner r + 2^s, which therefore never
// wraps. The probes give row r the partner r + 2^s and row r + 2^s the
// partner r, and both the same value, so the pair is updated in place with
// no copy of the scratch.
PT_HD PT_INLINE void probe_pair(float* col, int ld, int s, int p) {
  const int d = 1 << s;
  const int r = ((p >> s) << (s + 1)) | (p & (d - 1));
  float* a = col + r * ld;
  float* q = a + d * ld;
  const float m = probe_minsum(*a, *q);
  *a = m;
  *q = m;
}

// One f32 probe over a column: x and o point at its row 0, rows ld apart.
// The 64 values sit in a local array (the card's registers: every index is
// a constant once the loops unroll).
template <int P>
PT_HD PT_INLINE void probe_column(const float* x, float* o, int ld) {
  float v[kProbeRows];
#pragma unroll
  for (int r = 0; r < kProbeRows; ++r) v[r] = x[r * ld];
  if constexpr (P == kProbeFori) {
    // o = x, then o + x five times, in order (6 x rounds differently)
#pragma unroll
    for (int r = 0; r < kProbeRows; ++r) {
      float acc = v[r];
      for (int i = 0; i < kProbeFoldCount; ++i) acc = acc + v[r];
      o[r * ld] = acc;
    }
  } else if constexpr (P == kProbeBcast) {
#pragma unroll
    for (int r = 0; r < kProbeRows; ++r) o[r * ld] = v[r] * 2.0f;
  } else if constexpr (P == kProbeRoll) {
#pragma unroll
    for (int r = 0; r < kProbeRows; ++r)
      o[r * ld] = v[(r + 8) % kProbeRows] + v[r];
  } else if constexpr (P == kProbeReduce) {
    float m = v[0];
#pragma unroll
    for (int r = 1; r < kProbeRows; ++r) m = probe_min(m, v[r]);
#pragma unroll
    for (int r = 0; r < kProbeRows; ++r) o[r * ld] = m;
  } else if constexpr (P == kProbeShift) {
#pragma unroll
    for (int r = 0; r < kProbeRows; ++r) {
      float acc = v[r];
      for (int s = 0; s < 3; ++s)
        acc = (r >> s) & 1 ? acc - v[r] : acc + v[r];
      o[r * ld] = acc;
    }
  } else if constexpr (P == kProbeScratchFori) {
    // XLA fuses scr * 1.5 + x into one rounding on the CPU: fmaf
#pragma unroll
    for (int r = 0; r < kProbeRows; ++r) {
      float acc = v[r];
      for (int i = 0; i < kProbeFoldCount; ++i) acc = fmaf(acc, 1.5f, v[r]);
      o[r * ld] = acc;
    }
  } else if constexpr (P == kProbeSweepCombo) {
    for (int i = 0; i < kProbeComboSweeps; ++i) {
#pragma unroll
      for (int s = 0; s < kProbeComboStages; ++s) {
#pragma unroll
        for (int p = 0; p < kProbeRows / 2; ++p) probe_pair(v, 1, s, p);
      }
    }
#pragma unroll
    for (int r = 0; r < kProbeRows; ++r) o[r * ld] = v[r];
  }
}

// k_big's scratch row r: row r mod 64 of the block (the block tiled 16
// times)
PT_HD PT_INLINE float probe_big_fill(const float* x, int ld, int r) {
  return x[(r % kProbeRows) * ld];
}

// k_big over one column on the host: fill the 1,024-row scratch col,
// sweep it `sweeps` times over stages 0..7, write its rows 0..63 to o
inline void probe_big_column(const float* x, float* o, int ld, float* col,
                             int sweeps) {
  for (int r = 0; r < kProbeBigRows; ++r) col[r] = probe_big_fill(x, ld, r);
  for (int i = 0; i < sweeps; ++i)
    for (int s = 0; s < kProbeBigStages; ++s)
      for (int p = 0; p < kProbeBigRows / 2; ++p) probe_pair(col, 1, s, p);
  for (int r = 0; r < kProbeRows; ++r) o[r * ld] = col[r];
}

PT_HD PT_INLINE float bf16_to_f32(uint16_t h) {
  return f32_of((uint32_t)h << 16);
}

// f rounded to bf16 (fg.cuh bf16_round), as its 16 bits
PT_HD PT_INLINE uint16_t f32_to_bf16(float f) {
  return (uint16_t)(f32_bits(bf16_round(f)) >> 16);
}

// k_arith over a column of `rows` bf16 values: min(|x|, 2) sign(x) + x.
// The product is exact (a factor of +-1), so computing in f32 and rounding
// the sum once gives the bf16 op-by-op result, contracted or not.
PT_HD PT_INLINE void probe_arith_column(const uint16_t* x, uint16_t* o,
                                        int rows, int ld) {
  for (int r = 0; r < rows; ++r) {
    const float f = bf16_to_f32(x[r * ld]);
    o[r * ld] = f32_to_bf16(probe_min(fabsf(f), 2.0f) * probe_sign(f) + f);
  }
}

// k_gather over a column: o[r] = x[p[r]] (take_along_axis on axis 0); the
// pointers must lie in [0, rows of x), which is not checked
PT_HD PT_INLINE void probe_gather_column(const uint16_t* x, const int32_t* p,
                                         uint16_t* o, int rows, int ld) {
  for (int r = 0; r < rows; ++r) o[r * ld] = x[p[r * ld] * ld];
}

// k_i8 over a column: where(x > 0, x, -x) + 1, wrapping as int8 does
PT_HD PT_INLINE void probe_int8_column(const int8_t* x, int8_t* o, int rows,
                                       int ld) {
  for (int r = 0; r < rows; ++r) {
    const int8_t v = x[r * ld];
    const int8_t a = v > 0 ? v : (int8_t)(-v);
    o[r * ld] = (int8_t)(a + 1);
  }
}

}  // namespace polar_torch
