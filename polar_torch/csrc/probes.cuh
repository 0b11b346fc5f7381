// The probe kernels' arithmetic, one routine per probe over one column
// (k_reduce and k_gather: over a thread's share of a CTA's slab, below),
// shared by the card's kernels (probes.cu) and the host build that the CPU
// tests run (probes_host.cpp), which runs the card's order. Each routine
// is __host__ __device__ code: nvcc builds it for the card, g++ for the
// CPU. Mirrors the plain versions in polar_torch/probes.py, which round as
// the JAX package's Pallas probes (benchmarks/probe_r4.py) do on the CPU.
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

// jnp.minimum of two operands of clear sign (|a|, |p|, a positive
// constant) as XLA runs it on the CPU: a NaN on either side propagates,
// x's if both are NaN (fminf drops a NaN)
PT_HD PT_INLINE float probe_min_pos(float x, float y) {
  return (x != x || x < y) ? x : y;
}

// jnp.minimum, and each step of jnp.min's fold over rows, as XLA runs them
// on the CPU (LLVM's x86 lowering of llvm.minimum): with x's sign bit set
// the operands swap, then probe_min_pos. So -0 < +0, a NaN on either side
// propagates, and of two NaNs x is kept when it is a positive NaN, else
// y. A fold of it in row order (x the running minimum) returns the first
// positive NaN of a column, else its last NaN, else its least value with
// -0 below +0. The operation is associative on those terms, so minima of
// consecutive row chunks combined in row order give the fold's bits.
PT_HD PT_INLINE float probe_min(float x, float y) {
  const bool swap = f32_bits(x) >> 31;
  return swap ? probe_min_pos(y, x) : probe_min_pos(x, y);
}

// min(|a|, |p|) sign(a) sign(p), multiplied in the probes' order. Both
// factors are +-1 or +-0, so the products are exact and the value is
// symmetric in a and p, sign bits included (a product's sign is the XOR of
// its factors').
PT_HD PT_INLINE float probe_minsum(float a, float p) {
  return probe_min_pos(fabsf(a), fabsf(p)) * probe_sign(a) * probe_sign(p);
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
    const float m = probe_min_pos(fabsf(f), 2.0f);
    o[r * ld] = f32_to_bf16(m * probe_sign(f) + f);
  }
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

// ----------------------------------------------------------------------
// The 16-byte accesses of k_reduce's and k_gather's kernels: one 128-bit
// load or store on the card, a copy of 16 bytes on the host.
// ----------------------------------------------------------------------
struct alignas(16) ProbeVec {
  uint32_t w[4];
};

PT_HD PT_INLINE ProbeVec probe_load16(const void* p) {
#ifdef __CUDA_ARCH__
  const uint4 v = *static_cast<const uint4*>(p);
  return ProbeVec{{v.x, v.y, v.z, v.w}};
#else
  ProbeVec v;
  memcpy(&v, p, sizeof v);
  return v;
#endif
}

PT_HD PT_INLINE void probe_store16(void* p, const ProbeVec& v) {
#ifdef __CUDA_ARCH__
  *static_cast<uint4*>(p) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
#else
  memcpy(p, &v, sizeof v);
#endif
}

// ----------------------------------------------------------------------
// k_reduce: the column minimum of f32 [64, cols], broadcast to every row.
// A CTA takes a slab of kReduceCols columns; a thread owns 4 neighbouring
// columns of a chunk of kReduceChunk consecutive rows. Each thread reads
// its chunk in one round and folds it, the chunks' minima meet in shared
// memory, every thread folds them and writes its chunk's rows of the
// broadcast. Both folds are ordered trees (pairs of neighbours, then pairs
// of pairs, the earlier rows on the left): the row order of one fold over
// the 64 rows with a third of its depth, and since probe_min is
// associative, the same bits. The vector form (kVec: 16-byte aligned
// tensors) moves a thread's 4 columns as one 16-byte access; the other
// moves them one by one. A row is a multiple of 128 columns, so every row
// shares the tensor's alignment.
// ----------------------------------------------------------------------
constexpr int kReduceCols = 32;       // columns of a CTA's slab
constexpr int kReduceQuads = kReduceCols / 4;  // threads a chunk of rows
constexpr int kReduceChunk = 8;       // rows a thread
constexpr int kReduceChunks = kProbeRows / kReduceChunk;      // 8
constexpr int kReduceThreads = kReduceQuads * kReduceChunks;  // 64
static_assert(kReduceChunks * kReduceChunk == kProbeRows,
              "the chunks tile the 64 rows");

template <bool kVec>
PT_HD PT_INLINE ProbeVec probe_load4(const float* p) {
  if constexpr (kVec) return probe_load16(p);
  ProbeVec v;
  for (int i = 0; i < 4; ++i) v.w[i] = f32_bits(p[i]);
  return v;
}

template <bool kVec>
PT_HD PT_INLINE void probe_store4(float* p, const ProbeVec& v) {
  if constexpr (kVec) {
    probe_store16(p, v);
  } else {
    for (int i = 0; i < 4; ++i) p[i] = f32_of(v.w[i]);
  }
}

PT_HD PT_INLINE ProbeVec probe_min4(const ProbeVec& a, const ProbeVec& b) {
  ProbeVec m;
  for (int i = 0; i < 4; ++i)
    m.w[i] = f32_bits(probe_min(f32_of(a.w[i]), f32_of(b.w[i])));
  return m;
}

// The ordered tree fold of v[0..N-1] (N a power of 2), in place.
template <int N>
PT_HD PT_INLINE ProbeVec probe_min_tree(ProbeVec* v) {
  for (int step = 1; step < N; step *= 2)
    for (int i = 0; i + step < N; i += 2 * step)
      v[i] = probe_min4(v[i], v[i + step]);
  return v[0];
}

// The fold of chunk g's rows over the 4 columns at x (row 0 of the
// tensor, rows ld apart). Every load comes first.
template <bool kVec>
PT_HD PT_INLINE ProbeVec probe_reduce_chunk(const float* __restrict__ x,
                                            int ld, int g) {
  ProbeVec v[kReduceChunk];
  for (int i = 0; i < kReduceChunk; ++i)
    v[i] = probe_load4<kVec>(x + (g * kReduceChunk + i) * ld);
  return probe_min_tree<kReduceChunk>(v);
}

// The chunks' minima part[0], part[stride], ... folded in row order.
PT_HD PT_INLINE ProbeVec probe_reduce_combine(const ProbeVec* part,
                                              int stride) {
  ProbeVec v[kReduceChunks];
  for (int g = 0; g < kReduceChunks; ++g) v[g] = part[g * stride];
  return probe_min_tree<kReduceChunks>(v);
}

// Chunk g's rows of the broadcast over the 4 columns at o.
template <bool kVec>
PT_HD PT_INLINE void probe_reduce_store(float* __restrict__ o, int ld, int g,
                                        const ProbeVec& m) {
  for (int i = 0; i < kReduceChunk; ++i)
    probe_store4<kVec>(o + (g * kReduceChunk + i) * ld, m);
}

// ----------------------------------------------------------------------
// k_gather: o[r, c] = x[p[r, c], c] for bf16 x and int32 p of one shape
// [rows, cols] (take_along_axis on axis 0); the pointers must lie in
// [0, rows), which is not checked. Up to kGatherTileRows rows, a CTA
// takes a slab of 8 n8 columns (n8 = probe_gather_n8(rows)) and all rows,
// in units of 8 neighbouring columns of one row: unit u is row u / n8,
// slab columns 8 (u % n8) .. + 7. In the first round each unit's x goes to
// a shared tile [rows][8 n8] (at most 48 KiB) and its 8 pointers to
// registers; after a barrier, the second gathers the unit's outputs from
// the tile and stores them. A thread holds the pointers of its first
// kGatherUnits units; those of its later units (more than kGatherCtaUnits
// units a slab) it reads in the second round. The vector form (kVec: cols
// a multiple of 8, 16-byte aligned tensors) moves 16 bytes of x, 32 of
// pointers and 16 of output a unit; the other form moves single elements
// and masks the columns past the last. Past kGatherTileRows rows, whose
// column would not fit the tile, each output element is gathered straight
// from x (probe_gather_direct).
// ----------------------------------------------------------------------
constexpr int kGatherThreads = 256;   // threads of a CTA
constexpr int kGatherUnits = 4;       // units a thread with pointers held
constexpr int kGatherCtaUnits = kGatherThreads * kGatherUnits;  // 1,024
constexpr int kGatherMaxN8 = 32;      // a slab of at most 256 columns
constexpr int kGatherTileRows = 48 * 1024 / sizeof(ProbeVec);   // 3,072

// The slab's 8-column units a row for `rows` rows (1 <= rows <=
// kGatherTileRows): as wide as a CTA's held pointers allow, 1 to 32.
PT_HD PT_INLINE int probe_gather_n8(int rows) {
  const int n8 = kGatherCtaUnits / rows;
  return n8 < 1 ? 1 : (n8 < kGatherMaxN8 ? n8 : kGatherMaxN8);
}

// The tensor's column of unit u of slab s's first element.
PT_HD PT_INLINE int probe_gather_col(int n8, int s, int u) {
  return 8 * n8 * s + 8 * (u % n8);
}

// Round 1 of unit u of slab s: x's 8 columns to the tile (columns past the
// last are left alone).
template <bool kVec>
PT_HD PT_INLINE void probe_gather_stage(const uint16_t* __restrict__ x,
                                        uint16_t* __restrict__ tile,
                                        int cols, int n8, int s, int u) {
  const int c = probe_gather_col(n8, s, u);
  if (c >= cols) return;
  const size_t at = (size_t)(u / n8) * cols + c;
  uint16_t* t = tile + (u / n8) * 8 * n8 + 8 * (u % n8);
  if constexpr (kVec) {
    probe_store16(t, probe_load16(x + at));
  } else {
    for (int k = 0; k < 8 && c + k < cols; ++k) t[k] = x[at + k];
  }
}

// The 8 pointers of unit u of slab s, to ptr.
template <bool kVec>
PT_HD PT_INLINE void probe_gather_ptrs(const int32_t* __restrict__ p,
                                       int cols, int n8, int s, int u,
                                       int32_t* ptr) {
  const int c = probe_gather_col(n8, s, u);
  if (c >= cols) return;
  const size_t at = (size_t)(u / n8) * cols + c;
  if constexpr (kVec) {
    const ProbeVec p0 = probe_load16(p + at), p1 = probe_load16(p + at + 4);
    for (int k = 0; k < 4; ++k) {
      ptr[k] = (int32_t)p0.w[k];
      ptr[4 + k] = (int32_t)p1.w[k];
    }
  } else {
    for (int k = 0; k < 8 && c + k < cols; ++k) ptr[k] = p[at + k];
  }
}

// Round 2 of unit u of slab s: its outputs from the tile.
template <bool kVec>
PT_HD PT_INLINE void probe_gather_store(const uint16_t* __restrict__ tile,
                                        const int32_t* ptr,
                                        uint16_t* __restrict__ o, int cols,
                                        int n8, int s, int u) {
  const int c = probe_gather_col(n8, s, u), j = 8 * (u % n8);
  if (c >= cols) return;
  const size_t at = (size_t)(u / n8) * cols + c;
  const int ld = 8 * n8;
  if constexpr (kVec) {
    ProbeVec v;
    for (int k = 0; k < 4; ++k)
      v.w[k] = (uint32_t)tile[ptr[2 * k] * ld + j + 2 * k]
               | (uint32_t)tile[ptr[2 * k + 1] * ld + j + 2 * k + 1] << 16;
    probe_store16(o + at, v);
  } else {
    for (int k = 0; k < 8 && c + k < cols; ++k)
      o[at + k] = tile[ptr[k] * ld + j + k];
  }
}

// Output element i (row-major) gathered straight from x, for more rows
// than the tile holds.
PT_HD PT_INLINE uint16_t probe_gather_direct(const uint16_t* __restrict__ x,
                                             const int32_t* __restrict__ p,
                                             int cols, size_t i) {
  return x[(size_t)p[i] * cols + i % cols];
}

}  // namespace polar_torch
