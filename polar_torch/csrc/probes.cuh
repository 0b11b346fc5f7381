// The probe kernels' arithmetic, one routine per probe over one column
// (k_sweepcombo: over an 8-row group of one; k_reduce and k_gather: over a
// thread's share of a CTA's slab; k_i8: over 16 bytes; below),
// shared by the card's kernels (probes.cu) and the host build that the CPU
// tests run (probes_host.cpp), which runs the card's order. Each routine
// is __host__ __device__ code: nvcc builds it for the card, g++ for the
// CPU. Mirrors the plain versions in polar_torch/probes.py, which round as
// the JAX package's Pallas probes (benchmarks/probe_r4.py) do on the CPU.
//
// A column of an f32 probe is 64 rows (k_big's scratch 1,024), strided by
// the row length ld; a bf16 column is the tensor's rows. bf16 values
// travel as their 16 bits (uint16_t).
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

// One row's stage update min(|xx|, |part|) sign(xx) sign(part) of the
// stage sweeps, on the bits of the row's own value x and its partner's p,
// with the bits XLA gives on the CPU (the script's kernels in interpret
// mode, probed with every ordered pair of four NaNs of both signs and
// payloads, +-1 and +-0; tests/test_torch_probes.py). Off NaN the value is
// min(|x|, |p|) with the sign bit sign(x) XOR sign(p): both sign factors
// are +-1 or +-0, so the products are exact. With a NaN, XLA's x86 code
// keeps the first source's NaN in each of its two products: the first
// multiplies sign(xx) and the minimum of the magnitudes, the second that
// product and sign(part), each with its sources in an order fixed where
// the code was compiled. jnp.sign passes a NaN on and the minimum is the
// NaN one's magnitude, so two flags give the result (probe_minsum_rule):
// sign_first (the first product starts with sign(xx): an own NaN keeps
// its sign, else its magnitude) and part_first (the second starts with
// sign(part): a partner's NaN wins, else the product's). Stage 0 of a
// sweep runs (sign_first, not part_first): x if it is a NaN, else p's
// magnitude. Every later stage runs (not sign_first, part_first): p if it
// is a NaN, else x's magnitude. The result is quieted either way. So the
// two rows of a pair may end with other NaN bits, and each computes its
// own value from the pair's old values. k_big's partners are copies of
// their own (probe_big_copy, below). The routines take NaNs already quiet
// (probe_quiet, once at the load), so the quieting costs nothing a stage.
// Selects and sign-bit operations only reach the result: the one f32
// operation, the minimum of the magnitudes, is kept only off NaN, since
// the card's float unit would not keep a NaN's payload. (Subnormal inputs
// XLA's CPU code flushes to zero; here they stay.)
constexpr uint32_t kF32Abs = 0x7fffffffu, kF32Sign = 0x80000000u;
constexpr uint32_t kF32Inf = 0x7f800000u, kF32Quiet = 0x00400000u;

// a NaN with its quiet bit set, anything else as it is
PT_HD PT_INLINE uint32_t probe_quiet(uint32_t u) {
  return (u & kF32Abs) > kF32Inf ? u | kF32Quiet : u;
}

PT_HD PT_INLINE bool probe_is_nan(uint32_t u) {
  const float f = f32_of(u);
  return f != f;
}

// the update off NaN (with a NaN operand: a value never kept)
PT_HD PT_INLINE uint32_t probe_minsum_num(uint32_t x, uint32_t p) {
  return f32_bits(fminf(fabsf(f32_of(x)), fabsf(f32_of(p))))
         | ((x ^ p) & kF32Sign);
}

// row x's update from its partner p (NaNs quiet) under the order flags,
// given num = probe_minsum_num(x, p) and whether x and p are NaNs
PT_HD PT_INLINE uint32_t probe_minsum_rule(uint32_t x, uint32_t p,
                                           uint32_t num, bool nx, bool np,
                                           bool sign_first,
                                           bool part_first) {
  return np && part_first
             ? p
             : (nx ? (sign_first ? x : x & kF32Abs)
                   : (np ? p & kF32Abs : num));
}

// Both rows of a pair at a stage of a sweep, each from the pair's old
// values (a's partner is b, b's is a; NaNs quiet): stage 0's order when
// own_first, else the later stages'. The off-NaN value (symmetric) and
// the NaN tests are shared.
PT_HD PT_INLINE void probe_minsum_pair(uint32_t& a, uint32_t& b,
                                       bool own_first) {
  const uint32_t num = probe_minsum_num(a, b);
  const bool na = probe_is_nan(a), nb = probe_is_nan(b);
  const uint32_t a_new =
      probe_minsum_rule(a, b, num, na, nb, own_first, !own_first);
  b = probe_minsum_rule(b, a, num, nb, na, own_first, !own_first);
  a = a_new;
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
  }
}

// ----------------------------------------------------------------------
// k_sweepcombo: stages 0..2 pair row r with r ^ 1, r ^ 2 and r ^ 4 (the
// script's rolls wrap, but no partner reaches them), so each aligned group
// of 8 rows of a column evolves alone, 4 sweeps of 3 stages. One call
// runs a group: x and o point at its row 0, rows ld apart. Its 8 values sit
// in registers (every index a constant once the loops unroll), read in one
// round, NaNs quieted; each stage updates 4 independent pairs.
// ----------------------------------------------------------------------
constexpr int kProbeComboRows = 1 << kProbeComboStages;  // rows of a group

PT_HD PT_INLINE void probe_combo_group(const float* __restrict__ x,
                                       float* __restrict__ o, int ld) {
  uint32_t v[kProbeComboRows];
#pragma unroll
  for (int k = 0; k < kProbeComboRows; ++k)
    v[k] = probe_quiet(f32_bits(x[k * ld]));
#pragma unroll
  for (int i = 0; i < kProbeComboSweeps; ++i) {
#pragma unroll
    for (int s = 0; s < kProbeComboStages; ++s) {
#pragma unroll
      for (int k = 0; k < kProbeComboRows; ++k)
        if (!(k >> s & 1)) probe_minsum_pair(v[k], v[k | 1 << s], s == 0);
    }
  }
#pragma unroll
  for (int k = 0; k < kProbeComboRows; ++k) o[k * ld] = f32_of(v[k]);
}

// ----------------------------------------------------------------------
// k_big: 1,024 scratch rows a column, row r = x[r mod 64] (the 64-row
// block tiled 16 times), swept `sweeps` times over stages 0..7; out rows
// 0..63. Stage s pairs row r with r ^ 2^s, so each 256-row quarter of the
// scratch evolves alone, and the four start equal. The card's layout: one
// warp a (column, quarter), lane l holding the quarter's rows 8 l .. 8 l
// + 7 in registers (row 8 l + k in register k). Stages 0..2 pair registers
// k ^ 2^s of a lane, stages 3..7 lanes l ^ 2^(s-3) (the card: a shuffle).
// Lanes 0..7 hold rows 0..63; each output row is that row of the four
// quarters folded by probe_min, which returns its bits (the quarters are
// equal: the same values through the same steps), so every quarter's
// sweep reaches the output.
//
// The partners' copies. XLA on the CPU keeps only the scratch of a sweep
// in memory and each stage's two rolled partner arrays: each of those
// fusions computes its rows' values again from the scratch through the
// earlier stages (reading the earlier partner arrays), and its own
// compiled code multiplies in its own orders (tests/xla_copy_orders.py
// reads them off XLA's object code). So the value a row sends its stage-s
// partner is one of three chains of the row (probe_big_copy): the main
// chain (the stage orders above, which the row's own value follows), the
// alternative chain (stage 0 in the copy order (sign_first, part_first),
// every later stage as the main chain: they differ only in NaN bits) or,
// in the looped kernel from stage 4 on, the alternative chain with its
// last stage, s - 1, in the copy order. Each lane carries both chains of
// its rows and, from the pair it updates at stage s - 1, computes what it
// sends at stage s, so each row still sends one value a stage. The table
// is fixed where XLA compiles the kernel, the same for every row and
// sweep (the loop body compiles once); stage 0 reads the scratch, where
// the chains start equal. The stage-7 copy of the looped kernel (inside
// XLA's final fusion) cannot show in any output: at stages 6 and 7 a row
// and its partner are one row of two equal tiles, both NaN or neither,
// and with both NaN every order keeps the partner's NaN, whose bits are
// the stage-6 partner's, whichever of the two chains the copy follows (at
// stage 6 both update in an order that keeps the partner's NaN); so the
// table takes the main chain there.
// ----------------------------------------------------------------------
constexpr int kProbeBigQuarters = 4;  // 256-row quarters of the scratch
constexpr int kProbeBigLaneRows = 8;  // rows of a quarter a lane holds
constexpr int kProbeBigInLane = 3;    // stages 0..2 pair a lane's rows
static_assert(kProbeBigQuarters * 32 * kProbeBigLaneRows == kProbeBigRows
                  && 1 << kProbeBigInLane == kProbeBigLaneRows
                  && kProbeBigStages - kProbeBigInLane == 5,
              "four quarters of 32 lanes of 8 rows; lanes pair by 5 bits");

// lane's registers of one column at its fill (x and its row 0, rows ld
// apart), NaNs quieted; every quarter's are rows (8 lane + k) mod 64 of
// the block
PT_HD PT_INLINE void probe_big_fill(const float* x, int ld, int lane,
                                    uint32_t* v) {
#pragma unroll
  for (int k = 0; k < kProbeBigLaneRows; ++k)
    v[k] = probe_quiet(
        f32_bits(x[((kProbeBigLaneRows * lane + k) % kProbeRows) * ld]));
}

// The chain of a row whose value it sends its stage-s partner (0 <= s <=
// kProbeBigStages; s = 8 is the next sweep's scratch), for k_big with
// `sweeps` sweeps: its main chain, its alternative chain, or the
// alternative with its last stage in the copy order. At stage 0 all three
// are the scratch.
enum ProbeBigCopy { kProbeCopyMain = 0, kProbeCopyAlt, kProbeCopyAltLast };

PT_HD constexpr int probe_big_copy(int s, int sweeps) {
  return s == 2 || s == 3 ? kProbeCopyAlt
         : sweeps > 1 && s >= 4 && s <= 6 ? kProbeCopyAltLast
                                          : kProbeCopyMain;
}

// One row's stage-s update from the value q its partner sent: the main
// chain v (stage 0: own NaN first; later: the partner's), the alternative
// chain w (stage 0: the copy order (sign_first, part_first); later as v)
// and t, what the row sends at stage s + 1. v and w are NaN together and
// equal off NaN, so the off-NaN value and the NaN tests are shared, and
// so are the selects the orders have in common (probe_minsum_rule with
// its flags spelled out): at stage 0, where w is v, both orders keep an
// own NaN; at later stages every order keeps a partner's NaN, and an own
// NaN alone keeps its magnitude (v, w) or, in the copy order, its bits.
// The card's compiler drops w where no later stage reads it.
template <int kSweeps>
PT_HD PT_INLINE void probe_big_row(uint32_t& v, uint32_t& w, uint32_t& t,
                                   uint32_t q, int s) {
  const uint32_t num = probe_minsum_num(v, q);
  const bool nv = probe_is_nan(v), nq = probe_is_nan(q);
  const int copy = probe_big_copy(s + 1, kSweeps);
  uint32_t last = 0;
  if (s == 0) {
    const uint32_t base = nv ? v : num;
    w = nq ? q : base;
    v = nq && !nv ? q & kF32Abs : base;
  } else {
    const uint32_t m = nq ? q : num;
    const bool own = nv && !nq;
    last = own ? w : m;  // kProbeCopyAltLast
    v = own ? v & kF32Abs : m;
    w = own ? w & kF32Abs : m;
  }
  t = copy == kProbeCopyMain ? v : copy == kProbeCopyAlt ? w : last;
}

// a sweep's start: both chains and the value sent at stage 0 are the
// scratch v
PT_HD PT_INLINE void probe_big_start(const uint32_t* v, uint32_t* w,
                                     uint32_t* t) {
#pragma unroll
  for (int k = 0; k < kProbeBigLaneRows; ++k) w[k] = t[k] = v[k];
}

// stage s < 3 over a lane's registers: row k's partner is row k ^ 2^s of
// the lane, which sent its t from before the stage
template <int kSweeps>
PT_HD PT_INLINE void probe_big_lane_stage(uint32_t* v, uint32_t* w,
                                          uint32_t* t, int s) {
  uint32_t sent[kProbeBigLaneRows];
#pragma unroll
  for (int k = 0; k < kProbeBigLaneRows; ++k) sent[k] = t[k];
#pragma unroll
  for (int k = 0; k < kProbeBigLaneRows; ++k)
    probe_big_row<kSweeps>(v[k], w[k], t[k], sent[k ^ 1 << s], s);
}

// stage s >= 3 over a lane's registers, given what the partner lane's rows
// sent (p: their t from before the stage)
template <int kSweeps>
PT_HD PT_INLINE void probe_big_cross_stage(uint32_t* v, uint32_t* w,
                                           uint32_t* t, const uint32_t* p,
                                           int s) {
#pragma unroll
  for (int k = 0; k < kProbeBigLaneRows; ++k)
    probe_big_row<kSweeps>(v[k], w[k], t[k], p[k], s);
}

// an output row from its four quarters' bits, folded in quarter order
PT_HD PT_INLINE float probe_big_fold(const uint32_t* q, int stride) {
  float m = f32_of(q[0]);
#pragma unroll
  for (int i = 1; i < kProbeBigQuarters; ++i)
    m = probe_min(m, f32_of(q[i * stride]));
  return m;
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
// k_i8: where(x > 0, x, -x) + 1 on int8, wrapping as int8 does (-128 ->
// -127, 127 -> -128). An elementwise map, so the kernel takes the
// contiguous tensor's n bytes as units of 16 (unit u: bytes 16 u .. 16 u +
// 15, those below n). The vector form (kVec: both tensors 16-byte aligned)
// moves a whole unit as one 16-byte access and the last, partial one
// byte by byte; the other form moves every unit byte by byte.
// ----------------------------------------------------------------------

// The map on one byte.
PT_HD PT_INLINE int8_t probe_int8_one(int8_t v) {
  const int8_t a = v > 0 ? v : (int8_t)(-v);
  return (int8_t)(a + 1);
}

// The map on the four bytes of a word at once, in 32-bit integer
// operations (the same bits from g++ and nvcc). A negative byte b becomes
// ~b + 2 (its negation, wrapped, plus one), any other b + 1; the bytes'
// sums are taken without carries between them: the low 7 bits of each
// add (at most 0x7f + 2, so their carry stops at the byte's bit 7), and
// bit 7 is the XOR of the addends' bits 7 and that carry.
PT_HD PT_INLINE uint32_t probe_int8x4(uint32_t x) {
  const uint32_t neg = (x & 0x80808080u) >> 7;    // 1 in each negative byte
  const uint32_t t = x ^ (neg * 0xffu);           // ~b there, b elsewhere
  const uint32_t c = 0x01010101u + neg;           // 2 there, 1 elsewhere
  return ((t & 0x7f7f7f7fu) + c) ^ (t & 0x80808080u);
}

constexpr int kInt8Unit = sizeof(ProbeVec);  // bytes of a unit

// Unit u of x (n bytes), mapped.
template <bool kVec>
PT_HD PT_INLINE ProbeVec probe_int8_load(const int8_t* __restrict__ x,
                                         size_t n, size_t u) {
  const size_t at = u * kInt8Unit;
  ProbeVec v;
  if (kVec && at + kInt8Unit <= n) {
    v = probe_load16(x + at);
#pragma unroll
    for (int i = 0; i < 4; ++i) v.w[i] = probe_int8x4(v.w[i]);
    return v;
  }
  int8_t* b = reinterpret_cast<int8_t*>(v.w);
#pragma unroll
  for (int i = 0; i < kInt8Unit; ++i)
    if (at + i < n) b[i] = probe_int8_one(x[at + i]);
  return v;
}

// Unit u of o (n bytes) from its mapped values.
template <bool kVec>
PT_HD PT_INLINE void probe_int8_store(int8_t* __restrict__ o, size_t n,
                                      size_t u, const ProbeVec& v) {
  const size_t at = u * kInt8Unit;
  if (kVec && at + kInt8Unit <= n) {
    probe_store16(o + at, v);
    return;
  }
  const int8_t* b = reinterpret_cast<const int8_t*>(v.w);
#pragma unroll
  for (int i = 0; i < kInt8Unit; ++i)
    if (at + i < n) o[at + i] = b[i];
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
// [rows, cols] (take_along_axis on axis 0), a NaN written as XLA's gather
// writes it (probe_bf16_canon); the pointers must lie in [0, rows), which
// is not checked. Up to kGatherTileRows rows, a CTA
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

// A gathered bf16 value as XLA's gather gives it on the CPU: a NaN as its
// sign and the canonical quiet NaN 0x7fc0, anything else as it is (one
// integer select).
PT_HD PT_INLINE uint16_t probe_bf16_canon(uint16_t h) {
  return (h & 0x7fffu) > 0x7f80u ? (uint16_t)((h & 0x8000u) | 0x7fc0u) : h;
}

// probe_bf16_canon on the two bf16 values of a word at once: a half's
// magnitude plus 0x7f carries into its bit 15 exactly when it is a NaN
// (above 0x7f80), with no carry between the halves; its bits 0..14 then
// become those of 0x7fc0, and its sign stays.
PT_HD PT_INLINE uint32_t probe_bf16x2_canon(uint32_t w) {
  const uint32_t nan = ((w & 0x7fff7fffu) + 0x007f007fu) & 0x80008000u;
  const uint32_t mask = nan - (nan >> 15);  // bits 0..14 of each NaN half
  return (w & ~mask) | (mask & 0x7fc07fc0u);
}

// Round 2 of unit u of slab s: its outputs from the tile, NaNs
// canonicalised (probe_bf16_canon).
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
      v.w[k] = probe_bf16x2_canon(
          (uint32_t)tile[ptr[2 * k] * ld + j + 2 * k]
          | (uint32_t)tile[ptr[2 * k + 1] * ld + j + 2 * k + 1] << 16);
    probe_store16(o + at, v);
  } else {
    for (int k = 0; k < 8 && c + k < cols; ++k)
      o[at + k] = probe_bf16_canon(tile[ptr[k] * ld + j + k]);
  }
}

// Output element i (row-major) gathered straight from x, for more rows
// than the tile holds (canonicalised as probe_gather_store does).
PT_HD PT_INLINE uint16_t probe_gather_direct(const uint16_t* __restrict__ x,
                                             const int32_t* __restrict__ p,
                                             int cols, size_t i) {
  return probe_bf16_canon(x[(size_t)p[i] * cols + i % cols]);
}

}  // namespace polar_torch
