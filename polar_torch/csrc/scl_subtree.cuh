// Fast-SCL subtree decode of one codeword by a group of L lanes, one lane
// per path. Shared by the CUDA kernel (scl_subtree.cu, nvcc for sm_90a),
// where the group is L threads of one warp, and a host build
// (scl_subtree_host.cpp, g++) that the CPU tests hold against the plain
// PyTorch version, where one thread runs the L lanes in turn between the
// group's barriers.
//
// Contract (polar_torch/models/polar/cuda_scl.py, scl_subtree): given the
// stage-b LLRs a [2^b, L, bs], the path metrics pm [L, bs] and an op
// schedule (kind, stage, lo) of one 2^b-leaf subtree, return the subtree's
// per-path codeword cw [2^b, L, bs] int32, the parent map P [L, bs] (output
// logical path -> input path) and the updated path metrics.
//
// Two forms share one routine. The static form's schedule fixes the frozen
// set (ops z/r/o/s/f/i, and p, the parity-check leaf of PC-aided decoding). The traced form has one 't' leaf per leaf and reads
// the frozen flags at run time from frz [2^b] int32; the flag is the same
// for every codeword of a launch, so the branch is uniform, and a frozen
// 't' leaf pays only its path-metric update, as an 'f' leaf does.
//
// Design:
// * lane l owns logical path l: its path metric, its slot of every stage's
//   path pointer (5 bits per stage, LLR stages 1..b in one uint64 and
//   partial-sum stages 0..b-1 in another), its parent, its node-entry path
//   and its rate-1 / SPC flip bits live in the lane's registers;
// * workspaces (lloc f32 LLR segments, uloc int8 partial sums) keep the
//   compact stage order, path slot minor, and store each stage of at
//   least 4 rows (s >= 2) as row quads: stage s from quad 2^(s-2) - 1,
//   rows 4q..4q+3 of slot p at [quad q][codeword][p][4], so a lane moves
//   four rows of its path in one 16-byte (f32) or 4-byte (int8) access and
//   a warp's lanes touch 512 (128) neighbouring bytes. Stages 0 and 1 (1
//   and 2 rows) keep the scalar layout [row][codeword][slot] (stage s at
//   row 2^s - 1), in three rows after the quads. Stages below n_shared sit
//   in the block's shared memory, the rest in a global scratch laid out
//   alike with the batch in place of the block's codewords ([quad][bs]
//   [slot][4], then the scalar rows); stage b's LLRs are read straight from
//   the input a (any path stride, row by row), and its partial sums (the
//   codeword) rise into the global scratch as quads like any stage's, from
//   where a transpose writes cw. Every lane computes its own path's f/g
//   rows; a g reads through its stage pointers, so forks copy no
//   workspace rows;
// * the row loops (f, g, rise, the node sums and rate-1 / SPC orders, the
//   node codeword writes) step through quads wherever a stage has 4 rows
//   or more; from 8 rows on each trip issues two quads' loads before their
//   stores, so 8 rows share a memory round trip, and a rise XORs 4
//   partial-sum rows a 32-bit operation. Rows of stages under 4 rows, and
//   of the input a, stay scalar (a's 8 a trip too). The loops take the
//   layout from each stage's height alone;
// * a fork is top-L by rank: lane l holds candidates l and L + l, counts the
//   candidates with a smaller metric or an equal one and a lower index, and
//   a candidate of rank < L writes its index to slot `rank`; so equal
//   metrics keep candidate order, as L rounds of minimum and a stable sort
//   do. Lane l then takes its survivor's metric and copies the parent
//   lane's state, which composes the live pointers (liveness rules of
//   _lptr_live / _uptr_live) in one exchange;
// * exchanges go through the codeword's small shared arrays (GroupShared)
//   between group barriers, so the host build runs the same arithmetic in
//   the same order. A rate-1 / SPC node keeps each node-entry path's
//   reliability order (rows, ties to the lower row) there, and reads the
//   values again from the node's LLRs.
// Node path-metric sums run row by row per path, as the plain version's
// _row_sum does, so exact ties break alike in both; the quads are a layout
// of the same elementwise operations, so they change no result.
//
// PC-aided decoding (TS 38.212 5.3.1.2): each path carries a 5-bit PC
// register in its state, so a fork hands it to the survivors with the
// rest. The JAX package rotates a 5-entry register left at every leaf and
// reads or writes entry 0; after leaf i's rotation that entry is bit
// (i + 1) mod 5 of an unrotated word. An info leaf XORs the survivor's bit
// into that bit after its fork; a PC leaf (p) decides that bit and adds
// softplus(-/+ clip(x)) with no fork. A PC schedule is always the whole
// tree in one call, so the register starts at zero and leaf indices are
// global. The routine is built twice, with and without the register
// (kPc): a schedule with no p leaf runs the build without it, the code of
// the kernel before PC decoding, whose register use and instruction
// schedule the main path was tuned on. A PC schedule walks every leaf, and
// most of its leaves are frozen: its table holds each aligned block of 2^s
// frozen leaves as one OP_FRUN row, which the kPc build decodes leaf by
// leaf inside one op (frozen_run), with the leaf ops' arithmetic and
// without their per-op cost (schedule read, live masks, pointer resets,
// rises of zero sums, barrier).
#pragma once

#include <stddef.h>

#include "fg.cuh"

namespace polar_torch {

// op kinds of the schedule table [n_ops, 3] = (kind, stage, lo)
// (OP_FRUN: 2^stage frozen leaves from lo, walked leaf by leaf in one op;
// the kPc build only)
enum OpKind { OP_Z = 0, OP_R = 1, OP_O = 2, OP_S = 3, OP_F = 4, OP_I = 5,
              OP_T = 6, OP_P = 7, OP_FRUN = 8 };

constexpr int kMaxB = 12;          // subtree depth limit (n <= 4096)
constexpr int kThreads = 128;      // threads of a block on the card
constexpr int kPtrBits = 5;        // one path slot (0..31) per stage
constexpr int kPcRegister = 5;     // PC shift register length

// the register bit that leaf i reads (PC) or updates (info)
PT_HD PT_INLINE int pc_slot(int i) { return (i + 1) % kPcRegister; }

struct SubtreeArgs {
  const float* a;          // [2^b, L, bs], column stride 1
  long long a_row_stride;  // elements
  long long a_l_stride;    // elements (0 for a broadcast over paths)
  const float* pm_in;      // [L, bs]
  const int32_t* frz;      // [2^b] (read by 't' ops only; may be null)
  const int32_t* sched;    // [n_ops, 3]
  int n_ops;
  int32_t* cw;             // [2^b, L, bs]
  int32_t* p_out;          // [L, bs]
  float* pm_out;           // [L, bs]
  float* lloc;             // global stages n_shared..b-1: (2^b - 2^n_shared)
                           // rows of bs * L, quads then scalar rows; or null
  int8_t* uloc;            // the same for the partial sums, and stage b
                           // (the codeword): 2^(b+1) - 2^n_shared rows
  int b;
  int bs;
  float llr_max;
  int exact;               // 1: exact boxplus f, 0: min-sum f
  int n_shared;            // stages 0..n_shared-1 in shared memory
  int pc;                  // 1: the schedule has p leaves (the kPc build)
};

// ---- per-stage path pointers, one 5-bit field per stage ----
PT_HD PT_INLINE int field(uint64_t x, int k) {
  return (int)((x >> (kPtrBits * k)) & 31u);
}
PT_HD PT_INLINE uint64_t field_mask(int k) {
  return (uint64_t)31u << (kPtrBits * k);
}
// the value v in every field (a lane's identity pointers)
PT_HD PT_INLINE uint64_t every_field(int v) {
  uint64_t x = 0;
  for (int k = 0; k < kMaxB; ++k) x |= (uint64_t)v << (kPtrBits * k);
  return x;
}

// lloc stage s still has a pending g-read after a fork ending at leaf i_end
PT_HD PT_INLINE bool lptr_live(int s, int i_end) {
  return s >= 1 && ((i_end >> (s - 1)) & 1) == 0;
}

// uloc stage s still has a pending combine after a fork of a node at stage
// s_node ending at leaf i_end
PT_HD PT_INLINE bool uptr_live(int s, int i_end, int s_node) {
  return s >= s_node && ((i_end >> s) & 1) == 1;
}

// what a surviving path inherits from its parent at a fork
struct PathState {
  uint64_t lp;       // LLR stage pointers: stage s (1..b) in field s - 1
  uint64_t up;       // partial-sum stage pointers: stage s (0..b-1), field s
  uint32_t flips;    // bit t: the path took flip t of the current node
  uint8_t P;         // input path of this output path
  uint8_t qn;        // node-entry path (rate-1 / SPC forks)
  uint8_t e;         // SPC parity toggle
  uint8_t y;         // PC register (bit k: entry k of the unrotated word)
};

struct Lane : PathState {
  float pm;
  float c0, c1;      // this fork's candidates l and L + l
  int bit;           // the bit the survivor's candidate decided
};

// one codeword's exchange arrays, in shared memory on the card
template <int L>
struct GroupShared {
  PathState xs[L];
  float cm[2 * L];
  uint16_t srows[L][L];   // [t][q]: rate-1 / SPC order of node-entry path q
  uint8_t slot[L];
};

PT_HD PT_INLINE size_t align8(size_t x) { return (x + 7) & ~(size_t)7; }

// dynamic shared memory of a block of C codewords: the shared workspace
// stages (f32, then int8) and the codewords' exchange arrays
template <int L>
PT_HD PT_INLINE size_t smem_bytes(int n_shared, int C, size_t* off_gs,
                                  size_t* off_u) {
  const size_t rows = ((size_t)1 << n_shared) - 1;
  const size_t gs = align8(rows * C * L * sizeof(float));
  const size_t u = gs + (size_t)C * sizeof(GroupShared<L>);
  if (off_gs) *off_gs = gs;
  if (off_u) *off_u = u;
  return align8(u + rows * C * L);
}

// the same for a block on the card (kThreads / L codewords); -1 for a list
// size the kernel does not take
inline long long block_smem_bytes(int L, int n_shared) {
  switch (L) {
    case 1: return (long long)smem_bytes<1>(n_shared, kThreads / 1, 0, 0);
    case 2: return (long long)smem_bytes<2>(n_shared, kThreads / 2, 0, 0);
    case 4: return (long long)smem_bytes<4>(n_shared, kThreads / 4, 0, 0);
    case 8: return (long long)smem_bytes<8>(n_shared, kThreads / 8, 0, 0);
    case 16: return (long long)smem_bytes<16>(n_shared, kThreads / 16, 0, 0);
    case 32: return (long long)smem_bytes<32>(n_shared, kThreads / 32, 0, 0);
    default: return -1;
  }
}

// the lanes of one codeword on the host: one thread runs all L in turn
template <int L>
struct HostGroup {
  static constexpr int kPer = L;
  PT_HD int lane(int i) const { return i; }
  PT_HD void sync() const {}
};

// four rows of one path: f32 LLRs, or int8 partial sums as one 32-bit word
// (row 4q + k in byte k)
struct F4 {
  float v[4];
};

PT_HD PT_INLINE F4 ld_f4(const float* p) {
#ifdef __CUDA_ARCH__
  const float4 x = *reinterpret_cast<const float4*>(p);
  return {{x.x, x.y, x.z, x.w}};
#else
  F4 x;
  memcpy(x.v, p, sizeof x.v);
  return x;
#endif
}

PT_HD PT_INLINE void st_f4(float* p, const F4& x) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<float4*>(p) = make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
#else
  memcpy(p, x.v, sizeof x.v);
#endif
}

PT_HD PT_INLINE uint32_t ld_u4(const int8_t* p) {
#ifdef __CUDA_ARCH__
  return *reinterpret_cast<const uint32_t*>(p);
#else
  uint32_t w;
  memcpy(&w, p, sizeof w);
  return w;
#endif
}

PT_HD PT_INLINE void st_u4(int8_t* p, uint32_t w) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint32_t*>(p) = w;
#else
  memcpy(p, &w, sizeof w);
#endif
}

// the rows of one stage and path slot: row j at p[(j >> 2) * stride +
// (j & 3)] in a quad stage (sh = 2), at p[j * stride] in a scalar one
// (sh = 0)
template <class T>
struct Rows {
  T* p;
  long long stride;   // elements between quads, or between rows
  int sh;
  PT_HD PT_INLINE T& operator[](int j) const {
    return p[(j >> sh) * stride + (j & (sh | (sh >> 1)))];
  }
  // quad q (rows 4q..4q+3) of a quad stage
  PT_HD PT_INLINE T* at(int q) const { return p + q * stride; }
};

// rows 4q..4q+3 of f32 rows of either layout: one load, or four (the
// input a)
PT_HD PT_INLINE F4 load4(const Rows<const float>& x, int q) {
  if (x.sh) return ld_f4(x.at(q));
  const float* p = x.p + 4 * q * x.stride;
  return {{p[0], p[x.stride], p[2 * x.stride], p[3 * x.stride]}};
}

// out(q, op(q, load(q))) for the nq quads of a stage of at least 4 rows.
// Each trip loads two quads' operands (one where nq is 1) before it
// stores, so 8 rows share a memory round trip. Each caller reads rows that
// it does not write (another stage, or the other half of the rise
// destination), so the order is free
template <class Load, class Op, class Store>
PT_HD PT_INLINE void quads(int nq, Load load, Op op, Store out) {
  for (int q = 0; q < nq; q += 2) {
    const bool two = q + 1 < nq;
    const auto v0 = load(q);
    const auto v1 = two ? load(q + 1) : v0;
    out(q, op(q, v0));
    if (two) out(q + 1, op(q + 1, v1));
  }
}

// visit(j, x[j]) for the w rows of x in row order, a quad a load, the next
// quad's load issued before this one's visits; one copy of visit serves
// every height
template <class Visit>
PT_HD PT_INLINE void rows_in_order(const Rows<const float>& x, int w,
                                   Visit visit) {
  F4 next = w >= 4 ? load4(x, 0)
                   : F4{{x[0], w > 1 ? x[1] : 0.0f, 0.0f, 0.0f}};
  for (int j = 0; j < w; j += 4) {
    F4 v = next;
    if (j + 4 < w) next = load4(x, (j >> 2) + 1);
#pragma unroll 1
    for (int k = 0; k < (w < 4 ? w : 4); ++k) {
      visit(j + k, v.v[0]);
      v.v[0] = v.v[1];
      v.v[1] = v.v[2];
      v.v[2] = v.v[3];
    }
  }
}

// rows 0..2h-1 of x (h = 1 or 2: stage 1 or 2, or the input a): stage 2
// as one quad, whose rows read one by one would put four lanes on a bank
PT_HD PT_INLINE F4 two_h_rows(const Rows<const float>& x, int h) {
  return h == 2 ? load4(x, 0) : F4{{x[0], x[1], 0.0f, 0.0f}};
}

// rows tail..tail+w-1 of o set to v (one word a quad from 4 rows on)
PT_HD PT_INLINE void fill_rows(const Rows<int8_t>& o, int tail, int w,
                               int8_t v) {
  if (w >= 4) {
    const uint32_t word = 0x01010101u * (uint8_t)v;
    for (int q = 0; q < (w >> 2); ++q) st_u4(o.at((tail >> 2) + q), word);
  } else {
    for (int j = 0; j < w; ++j) o[tail + j] = v;
  }
}

// one codeword's view of its workspaces and outputs. A row of the shared
// stages holds C * L elements, of the global ones bs * L; in each, the
// quad stages (s >= 2) come first, from the lowest kept there, then the
// scalar rows. Stage s starts (2^s rows) * width after an offset that the
// constructor takes once: row j of a quad stage at (j >> 2) * 4 * width +
// (j & 3) from there, of a scalar stage at j * width
template <int L>
struct Workspace {
  const SubtreeArgs& A;
  float* lsh;             // shared stages
  int8_t* ush;
  int col;                // batch column
  int ns;                 // stages in shared memory
  int wsh;                // shared row width, C * L
  int oq_sh, os_sh;       // shared offsets: quads (this codeword's), rows
  long long wgl;          // global row width, bs * L
  long long oq_gl;        // global offsets: quads, LLR rows, sum rows
  long long os_gl_l, os_gl_u;

  PT_HD Workspace(const SubtreeArgs& A_, float* lsh_, int8_t* ush_, int C,
                  int c, int col_)
      : A(A_), lsh(lsh_), ush(ush_), col(col_), ns(A_.n_shared),
        wsh(C * L), wgl((long long)A_.bs * L) {
    oq_sh = 4 * (c * L - wsh);                     // less the 4 rows below
    os_sh = ((ns > 2 ? (1 << ns) - 4 : 0) - 1) * wsh + c * L;
    const int lo = ns > 2 ? 1 << ns : 4;           // first global quad row
    oq_gl = 4LL * col * L - lo * wgl;
    // the global scalar rows follow the quad rows of the stages up to b - 1
    // (LLRs) or b (partial sums); stage s's start at 2^s - 2^ns among them
    const int b = A_.b;
    const long long qr_l = (1 << b) > lo ? (1 << b) - lo : 0;
    const long long qr_u = (2 << b) > lo ? (2 << b) - lo : 0;
    os_gl_l = (qr_l - (1LL << ns)) * wgl + (long long)col * L;
    os_gl_u = (qr_u - (1LL << ns)) * wgl + (long long)col * L;
  }

  // the rows of stage s and path slot p in the shared sh or global gl
  template <class T>
  PT_HD PT_INLINE Rows<T> rows(T* sh, T* gl, long long os_gl, int s,
                               int p) const {
    if (s < ns)
      return s >= 2 ? Rows<T>{sh + (oq_sh + (wsh << s) + 4 * p), 4LL * wsh, 2}
                    : Rows<T>{sh + (os_sh + (wsh << s) + p), wsh, 0};
    return s >= 2 ? Rows<T>{gl + (oq_gl + (wgl << s) + 4 * p), 4 * wgl, 2}
                  : Rows<T>{gl + (os_gl + (wgl << s) + p), wgl, 0};
  }
  // the LLRs of stage s and physical path slot p (stage b is the input)
  PT_HD PT_INLINE Rows<const float> lrow(int s, int p) const {
    if (s == A.b)
      return {A.a + (long long)p * A.a_l_stride + col, A.a_row_stride, 0};
    const Rows<float> r = lrow_w(s, p);
    return {r.p, r.stride, r.sh};
  }
  PT_HD PT_INLINE Rows<float> lrow_w(int s, int p) const {
    return rows<float>(lsh, A.lloc, os_gl_l, s, p);
  }
  PT_HD PT_INLINE Rows<int8_t> urow(int s, int p) const {
    return rows<int8_t>(ush, A.uloc, os_gl_u, s, p);
  }
};

// f of four rows: min-sum unrolled, the exact boxplus (an order of
// magnitude more code) one row a turn, so the kernel carries one copy of it
// (see the code-size note in scl_subtree.cu)
PT_HD PT_INLINE F4 f4(F4 x, F4 y, float m, int exact) {
  F4 r{};
  if (!exact) {
    for (int k = 0; k < 4; ++k) r.v[k] = minsum(x.v[k], y.v[k], m);
    return r;
  }
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    r.v[0] = r.v[1];
    r.v[1] = r.v[2];
    r.v[2] = r.v[3];
    r.v[3] = f_op(x.v[0], y.v[0], m, 1);
    x.v[0] = x.v[1];
    x.v[1] = x.v[2];
    x.v[2] = x.v[3];
    y.v[0] = y.v[1];
    y.v[1] = y.v[2];
    y.v[2] = y.v[3];
  }
  return r;
}

// operands of one quad of an f (x's two halves) or a g (and the bits u)
struct FgQuad {
  F4 a, c;
  uint32_t u;
};

#define PT_FOR_LANES for (int i_ = 0; i_ < G::kPer; ++i_)

template <int L, class G, bool kPc>
struct SubtreeGroup {
  const G& g;
  const SubtreeArgs& A;
  const Workspace<L>& W;
  GroupShared<L>& gs;
  Lane S[G::kPer];
  // the current op's node geometry (uniform over the group)
  int r;          // cto(i_end): stage the node's partial sums rise to
  int tail;       // first row of the node's sums in the rise destination
  uint64_t live_l, live_u;   // pointer fields a fork composes


  // top-L of the lanes' candidates (c0, c1) by rank; each lane takes its
  // survivor's metric, its parent's state with the live pointer fields
  // composed, and the survivor's bit
  PT_HD void fork() {
    PT_FOR_LANES {
      const int l = g.lane(i_);
      gs.cm[l] = S[i_].c0;
      gs.cm[L + l] = S[i_].c1;
      gs.xs[l] = S[i_];
    }
    g.sync();
    PT_FOR_LANES {
      const int l = g.lane(i_);
      const float v0 = S[i_].c0, v1 = S[i_].c1;
      int r0 = 0, r1 = 0;
#pragma unroll
      for (int k = 0; k < 2 * L; ++k) {
        const float u = gs.cm[k];
        r0 += (u < v0) | ((u == v0) & (k < l));
        r1 += (u < v1) | ((u == v1) & (k < L + l));
      }
      if (r0 < L) gs.slot[r0] = (uint8_t)l;
      if (r1 < L) gs.slot[r1] = (uint8_t)(L + l);
    }
    g.sync();
    PT_FOR_LANES {
      const int l = g.lane(i_);
      Lane& st = S[i_];
      const int sel = gs.slot[l];
      const PathState x = gs.xs[sel % L];
      st.pm = gs.cm[sel];
      st.bit = sel / L;
      st.lp = (x.lp & live_l) | (st.lp & ~live_l);
      st.up = (x.up & live_u) | (st.up & ~live_u);
      st.flips = x.flips;
      st.P = x.P;
      st.qn = x.qn;
      st.e = x.e;
      if (kPc) st.y = x.y;
    }
    g.sync();
  }

  // f/g from the last stored stage down to the node root at stage s_nd;
  // the stages written are read through identity pointers from then on
  PT_HD void descend(Lane& st, int l, int lo, int s_nd) const {
    const float m = A.llr_max;
    const int exact = A.exact;
    int s_top;
    if (lo == 0) {
      s_top = A.b;
    } else {
      const int d = ctz(lo);
      const int h = 1 << d;
      const Rows<const float> x = W.lrow(d + 1, field(st.lp, d));
      const Rows<int8_t> u = W.urow(d, field(st.up, d));
      const Rows<float> y = W.lrow_w(d, l);
      if (h >= 4) {
        const int hq = h >> 2;
        quads(hq, [=](int q) {
          return FgQuad{load4(x, q), load4(x, q + hq), ld_u4(u.at(q))};
        }, [](int, const FgQuad& v) {
          F4 r;
          for (int k = 0; k < 4; ++k)
            r.v[k] = g_op(v.a.v[k], v.c.v[k], (int)((v.u >> (8 * k)) & 0xffu));
          return r;
        }, [=](int q, const F4& r) { st_f4(y.at(q), r); });
      } else {
        // h = 1 or 2: x's 2h rows in one load (stage 2 is one quad, whose
        // lanes lie 16 bytes apart: row by row they would conflict)
        F4 v = two_h_rows(x, h);
#pragma unroll 1
        for (int j = 0; j < h; ++j) {
          y[j] = g_op(v.v[0], h == 2 ? v.v[2] : v.v[1], u[j]);
          v.v[0] = v.v[1];
          v.v[2] = v.v[3];
        }
      }
      s_top = d;
    }
    for (int s = s_top; s > s_nd; --s) {
      const int h = 1 << (s - 1);
      const Rows<const float> x = W.lrow(s, l);
      const Rows<float> y = W.lrow_w(s - 1, l);
      if (h >= 4) {
        const int hq = h >> 2;
        quads(hq, [=](int q) {
          return FgQuad{load4(x, q), load4(x, q + hq), 0u};
        }, [=](int, const FgQuad& v) { return f4(v.a, v.c, m, exact); },
        [=](int q, const F4& r) { st_f4(y.at(q), r); });
      } else {
        F4 v = two_h_rows(x, h);
#pragma unroll 1
        for (int j = 0; j < h; ++j) {
          y[j] = f_op(v.v[0], h == 2 ? v.v[2] : v.v[1], m, exact);
          v.v[0] = v.v[1];
          v.v[2] = v.v[3];
        }
      }
    }
    const int hi = lo == 0 ? A.b - 1 : s_top;
    uint64_t reset = 0;
    for (int s = s_nd > 1 ? s_nd : 1; s <= hi; ++s) reset |= field_mask(s - 1);
    st.lp = (st.lp & ~reset) | (every_field(l) & reset);
  }

  // the 2^s frozen leaves under the node at stage s (s >= 1) whose LLRs
  // are in slot l, leaf by leaf: the f/g rows, values and metric adds of
  // 2^s 'f' ops, whose partial sums are all zero. Stages 2 and up stay in
  // slot l's workspace rows; stage 2 (the current 4 leaves) and stage 1
  // (the current 2) are kept in registers, and stage 0 is never stored
  PT_HD float frozen_run(int l, int s, float pm) const {
    const float m = A.llr_max;
    const int exact = A.exact;
    F4 v{};                       // stage 2: rows of leaves 4k..4k+3
    float y0 = 0.0f, y1 = 0.0f;   // stage 1: rows of leaves 2k, 2k+1
#pragma unroll 1
    for (int j = 0; j < (1 << s); ++j) {
      if (s >= 2 && (j & 3) == 0) {
        // stage 2 of leaf j: a g with zero sums at stage ctz(j) (none at
        // j = 0), then f down to stage 2
        int top = s;
        if (j > 0) {
          top = ctz(j);
          const int hq = 1 << (top - 2);
          const Rows<const float> x = W.lrow(top + 1, l);
          const Rows<float> y = W.lrow_w(top, l);
          quads(hq, [=](int q) {
            return FgQuad{load4(x, q), load4(x, q + hq), 0u};
          }, [](int, const FgQuad& u) {
            F4 r;
            for (int k = 0; k < 4; ++k) r.v[k] = g_op(u.a.v[k], u.c.v[k], 0);
            return r;
          }, [=](int q, const F4& r) { st_f4(y.at(q), r); });
        }
#pragma unroll 1
        for (int t = top; t > 2; --t) {
          const int hq = 1 << (t - 3);
          const Rows<const float> x = W.lrow(t, l);
          const Rows<float> y = W.lrow_w(t - 1, l);
          quads(hq, [=](int q) {
            return FgQuad{load4(x, q), load4(x, q + hq), 0u};
          }, [=](int, const FgQuad& u) { return f4(u.a, u.c, m, exact); },
          [=](int q, const F4& r) { st_f4(y.at(q), r); });
        }
        v = load4(W.lrow(2, l), 0);
      }
      if ((j & 1) == 0) {
        if (s == 1) {
          const F4 x = two_h_rows(W.lrow(1, l), 1);
          y0 = x.v[0];
          y1 = x.v[1];
        } else {
          // stage 1 of leaf j: f of stage 2 (j = 4k), else its g
          F4 x = v;
#pragma unroll 1
          for (int k = 0; k < 2; ++k) {
            y0 = y1;
            y1 = (j & 2) ? g_op(x.v[0], x.v[2], 0)
                         : f_op(x.v[0], x.v[2], m, exact);
            x.v[0] = x.v[1];
            x.v[2] = x.v[3];
          }
        }
      }
      const float x = (j & 1) ? g_op(y0, y1, 0) : f_op(y0, y1, m, exact);
      float acc = 0.0f;
      acc += softplus(-clipf(x, m));
      pm = pm + acc;
    }
    return pm;
  }

  // |a| of the t-th least reliable row of node-entry path q (node at s_nd)
  PT_HD PT_INLINE float order_val(int s_nd, int t, int q) const {
    return fabsf(clipf(W.lrow(s_nd, q)[gs.srows[t][q]], A.llr_max));
  }

  PT_HD void run() {
    const int b = A.b;
    const float m = A.llr_max;
    PT_FOR_LANES {
      const int l = g.lane(i_);
      Lane& st = S[i_];
      st.pm = A.pm_in[(size_t)l * A.bs + W.col];
      st.lp = st.up = every_field(l);
      st.flips = 0;
      st.P = st.qn = (uint8_t)l;
      st.e = 0;
      st.y = 0;
      st.c0 = st.c1 = 0.0f;
      st.bit = 0;
    }
    for (int op = 0; op < A.n_ops; ++op) {
      int kind = A.sched[3 * op];
      const int s_nd = A.sched[3 * op + 1];
      const int lo = A.sched[3 * op + 2];
      // traced leaf: frozen or info by the run-time flag (uniform branch)
      if (kind == OP_T) kind = A.frz[lo] != 0 ? OP_F : OP_I;
      const int w = 1 << s_nd;
      const int i_end = lo + w - 1;
      r = cto(i_end);
      const int R = r < b ? r : b;
      const int Wd = 1 << R;
      tail = Wd - w;
      live_l = live_u = 0;
      for (int s = 1; s <= b; ++s)
        if (lptr_live(s, i_end)) live_l |= field_mask(s - 1);
      for (int s = 0; s < b; ++s)
        if (uptr_live(s, i_end, s_nd)) live_u |= field_mask(s);

      // ---- descent, then the node; the node's LLRs were just written, so
      // node-entry path q's values are in slot q ----
      const bool spc = kind == OP_S;
      const int theta = spc ? (L < w ? L : w) : (L - 1 < w ? L - 1 : w);
      const bool small = !spc && w <= L - 1;   // row-order forks, no sort
      PT_FOR_LANES {
        const int l = g.lane(i_);
        Lane& st = S[i_];
        descend(st, l, lo, s_nd);
        const Rows<const float> x = W.lrow(s_nd, l);
        if (kind == OP_F || kind == OP_Z) {
          // frozen leaf / rate-0 node: bulk PM update, all-zero sums
          float acc = 0.0f;
          if (w == 1) {    // a frozen leaf, most of a leaf schedule's ops
            acc += softplus(-clipf(x[0], m));
            W.urow(r, l)[tail] = 0;
          } else {
            rows_in_order(x, w, [&](int, float v) {
              acc += softplus(-clipf(v, m));
            });
            fill_rows(W.urow(r, l), tail, w, 0);
          }
          st.pm = st.pm + acc;
        } else if (kind == OP_I) {
          const float v = clipf(x[0], m);
          st.c0 = st.pm + softplus(-v);
          st.c1 = st.pm + softplus(v);
        } else if (kPc && kind == OP_FRUN) {
          // 2^s_nd frozen leaves in one op: their metrics leaf by leaf, then
          // the block's zero sums rise as a rate-0 node's do. The pointer
          // fields end as the leaf ops leave them: LLR stages 1..s_nd - 1
          // and partial-sum stages 0..s_nd - 1 in slot l
          st.pm = frozen_run(l, s_nd, st.pm);
          fill_rows(W.urow(r, l), tail, w, 0);
          const uint64_t low = ((uint64_t)1 << (kPtrBits * s_nd)) - 1;
          st.lp = (st.lp & ~(low >> kPtrBits))
              | (every_field(l) & (low >> kPtrBits));
          st.up = (st.up & ~low) | (every_field(l) & low);
        } else if (kPc && kind == OP_P) {
          // PC leaf: the register decides; the metric rounds as a frozen
          // leaf's does (0 + softplus, then the add), for either bit
          const int bit = (st.y >> pc_slot(lo)) & 1;
          const float v = clipf(x[0], m);
          float acc = 0.0f;
          acc += softplus(bit ? v : -v);
          st.pm = st.pm + acc;
          W.urow(r, l)[tail] = (int8_t)bit;
        } else if (kind == OP_R) {
          float s0 = 0.0f, s1 = 0.0f;
          rows_in_order(x, w, [&](int, float xv) {
            const float v = clipf(xv, m);
            s0 += softplus(-v);
            s1 += softplus(v);
          });
          st.c0 = st.pm + s0;
          st.c1 = st.pm + s1;
        } else {
          // rate-1 ('o') or SPC ('s') node, decoded at its top: hard
          // decisions plus theta sequential least-reliable-flip forks
          float acc = 0.0f;
          int par = 0;
          rows_in_order(x, w, [&](int, float xv) {
            const float v = clipf(xv, m);
            acc += softplus(-fabsf(v));
            par ^= v < 0.0f;
          });
          float v0 = 0.0f;
          if (!small) {
            // ascending (|a|, row) order: the t-th pick is the least pair
            // strictly after the previous pick
            float pv = -1.0f;
            int pr = -1;
            for (int t = 0; t < theta; ++t) {
              int br = -1;
              float bv = 0.0f;
              rows_in_order(x, w, [&](int j, float xv) {
                const float v = fabsf(clipf(xv, m));
                const bool after = v > pv || (v == pv && j > pr);
                if (after && (br < 0 || v < bv)) {
                  bv = v;
                  br = j;
                }
              });
              gs.srows[t][l] = (uint16_t)br;
              if (t == 0) v0 = bv;
              pv = bv;
              pr = br;
            }
          }
          if (spc) {
            st.pm = (st.pm + acc) + (par ? v0 : 0.0f);
            st.e = (uint8_t)par;
          } else {
            st.pm = st.pm + acc;
          }
          st.qn = (uint8_t)l;      // the node's forks start from here
          st.flips = 0;
        }
      }

      if (kind == OP_I || kind == OP_R) {
        fork();
        PT_FOR_LANES {
          fill_rows(W.urow(r, g.lane(i_)), tail, w, (int8_t)S[i_].bit);
          // the survivor's bit into its parent's register
          if (kPc && kind == OP_I)
            S[i_].y ^= (uint8_t)(S[i_].bit << pc_slot(lo));
        }
      } else if (kind == OP_O || kind == OP_S) {
        g.sync();          // the orders and node LLRs of every path
        for (int t = spc ? 1 : 0; t < theta; ++t) {
          PT_FOR_LANES {
            Lane& st = S[i_];
            const int q = st.qn;
            float pen;
            if (small) {
              pen = fabsf(clipf(W.lrow(s_nd, q)[t], m));
            } else if (spc) {
              const float v0 = order_val(s_nd, 0, q);
              const float vt = order_val(s_nd, t, q);
              pen = st.e ? vt - v0 : vt + v0;
            } else {
              pen = order_val(s_nd, t, q);
            }
            st.c0 = st.pm;
            st.c1 = st.pm + pen;
          }
          fork();
          PT_FOR_LANES {
            Lane& st = S[i_];
            st.flips |= (uint32_t)st.bit << t;
            if (spc) st.e ^= (uint8_t)st.bit;
          }
        }
        // codeword of output path l: node-entry path q's hard decisions
        // with the surviving flips applied (rows of q's order)
        PT_FOR_LANES {
          const Lane& st = S[i_];
          const int q = st.qn;
          const Rows<const float> x = W.lrow(s_nd, q);
          const Rows<int8_t> o = W.urow(r, g.lane(i_));
          if (w >= 4) {
            const int tq = tail >> 2;
            quads(w >> 2, [=](int k) { return load4(x, k); },
                  [](int, const F4& v) {
                    uint32_t bits = 0;
                    for (int k = 0; k < 4; ++k)
                      bits |= (uint32_t)(v.v[k] < 0.0f) << (8 * k);
                    return bits;
                  }, [=](int k, uint32_t v) { st_u4(o.at(tq + k), v); });
          } else {
            for (int j = 0; j < w; ++j) o[tail + j] = x[j] < 0.0f;
          }
          for (int t = spc ? 1 : 0; t < theta; ++t) {
            if ((st.flips >> t) & 1u) {
              const int row = tail + (small ? t : gs.srows[t][q]);
              o[row] ^= 1;
            }
          }
          if (spc && st.e) {
            const int row = tail + gs.srows[0][q];
            o[row] ^= 1;
          }
        }
      }

      // ---- rise: combine partial sums upward into the destination ----
      PT_FOR_LANES {
        const int l = g.lane(i_);
        Lane& st = S[i_];
        const Rows<int8_t> o = W.urow(r, l);
        for (int s = s_nd; s < R; ++s) {
          const int h = 1 << s;
          const int base = Wd - 2 * h;
          const Rows<int8_t> u = W.urow(s, field(st.up, s));
          if (h >= 4) {
            // 4 rows a 32-bit XOR; the destination is a quad stage (R > s)
            const int hq = h >> 2, bq = base >> 2;
            quads(hq, [=](int q) {
              return ld_u4(u.at(q)) ^ ld_u4(o.at(bq + hq + q));
            }, [](int, uint32_t v) { return v; },
               [=](int q, uint32_t v) { st_u4(o.at(bq + q), v); });
          } else {
            for (int j = 0; j < h; ++j)
              o[base + j] = (int8_t)(u[j] ^ o[base + h + j]);
          }
        }
        if (r < b)
          st.up = (st.up & ~field_mask(r)) | ((uint64_t)l << (kPtrBits * r));
      }
      g.sync();            // no lane starts the next op's writes early
    }
    PT_FOR_LANES {
      const int l = g.lane(i_);
      A.p_out[(size_t)l * A.bs + W.col] = S[i_].P;
      A.pm_out[(size_t)l * A.bs + W.col] = S[i_].pm;
    }
  }
};

#undef PT_FOR_LANES

// the stage-b partial sums of every codeword: [2^(b-2)][bs][L][4] int8
// quads from b = 2 on, else [2^b][bs][L] rows
PT_HD PT_INLINE const int8_t* stage_b_sums(const SubtreeArgs& A, int L) {
  const int ns = A.n_shared;
  const int lo = A.b < 2 ? ns : (ns > 2 ? ns : 2);
  return A.uloc + (size_t)((1 << A.b) - (1 << lo)) * A.bs * L;
}

// decode one codeword with group g; lsh / ush are its block's shared
// workspace stages, C the block's codewords and c this one's index
template <int L, bool kPc, class G>
PT_HD PT_INLINE void subtree_codeword(const G& g, const SubtreeArgs& A,
                                      GroupShared<L>& gs, float* lsh,
                                      int8_t* ush, int C, int c, int col) {
  const Workspace<L> W{A, lsh, ush, C, c, col};
  SubtreeGroup<L, G, kPc> dec{g, A, W, gs, {}, 0, 0, 0, 0};
  dec.run();
}

}  // namespace polar_torch
