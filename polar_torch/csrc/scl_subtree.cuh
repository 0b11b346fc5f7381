// Fast-SCL subtree decode of one codeword (one batch column), shared by the
// CUDA kernel (scl_subtree.cu, nvcc for sm_90a) and a host build
// (scl_subtree_host.cpp, g++) that the CPU tests hold against the plain
// PyTorch version.
//
// Contract (polar_torch/models/polar/cuda_scl.py, scl_subtree): given the
// stage-b LLRs a [2^b, L, bs], the path metrics pm [L, bs] and an op
// schedule (kind, stage, lo) of one 2^b-leaf subtree, return the subtree's
// per-path codeword cw [2^b, L, bs] int32, the parent map P [L, bs] (output
// logical path -> input path) and the updated path metrics.
//
// Two forms share one routine. The static form's schedule fixes the frozen
// set (ops z/r/o/s/f/i). The traced form has one 't' leaf per leaf and reads
// the frozen flags at run time from frz [2^b] int32; the flag is the same
// for every codeword of a launch, so the branch is uniform, and a frozen
// 't' leaf pays only its path-metric update, as an 'f' leaf does.
//
// Design:
// * every array is batch-minor [row, L, bs], so neighbouring threads
//   (neighbouring codewords) touch neighbouring addresses;
// * workspaces live in global scratch with the compact stage layout
//   (stage s at row 2^s - 1): lloc f32 LLR segments and uloc int8 partial
//   sums, stages 0..b-1; stage b is read straight from the input a;
// * forks copy no workspace rows. Each stage has a path pointer (logical
//   path -> physical row slot): L <= 8 nibbles in one uint32, or for
//   L = 16, 32 one byte per path. A fork composes the pointers that are
//   still live (liveness rules of _lptr_live / _uptr_live) and every read
//   goes through its stage pointer;
// * top-L of 2L candidates is L rounds of minimum, ties to the lower
//   candidate index; rate-1 / SPC reliability order ties to the lower row.
//   Per-path flags (flips, SPC toggles) are bits of one uint32 (L <= 32).
#pragma once

#include "fg.cuh"

namespace polar_torch {

// op kinds of the schedule table [n_ops, 3] = (kind, stage, lo)
enum OpKind { OP_Z = 0, OP_R = 1, OP_O = 2, OP_S = 3, OP_F = 4, OP_I = 5,
              OP_T = 6 };

constexpr int kMaxB = 12;          // subtree depth limit (n <= 4096)
constexpr uint32_t kIdent = 0x76543210u;

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
  float* lloc;             // [2^b - 1, L, bs] scratch
  int8_t* uloc;            // [2^b - 1, L, bs] scratch
  int b;
  int bs;
  float llr_max;
  int exact;               // 1: exact boxplus f, 0: min-sum f
};

// A path pointer: slot l holds the physical row of logical path l.
// blank() gives a pointer whose every slot is about to be put().
template <int L, bool kNibbles = (L <= 8)>
struct PathPtr {           // L = 16, 32: one byte per path
  uint8_t v[L];
  PT_HD PT_INLINE int operator[](int l) const { return v[l]; }
  PT_HD PT_INLINE void put(int l, int p) { v[l] = (uint8_t)p; }
  static PT_HD PT_INLINE PathPtr blank() { return PathPtr(); }
  static PT_HD PT_INLINE PathPtr ident() {
    PathPtr p;
    for (int l = 0; l < L; ++l) p.v[l] = (uint8_t)l;
    return p;
  }
};

template <int L>
struct PathPtr<L, true> {  // L <= 8: nibbles of one uint32
  uint32_t v;
  PT_HD PT_INLINE int operator[](int l) const { return (v >> (4 * l)) & 0xF; }
  PT_HD PT_INLINE void put(int l, int p) { v |= (uint32_t)p << (4 * l); }
  static PT_HD PT_INLINE PathPtr blank() { return PathPtr{0u}; }
  static PT_HD PT_INLINE PathPtr ident() { return PathPtr{kIdent}; }
};

// new[l] = p[parent[l]]
template <int L>
PT_HD PT_INLINE PathPtr<L> compose(const PathPtr<L>& p,
                                   const PathPtr<L>& parent) {
  PathPtr<L> r = PathPtr<L>::blank();
#pragma unroll
  for (int l = 0; l < L; ++l) r.put(l, p[parent[l]]);
  return r;
}

// bit l of the result = bit parent[l] of m (a per-path flag follows its path)
template <int L>
PT_HD PT_INLINE uint32_t permute_bits(uint32_t m, const PathPtr<L>& parent) {
  uint32_t r = 0;
#pragma unroll
  for (int l = 0; l < L; ++l) r |= ((m >> parent[l]) & 1u) << l;
  return r;
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

// one codeword's view of the [row, L, bs] arrays
template <int L>
struct Column {
  const SubtreeArgs& A;
  int col;

  PT_HD PT_INLINE size_t at(int row, int p) const {
    return ((size_t)row * L + p) * (size_t)A.bs + col;
  }
  // stage-s LLR element j of physical path slot p (stage b is the input)
  PT_HD PT_INLINE float lread(int s, int j, int p) const {
    if (s == A.b)
      return A.a[(long long)j * A.a_row_stride + (long long)p * A.a_l_stride + col];
    return A.lloc[at((1 << s) - 1 + j, p)];
  }
  PT_HD PT_INLINE void lwrite(int s, int j, int p, float v) const {
    A.lloc[at((1 << s) - 1 + j, p)] = v;
  }
  PT_HD PT_INLINE int uread(int s, int j, int p) const {
    return A.uloc[at((1 << s) - 1 + j, p)];
  }
};

// a set of the 2L candidates of a fork
template <bool kWide> struct CandSet { using type = uint32_t; };
template <> struct CandSet<true> { using type = uint64_t; };

// top-L of the 2L candidates: L rounds of minimum, ties to the lower index.
// L <= 8 unrolls both loops; L = 16, 32 only the inner one.
template <int L>
PT_HD PT_INLINE void top_l(const float* cand, float* pm, int* sel) {
  using Set = typename CandSet<(2 * L > 32)>::type;
  Set taken = 0;
#pragma unroll (L <= 8 ? L : 1)
  for (int r = 0; r < L; ++r) {
    int bi = -1;
    float best = 0.0f;
#pragma unroll
    for (int c = 0; c < 2 * L; ++c) {
      if (!((taken >> c) & 1u) && (bi < 0 || cand[c] < best)) {
        best = cand[c];
        bi = c;
      }
    }
    pm[r] = best;
    sel[r] = bi;
    taken |= (Set)1 << bi;
  }
}

// the parent pointer of a fork's survivors
template <int L>
PT_HD PT_INLINE PathPtr<L> parents_of(const int* sel) {
  PathPtr<L> par = PathPtr<L>::blank();
  for (int l = 0; l < L; ++l) par.put(l, sel[l] % L);
  return par;
}

template <int L>
PT_HD void subtree_column(const SubtreeArgs& A, int col) {
  using Ptr = PathPtr<L>;
  constexpr int kRank = L > 8 ? L : 8;   // rows of the rate-1 / SPC state
  const Column<L> C{A, col};
  const int b = A.b;
  const float m = A.llr_max;
  float pm[L];
  for (int l = 0; l < L; ++l) pm[l] = A.pm_in[(size_t)l * A.bs + col];
  Ptr lptr[kMaxB + 1];        // stages 0..b (b = input)
  Ptr uptr[kMaxB];            // stages 0..b-1
  for (int s = 0; s <= b; ++s) lptr[s] = Ptr::ident();
  for (int s = 0; s < b; ++s) uptr[s] = Ptr::ident();
  Ptr P = Ptr::ident();

  float cand[2 * L];
  int sel[L];
  // rate-1 / SPC node state: reliability order per node-entry path
  float svals[kRank][kRank];
  int srows[kRank][kRank];
  uint32_t flips[kRank];

  for (int op = 0; op < A.n_ops; ++op) {
    int kind = A.sched[3 * op];
    const int s_nd = A.sched[3 * op + 1];
    const int lo = A.sched[3 * op + 2];
    // traced leaf: frozen or info by the run-time flag (uniform branch)
    if (kind == OP_T) kind = A.frz[lo] != 0 ? OP_F : OP_I;
    const int w = 1 << s_nd;
    const int i_end = lo + w - 1;

    // ---- descent to the node root; the root value is stored at its own
    // stage (stage b when the node is the whole subtree) ----
    int s_top;
    if (lo == 0) {
      s_top = b;
    } else {
      const int d = ctz(lo);
      const int h = 1 << d;
      for (int l = 0; l < L; ++l) {
        const int p = lptr[d + 1][l];
        const int q = uptr[d][l];
        for (int j = 0; j < h; ++j)
          C.lwrite(d, j, l, g_op(C.lread(d + 1, j, p), C.lread(d + 1, j + h, p),
                                 C.uread(d, j, q)));
      }
      lptr[d] = Ptr::ident();
      s_top = d;
    }
    for (int s = s_top; s > s_nd; --s) {
      const int h = 1 << (s - 1);
      for (int l = 0; l < L; ++l) {
        const int p = lptr[s][l];
        for (int j = 0; j < h; ++j)
          C.lwrite(s - 1, j, l, f_op(C.lread(s, j, p), C.lread(s, j + h, p), m, A.exact));
      }
      lptr[s - 1] = Ptr::ident();
    }
    // node values of node-entry path q: C.lread(s_nd, j, node_ptr[q])
    const Ptr node_ptr = lptr[s_nd];

    // ---- node ----
    // the node's partial sums go to the tail of the rise destination
    const int r = cto(i_end);
    const int R = r < b ? r : b;
    const int Wd = 1 << R;
    const int tail = Wd - w;
    int8_t* udst = A.uloc;
    int32_t* cdst = A.cw;
    auto put = [&](int row, int l, int v) {
      if (r >= b) cdst[C.at(row, l)] = v;
      else udst[C.at((1 << r) - 1 + row, l)] = (int8_t)v;
    };
    auto get = [&](int row, int l) -> int {
      return r >= b ? (int)cdst[C.at(row, l)] : (int)udst[C.at((1 << r) - 1 + row, l)];
    };

    bool forked = false;
    Ptr qn = Ptr::ident();   // node-local composition of the node's forks
    if (kind == OP_F || kind == OP_Z) {
      // frozen leaf / rate-0 node: bulk PM update, all-zero partial sums
      for (int l = 0; l < L; ++l) {
        const int p = node_ptr[l];
        float acc = 0.0f;
        for (int j = 0; j < w; ++j) acc += softplus(-clipf(C.lread(s_nd, j, p), m));
        pm[l] = pm[l] + acc;
        for (int j = 0; j < w; ++j) put(tail + j, l, 0);
      }
    } else if (kind == OP_R || kind == OP_I) {
      // repetition node / info leaf: one fork for the (repeated) bit
      for (int l = 0; l < L; ++l) {
        const int p = node_ptr[l];
        if (kind == OP_I) {
          const float v = clipf(C.lread(s_nd, 0, p), m);
          cand[l] = pm[l] + softplus(-v);
          cand[L + l] = pm[l] + softplus(v);
        } else {
          float s0 = 0.0f, s1 = 0.0f;
          for (int j = 0; j < w; ++j) {
            const float v = clipf(C.lread(s_nd, j, p), m);
            s0 += softplus(-v);
            s1 += softplus(v);
          }
          cand[l] = pm[l] + s0;
          cand[L + l] = pm[l] + s1;
        }
      }
      top_l<L>(cand, pm, sel);
      qn = parents_of<L>(sel);
      forked = true;
      for (int l = 0; l < L; ++l) {
        const int bit = sel[l] / L;
        for (int j = 0; j < w; ++j) put(tail + j, l, bit);
      }
    } else {
      // rate-1 ('o') or single-parity-check ('s') node, decoded at its top:
      // hard decisions plus theta sequential least-reliable-flip forks
      const bool spc = kind == OP_S;
      const int theta = spc ? (L < w ? L : w) : (L - 1 < w ? L - 1 : w);
      const bool small = !spc && w <= L - 1;   // row-order forks, no sort
      uint32_t e = 0;                          // SPC toggle state per path
      for (int l = 0; l < L; ++l) {
        const int p = node_ptr[l];
        float acc = 0.0f;
        int par = 0;
        for (int j = 0; j < w; ++j) {
          const float v = clipf(C.lread(s_nd, j, p), m);
          acc += softplus(-fabsf(v));
          par ^= v < 0.0f;
        }
        if (!small) {
          // ascending (|a|, row) order: the t-th pick is the least pair
          // strictly after the previous pick
          float pv = -1.0f;
          int pr = -1;
          for (int t = 0; t < theta; ++t) {
            int br = -1;
            float bv = 0.0f;
            for (int j = 0; j < w; ++j) {
              const float v = fabsf(clipf(C.lread(s_nd, j, p), m));
              const bool after = v > pv || (v == pv && j > pr);
              if (after && (br < 0 || v < bv)) {
                bv = v;
                br = j;
              }
            }
            svals[t][l] = bv;
            srows[t][l] = br;
            pv = bv;
            pr = br;
          }
        }
        if (spc) {
          pm[l] = (pm[l] + acc) + (par ? svals[0][l] : 0.0f);
          e |= (uint32_t)par << l;
        } else {
          pm[l] = pm[l] + acc;
        }
      }
      for (int t = spc ? 1 : 0; t < theta; ++t) {
        for (int l = 0; l < L; ++l) {
          const int q = qn[l];
          float pen;
          if (small) {
            pen = fabsf(clipf(C.lread(s_nd, t, node_ptr[q]), m));
          } else if (spc) {
            const float v0 = svals[0][q];
            pen = ((e >> l) & 1u) ? svals[t][q] - v0 : svals[t][q] + v0;
          } else {
            pen = svals[t][q];
          }
          cand[l] = pm[l];
          cand[L + l] = pm[l] + pen;
        }
        top_l<L>(cand, pm, sel);
        const Ptr par = parents_of<L>(sel);
        uint32_t flip = 0;
        for (int l = 0; l < L; ++l) flip |= (uint32_t)(sel[l] / L) << l;
        qn = compose<L>(qn, par);
        for (int u = spc ? 1 : 0; u < t; ++u) flips[u] = permute_bits<L>(flips[u], par);
        flips[t] = flip;
        if (spc) e = permute_bits<L>(e, par) ^ flip;
        for (int s = 0; s <= b; ++s)
          if (lptr_live(s, i_end)) lptr[s] = compose<L>(lptr[s], par);
        for (int s = 0; s < b; ++s)
          if (uptr_live(s, i_end, s_nd)) uptr[s] = compose<L>(uptr[s], par);
        P = compose<L>(P, par);
      }
      // codeword of output path l: node-entry path q's hard decisions with
      // the surviving flips applied (rows read through the final q)
      for (int l = 0; l < L; ++l) {
        const int q = qn[l];
        const int p = node_ptr[q];
        for (int j = 0; j < w; ++j) {
          int c = C.lread(s_nd, j, p) < 0.0f;
          for (int t = spc ? 1 : 0; t < theta; ++t) {
            const int row = small ? t : srows[t][q];
            c ^= (row == j) & (int)((flips[t] >> l) & 1u);
          }
          if (spc) c ^= (srows[0][q] == j) & (int)((e >> l) & 1u);
          put(tail + j, l, c);
        }
      }
    }
    if (forked) {
      for (int s = 0; s <= b; ++s)
        if (lptr_live(s, i_end)) lptr[s] = compose<L>(lptr[s], qn);
      for (int s = 0; s < b; ++s)
        if (uptr_live(s, i_end, s_nd)) uptr[s] = compose<L>(uptr[s], qn);
      P = compose<L>(P, qn);
    }

    // ---- rise: combine partial sums upward into the destination ----
    for (int s = s_nd; s < R; ++s) {
      const int h = 1 << s;
      const int base = Wd - 2 * h;
      for (int l = 0; l < L; ++l) {
        const int q = uptr[s][l];
        for (int j = 0; j < h; ++j) put(base + j, l, C.uread(s, j, q) ^ get(base + h + j, l));
      }
    }
    if (r < b) uptr[r] = Ptr::ident();
  }
  for (int l = 0; l < L; ++l) {
    A.p_out[(size_t)l * A.bs + col] = P[l];
    A.pm_out[(size_t)l * A.bs + col] = pm[l];
  }
}

}  // namespace polar_torch
