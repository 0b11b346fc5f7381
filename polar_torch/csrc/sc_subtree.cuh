// SC subtree decode of one codeword (one batch column) by a group of G
// lanes. Shared by the CUDA kernel (sc_subtree.cu, nvcc for sm_90a), where
// the group is G threads of one warp, and a host build (sc_subtree_host.cpp,
// g++) that the CPU tests hold against the plain PyTorch version, where one
// thread runs the G lanes in turn between the group's barriers.
//
// Contract (polar_torch/models/polar/cuda_sc.py, sc_subtree): given the
// stage-b LLRs a [2^b, bs] and a static op schedule (kind, stage, lo) of one
// 2^b-leaf subtree, return the subtree's codeword cw [2^b, bs] int32 (its
// stage-b partial sums). Successive cancellation has no list: no path
// metrics, no forks.
//
// Ops: rate-0 node 'z' (all-frozen span: zero partial sums whatever its
// LLRs, so its descent stops one stage above its root), frozen leaf 'f',
// info leaf 'i' (llr <= 0 decides 1), 't', a leaf whose frozen-ness is
// read at run time from frz [2^b] int32, and 'p', a parity-check leaf of
// PC-aided decoding (TS 38.212 5.3.1.2).
//
// Layout: the workspaces have the compact stage layout (stage s at row
// 2^s - 1): lloc f32 LLR segments and uloc int8 partial sums, stages
// 0..b-1. Stages below n_shared sit in the block's shared memory, one
// codeword's rows contiguous; the rest in a global scratch
// [bs][2^b - 2^n_shared], so a group's lanes touch neighbouring addresses
// there too. Stage b (the input) and the codeword are per-codeword tiles
// in shared memory that the block fills from a and empties into cw.
//
// Each stage of a descent or rise splits its segment across the lanes
// (lane k takes rows k, k + G, ...); a segment narrower than G runs on
// its first lanes, a leaf on lane 0, which keeps the leaf's LLR and
// decides its bit. A group barrier follows every stage, since the next
// stage reads rows that other lanes wrote.
//
// PC: lane 0 also keeps the codeword's 5-bit PC register. The JAX package
// rotates a 5-entry register left at every leaf and reads or writes entry
// 0; after leaf i's rotation that entry is bit (i + 1) mod 5 of an
// unrotated word. An info leaf XORs its bit into that bit, a PC leaf
// decides it. A PC schedule is always the whole tree in one call, so the
// register starts at zero and leaf indices are global.
#pragma once

#include <stddef.h>

#include "fg.cuh"

namespace polar_torch {

// op kinds of the schedule table [n_ops, 3] = (kind, stage, lo); the codes
// of z/f/i are those of the SCL kernel's table
enum ScOpKind { SC_Z = 0, SC_F = 4, SC_I = 5, SC_T = 6, SC_P = 7 };

constexpr int kScThreads = 128;       // threads of a block on the card
constexpr int kScMaxB = 12;

struct ScArgs {
  const float* a;          // [2^b, bs], column stride 1
  long long a_row_stride;  // elements
  const int32_t* frz;      // [2^b] (read by 't' ops only; may be null)
  const int32_t* sched;    // [n_ops, 3]
  int n_ops;
  int32_t* cw;             // [2^b, bs]
  float* lloc;             // global stages: [bs, 2^b - 2^n_shared] or null
  int8_t* uloc;            // the same for the partial sums
  int b;
  int bs;
  float llr_max;
  int exact;               // 1: exact boxplus f, 0: min-sum f
  int n_shared;            // stages 0..n_shared-1 in shared memory
};

PT_HD PT_INLINE size_t sc_align16(size_t x) { return (x + 15) & ~(size_t)15; }

// per-codeword strides of the shared tiles and workspaces (odd or padded,
// so the codewords of a warp spread over the banks)
PT_HD PT_INLINE int sc_tile_stride(int b) { return (1 << b) + 1; }
PT_HD PT_INLINE int sc_cw_stride(int b) { return (1 << b) + 4; }
PT_HD PT_INLINE int sc_rows(int n_shared) { return (1 << n_shared) - 1; }

// dynamic shared memory of a block of C codewords: the input tiles (f32),
// the shared LLR stages (f32), the shared partial-sum stages and the
// codeword tiles (int8); offsets of the last three
PT_HD PT_INLINE size_t sc_smem_bytes(int b, int n_shared, int C,
                                     size_t* off_l, size_t* off_u,
                                     size_t* off_cw) {
  const size_t l = sc_align16((size_t)4 * C * sc_tile_stride(b));
  const size_t u = sc_align16(l + (size_t)4 * C * sc_rows(n_shared));
  const size_t cw = sc_align16(u + (size_t)C * sc_rows(n_shared));
  if (off_l) *off_l = l;
  if (off_u) *off_u = u;
  if (off_cw) *off_cw = cw;
  return sc_align16(cw + (size_t)C * sc_cw_stride(b));
}

// one codeword's view of its tiles, workspaces and scratch
struct ScWork {
  const ScArgs& A;
  const float* at;         // stage b, [2^b]
  float* lsh;              // shared stages, [2^n_shared - 1]
  int8_t* ush;
  int8_t* ct;              // stage-b sums (the codeword), [2^b]
  int col;

  PT_HD PT_INLINE long long gbase(int s) const {
    return (long long)col * ((1 << A.b) - (1 << A.n_shared))
        + (1 << s) - (1 << A.n_shared);
  }
  // LLR row 0 of stage s (stage b is the input tile)
  PT_HD PT_INLINE const float* lr(int s) const {
    if (s == A.b) return at;
    return s < A.n_shared ? lsh + (1 << s) - 1 : A.lloc + gbase(s);
  }
  PT_HD PT_INLINE float* lw(int s) const {
    return s < A.n_shared ? lsh + (1 << s) - 1 : A.lloc + gbase(s);
  }
  // partial-sum row 0 of stage s (stage b is the codeword tile)
  PT_HD PT_INLINE int8_t* ur(int s) const {
    if (s >= A.b) return ct;
    return s < A.n_shared ? ush + (1 << s) - 1 : A.uloc + gbase(s);
  }
};

// the lanes of one codeword on the host: one thread runs all G in turn
template <int G>
struct ScHostGroup {
  static constexpr int kPer = G;
  PT_HD int lane(int i) const { return i; }
  PT_HD void sync() const {}
};

#define PT_FOR_LANES for (int i_ = 0; i_ < Grp::kPer; ++i_)

// decode one codeword with group g of G lanes
template <int G, class Grp>
PT_HD PT_INLINE void sc_codeword(const Grp& g, const ScArgs& A,
                                 const ScWork& W) {
  const int b = A.b;
  const float m = A.llr_max;
  const int exact = A.exact;
  float root[Grp::kPer];        // a leaf's LLR, kept by lane 0
  int y[Grp::kPer];             // the PC register, kept by lane 0
  PT_FOR_LANES {
    root[i_] = 0.0f;
    y[i_] = 0;
  }

  for (int op = 0; op < A.n_ops; ++op) {
    const int kind = A.sched[3 * op];
    const int s_nd = A.sched[3 * op + 1];
    const int lo = A.sched[3 * op + 2];
    const int w = 1 << s_nd;
    const int i_end = lo + w - 1;

    // ---- descent: down to the node root, or for a rate-0 node to one
    // stage above it (its stores still feed the sibling's g-read). Stages
    // above the root are stored; the root value (a leaf's LLR) is kept.
    const int stop = kind == SC_Z ? s_nd + 1 : s_nd;
    int s_from = b;
    if (lo != 0) {
      const int d = ctz(lo);
      s_from = d;
      if (d >= stop) {
        const int h = 1 << d;
        const float* x = W.lr(d + 1);
        const int8_t* u = W.ur(d);
        if (d > s_nd) {
          float* y = W.lw(d);
          PT_FOR_LANES {
            for (int j = g.lane(i_); j < h; j += G)
              y[j] = g_op(x[j], x[j + h], u[j]);
          }
          g.sync();
        } else {                      // a leaf: h == 1
          PT_FOR_LANES {
            if (g.lane(i_) == 0) root[i_] = g_op(x[0], x[1], u[0]);
          }
        }
      }
    }
    for (int s = s_from; s > stop; --s) {
      const int h = 1 << (s - 1);
      const float* x = W.lr(s);
      if (s - 1 > s_nd) {
        float* y = W.lw(s - 1);
        PT_FOR_LANES {
          for (int j = g.lane(i_); j < h; j += G)
            y[j] = f_op(x[j], x[j + h], m, exact);
        }
        g.sync();
      } else {                        // a leaf: h == 1
        PT_FOR_LANES {
          if (g.lane(i_) == 0) root[i_] = f_op(x[0], x[1], m, exact);
        }
      }
    }

    // ---- node: its partial sums go to the tail of the rise destination
    // (uloc stage r, or the codeword tile when the rise reaches stage b) ----
    const int r = cto(i_end);
    const int R = r < b ? r : b;
    const int Wd = 1 << R;
    int8_t* dst = W.ur(r);
    const bool info = kind == SC_I || (kind == SC_T && A.frz[lo] == 0);
    const int slot = (lo + 1) % 5;      // the leaf's PC register bit
    PT_FOR_LANES {
      int bit = 0;                      // a leaf's, on lane 0
      if (g.lane(i_) == 0) {
        if (kind == SC_P) {
          bit = (y[i_] >> slot) & 1;
        } else if (info) {
          bit = root[i_] <= 0.0f;
          y[i_] ^= bit << slot;
        }
      }
      for (int j = g.lane(i_); j < w; j += G) dst[Wd - w + j] = (int8_t)bit;
    }
    g.sync();

    // ---- rise: combine partial sums upward into the destination ----
    for (int s = s_nd; s < R; ++s) {
      const int h = 1 << s;
      const int base = Wd - 2 * h;
      const int8_t* u = W.ur(s);
      PT_FOR_LANES {
        for (int j = g.lane(i_); j < h; j += G)
          dst[base + j] = (int8_t)(u[j] ^ dst[base + h + j]);
      }
      g.sync();
    }
  }
}

#undef PT_FOR_LANES

}  // namespace polar_torch
