// SC subtree decode of one codeword (one batch column), shared by the CUDA
// kernel (sc_subtree.cu, nvcc for sm_90a) and a host build
// (sc_subtree_host.cpp, g++) that the CPU tests hold against the plain
// PyTorch version.
//
// Contract (polar_torch/models/polar/cuda_sc.py, sc_subtree): given the
// stage-b LLRs a [2^b, bs] and a static op schedule (kind, stage, lo) of one
// 2^b-leaf subtree, return the subtree's codeword cw [2^b, bs] int32 (its
// stage-b partial sums). Successive cancellation has no list: no path
// metrics, no forks.
//
// Ops: rate-0 node 'z' (all-frozen span: zero partial sums whatever its
// LLRs, so its descent stops one stage above its root), frozen leaf 'f',
// info leaf 'i' (llr <= 0 decides 1), and 't', a leaf whose frozen-ness is
// read at run time from frz [2^b] int32.
//
// Layout: every array is batch-minor [row, bs], so neighbouring threads
// (neighbouring codewords) touch neighbouring addresses. Workspaces live in
// global scratch with the compact stage layout (stage s at row 2^s - 1):
// lloc f32 LLR segments and uloc int8 partial sums, stages 0..b-1; stage b
// is read straight from the input a.
#pragma once

#include "fg.cuh"

namespace polar_torch {

// op kinds of the schedule table [n_ops, 3] = (kind, stage, lo); the codes
// of z/f/i are those of the SCL kernel's table
enum ScOpKind { SC_Z = 0, SC_F = 4, SC_I = 5, SC_T = 6 };

struct ScArgs {
  const float* a;          // [2^b, bs], column stride 1
  long long a_row_stride;  // elements
  const int32_t* frz;      // [2^b] (read by 't' ops only; may be null)
  const int32_t* sched;    // [n_ops, 3]
  int n_ops;
  int32_t* cw;             // [2^b, bs]
  float* lloc;             // [2^b - 1, bs] scratch
  int8_t* uloc;            // [2^b - 1, bs] scratch
  int b;
  int bs;
  float llr_max;
  int exact;               // 1: exact boxplus f, 0: min-sum f
};

PT_HD void sc_column(const ScArgs& A, int col) {
  const int b = A.b;
  const float m = A.llr_max;
  const size_t bs = (size_t)A.bs;
  auto row = [&](int s, int j) { return ((size_t)(1 << s) - 1 + j) * bs + col; };
  auto lread = [&](int s, int j) -> float {
    return s == b ? A.a[(long long)j * A.a_row_stride + col] : A.lloc[row(s, j)];
  };

  for (int op = 0; op < A.n_ops; ++op) {
    const int kind = A.sched[3 * op];
    const int s_nd = A.sched[3 * op + 1];
    const int lo = A.sched[3 * op + 2];
    const int w = 1 << s_nd;
    const int i_end = lo + w - 1;

    // ---- descent: down to the node root, or for a rate-0 node to one
    // stage above it (its stores still feed the sibling's g-read). Values
    // above the root are stored; the root value (a leaf's LLR) is kept.
    const int stop = kind == SC_Z ? s_nd + 1 : s_nd;
    float root = 0.0f;
    int s_from = b;
    if (lo != 0) {
      const int d = ctz(lo);
      s_from = d;
      if (d >= stop) {
        const int h = 1 << d;
        for (int j = 0; j < h; ++j) {
          const float v = g_op(lread(d + 1, j), lread(d + 1, j + h),
                               A.uloc[row(d, j)]);
          if (d > s_nd) A.lloc[row(d, j)] = v;
          else root = v;                       // a leaf: h == 1
        }
      }
    }
    for (int s = s_from; s > stop; --s) {
      const int h = 1 << (s - 1);
      for (int j = 0; j < h; ++j) {
        const float v = f_op(lread(s, j), lread(s, j + h), m, A.exact);
        if (s - 1 > s_nd) A.lloc[row(s - 1, j)] = v;
        else root = v;                         // a leaf: h == 1
      }
    }

    // ---- node: its partial sums go to the tail of the rise destination
    // (uloc stage r, or the codeword when the rise reaches stage b) ----
    const int r = cto(i_end);
    const int R = r < b ? r : b;
    const int Wd = 1 << R;
    auto put = [&](int k, int v) {
      if (r >= b) A.cw[(size_t)k * bs + col] = v;
      else A.uloc[row(r, k)] = (int8_t)v;
    };
    auto get = [&](int k) -> int {
      return r >= b ? (int)A.cw[(size_t)k * bs + col] : (int)A.uloc[row(r, k)];
    };
    int bit = 0;
    if (kind == SC_I || (kind == SC_T && A.frz[lo] == 0)) bit = root <= 0.0f;
    for (int j = 0; j < w; ++j) put(Wd - w + j, bit);   // 'z' / 'f': zeros

    // ---- rise: combine partial sums upward into the destination ----
    for (int s = s_nd; s < R; ++s) {
      const int h = 1 << s;
      const int base = Wd - 2 * h;
      for (int j = 0; j < h; ++j)
        put(base + j, (int)A.uloc[row(s, j)] ^ get(base + h + j));
    }
  }
}

}  // namespace polar_torch
