// Belief-propagation decode of one codeword (one batch column), shared by
// the CUDA kernel (bp.cu, nvcc for sm_90a) and a host build (bp_host.cpp,
// g++) that the CPU tests hold against the plain PyTorch version.
//
// Contract (polar_torch/models/polar/cuda_bp.py, bp_decode): given the true
// channel LLRs llr [n, bs] (positive means bit 0; negated on load when the
// caller hands logits) and the frozen prior [n] (+llr_max at frozen
// positions, 0 elsewhere), run num_iter BP sweeps over the message lattice
// and return the info-side total LLR out [n, bs] and, when asked, the
// G-matrix convergence flag done [bs] int32.
//
// Lattice: lmsg[s] / rmsg[s], s = 0..S, [n] each, stage s at offset s * n;
// rmsg follows lmsg. lmsg[S] holds the channel LLRs, rmsg[0] the prior.
// The stage-s processing element couples rows u and v = u + 2^s of every
// block of 2^(s+1) rows:
//     l_s[u]     = f(l_{s+1}[u], l_{s+1}[v] + r_s[v])
//     l_s[v]     = f(l_{s+1}[u], r_s[u]) + l_{s+1}[v]
//     r_{s+1}[u] = f(r_s[u], l_{s+1}[v] + r_s[v])
//     r_{s+1}[v] = f(r_s[u], l_{s+1}[u]) + r_s[v]
// A sweep updates l at stages S-1..0, then r at stages 0..S-1.
//
// Rounding: with scaled min-sum (msf != 1) f is msf * minsum. The l_v/r_v
// outputs round msf * minsum + v once (fmaf), as XLA contracts them on the
// CPU; the l_u/r_u outputs round the product alone (__fmul_rn on the
// device, which nvcc never contracts). So the result does not depend on
// -fmad, and min-sum is bit-equal to the JAX package's XLA engine. With
// msf == 1 or the exact boxplus there is no product to round.
//
// Early stop (early_stop != 0): every check_every sweeps the info-side hard
// decision (frozen rows forced to 0) is re-encoded by the XOR butterfly and
// compared with the channel-side hard decision; a codeword that passes
// stops there, since the JAX package freezes a converged lane and never
// touches it again. After the last full chunk the remaining
// num_iter % check_every sweeps run unchecked.
//
// The schedule is written once over a "team": on the card a CTA whose
// threads loop over the n/2 butterflies of a stage with __syncthreads()
// between stages; on the host one thread that loops over all of them, with
// a barrier that does nothing. Both run the same arithmetic in the same
// control flow.
#pragma once

#include "fg.cuh"

namespace polar_torch {

struct BpArgs {
  const float* llr;            // [n, bs], strides below, in elements
  long long llr_rs, llr_cs;
  const float* prior;          // [n]
  float* out;                  // [n, bs], strides below
  long long out_rs, out_cs;
  int32_t* done;               // [bs] or null
  float* lattice;              // [bs, 2 (S + 1) n] global scratch, or null
  int S;
  int bs;
  int num_iter;
  int check_every;
  int early_stop;
  int exact;                   // 1: exact boxplus, 0: min-sum
  int negate;                  // 1: llr holds logits (negative means bit 0)
  float msf;                   // min-sum scale (ignored in exact mode)
  float llr_max;
};

// floats of one codeword's lattice (lmsg and rmsg)
PT_HD PT_INLINE long long bp_lattice_elems(int S) {
  return 2LL * (S + 1) * (1LL << S);
}

struct SerialTeam {
  PT_HD int rank() const { return 0; }
  PT_HD int size() const { return 1; }
  PT_HD void sync() const {}
  PT_HD bool all(bool x) const { return x; }
};

// one CTA; written host-callable so the template needs no __device__-only
// calls, but only the device pass reaches the CUDA builtins
struct CtaTeam {
  PT_HD int rank() const {
#ifdef __CUDA_ARCH__
    return threadIdx.x;
#else
    return 0;
#endif
  }
  PT_HD int size() const {
#ifdef __CUDA_ARCH__
    return blockDim.x;
#else
    return 1;
#endif
  }
  PT_HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }
  PT_HD bool all(bool x) const {
#ifdef __CUDA_ARCH__
    return __syncthreads_and(x) != 0;
#else
    return x;
#endif
  }
};

// a * b rounded once, never contracted into a following add
PT_HD PT_INLINE float mul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

// first row of butterfly j at stage s
PT_HD PT_INLINE int bp_upper(int j, int s) {
  return ((j >> s) << (s + 1)) | (j & ((1 << s) - 1));
}

// one stage: l at stage s (left) or r at stage s + 1 (right)
template <class Team>
PT_HD PT_INLINE void bp_stage(const Team& t, const BpArgs& A, float* lm,
                              float* rm, int s, bool left) {
  const int n = 1 << A.S;
  const int span = 1 << s;
  const float m = A.llr_max;
  const bool scaled = !A.exact && A.msf != 1.0f;
  const float* l1 = lm + (long long)(s + 1) * n;
  const float* r0 = rm + (long long)s * n;
  float* dst = left ? lm + (long long)s * n : rm + (long long)(s + 1) * n;
  for (int j = t.rank(); j < n / 2; j += t.size()) {
    const int u = bp_upper(j, s);
    const int v = u + span;
    const float lu = l1[u], lv = l1[v], ru = r0[u], rv = r0[v];
    // left: f(lu, lv + rv) and f(lu, ru) + lv; right: f(ru, lv + rv) and
    // f(ru, lu) + rv
    const float a = left ? lu : ru;
    const float fu = f_op(a, lv + rv, m, A.exact);
    const float fv = f_op(a, left ? ru : lu, m, A.exact);
    const float add = left ? lv : rv;
    dst[u] = scaled ? mul_rn(A.msf, fu) : fu;
    dst[v] = scaled ? fmaf(A.msf, fv, add) : fv + add;
  }
  t.sync();
}

template <class Team>
PT_HD PT_INLINE void bp_sweep(const Team& t, const BpArgs& A, float* lm,
                              float* rm) {
  for (int s = A.S - 1; s >= 0; --s) bp_stage(t, A, lm, rm, s, true);
  for (int s = 0; s < A.S; ++s) bp_stage(t, A, lm, rm, s, false);
}

// G-matrix check: re-encode the info-side decision and compare it with the
// channel-side one; bits is n bytes of scratch. Uniform over the team.
template <class Team>
PT_HD PT_INLINE bool bp_converged(const Team& t, const BpArgs& A,
                                  const float* lm, const float* rm,
                                  uint8_t* bits) {
  const int n = 1 << A.S;
  for (int i = t.rank(); i < n; i += t.size())
    bits[i] = rm[i] > 0.0f ? 0 : (lm[i] + rm[i] <= 0.0f);
  t.sync();
  for (int s = 0; s < A.S; ++s) {
    for (int j = t.rank(); j < n / 2; j += t.size()) {
      const int u = bp_upper(j, s);
      bits[u] ^= bits[u + (1 << s)];
    }
    t.sync();
  }
  const float* lS = lm + (long long)A.S * n;
  const float* rS = rm + (long long)A.S * n;
  bool ok = true;
  for (int i = t.rank(); i < n; i += t.size())
    ok = ok && bits[i] == (lS[i] + rS[i] <= 0.0f);
  return t.all(ok);
}

// decode column col with its lattice at lat (2 (S + 1) n floats) and n
// bytes of scratch at bits
template <class Team>
PT_HD PT_INLINE void bp_column(const Team& t, const BpArgs& A, int col,
                               float* lat, uint8_t* bits) {
  const int n = 1 << A.S;
  float* lm = lat;
  float* rm = lat + (long long)(A.S + 1) * n;
  const float sign = A.negate ? -1.0f : 1.0f;
  for (int i = t.rank(); i < n; i += t.size()) {
    lm[(long long)A.S * n + i] = sign * A.llr[i * A.llr_rs + col * A.llr_cs];
    rm[i] = A.prior[i];
    for (int s = 1; s <= A.S; ++s) rm[(long long)s * n + i] = 0.0f;
  }
  t.sync();

  bool done = false;
  int left = A.num_iter;
  if (A.early_stop) {
    for (int c = 0; c < A.num_iter / A.check_every && !done; ++c) {
      for (int k = 0; k < A.check_every; ++k) bp_sweep(t, A, lm, rm);
      left -= A.check_every;
      done = bp_converged(t, A, lm, rm, bits);
    }
  }
  if (!done)
    for (; left > 0; --left) bp_sweep(t, A, lm, rm);

  for (int i = t.rank(); i < n; i += t.size())
    A.out[i * A.out_rs + col * A.out_cs] = lm[i] + rm[i];
  if (A.done != nullptr && t.rank() == 0) A.done[col] = done ? 1 : 0;
}

}  // namespace polar_torch
