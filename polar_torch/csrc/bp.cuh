// Belief-propagation decode of one codeword (one batch column) by one CTA,
// shared by the CUDA kernel (bp.cu, nvcc for sm_90a) and a host build
// (bp_host.cpp, g++) that the CPU tests hold against the plain PyTorch
// version.
//
// Contract (polar_torch/models/polar/cuda_bp.py, bp_decode): given the true
// channel LLRs llr [n, bs] (positive means bit 0; negated on load when the
// caller hands logits) and the frozen prior [n] (+llr_max at frozen
// positions, 0 elsewhere), run num_iter BP sweeps over the message lattice
// and return the info-side total LLR out [n, bs] and, when asked, the
// G-matrix convergence flag done [bs] int32 and the sweeps each codeword
// ran, sweeps [bs] int32 (num_iter where no check passed).
//
// Lattice: lmsg[s] / rmsg[s], s = 0..S, [n] each. lmsg[S] holds the channel
// LLRs, rmsg[0] the prior. The stage-s processing element couples rows u
// and v = u + 2^s of every block of 2^(s+1) rows:
//     l_s[u]     = f(l_{s+1}[u], l_{s+1}[v] + r_s[v])
//     l_s[v]     = f(l_{s+1}[u], r_s[u]) + l_{s+1}[v]
//     r_{s+1}[u] = f(r_s[u], l_{s+1}[v] + r_s[v])
//     r_{s+1}[v] = f(r_s[u], l_{s+1}[u]) + r_s[v]
// A sweep updates l at stages S-1..0, then r at stages 0..S-1. Every value
// depends only on values of the stage pair it reads, so any schedule that
// keeps that order per value computes the same numbers.
//
// Rounding: with scaled min-sum (msf != 1) f is msf * minsum. The l_v/r_v
// outputs round msf * minsum + v once (fmaf), as XLA contracts them on the
// CPU; the l_u/r_u outputs round the product alone (__fmul_rn on the
// device, which nvcc never contracts). So the result does not depend on
// -fmad, and min-sum is bit-equal to the JAX package's XLA engine. With
// msf == 1 or the exact boxplus there is no product to round.
//
// The bf16 message lattice (the kBf16 instance): the lattice holds bf16
// values, 16 bits each in shared memory and in the global scratch, and the
// lanes' registers hold f32 values that are bf16 values. Every add,
// product, expf and log1pf of a processing element rounds to bf16 on its
// own, as XLA runs bf16 on the CPU: l_v/r_v round msf * minsum, then the
// add (no fmaf); the sums l + r of the check and the output are rounded;
// the channel LLR, the prior, llr_max and msf are rounded on load. The
// rounding is integer arithmetic on the float's bits (fg.cuh bf16_round),
// so the host build and the card round alike and no native bf16
// instruction is used. Min-sum is then bit-equal to the JAX package's
// bf16 XLA engine; exact mode rounds differently only where expf/log1pf
// differ by an ulp before the rounding.
//
// Early stop (early_stop != 0): every check_every sweeps the info-side hard
// decision (frozen rows forced to 0) is re-encoded by the XOR butterfly and
// compared with the channel-side hard decision; a codeword that passes
// stops there, since the JAX package freezes a converged lane and never
// touches it again. After the last full chunk the remaining
// num_iter % check_every sweeps run unchecked.
//
// Schedule. Rows are cut into blocks of 64; lane k of a warp owns rows
// 2k and 2k + 1 of each of its blocks. The partners of stages 0..4 then lie
// in the same lane (stage 0) or in lane k ^ 2^(s-1) of the same warp, so
// those "warp stages" exchange through shuffles with no CTA barrier (a lane
// and its partner compute one of their two elements each), and
// their interior messages (l and r at stages 0..Sw-1, Sw = min(S, 5)) stay
// in the lane's registers from sweep to sweep ("resident"); only stages
// Sw..S sit in shared memory. The "CTA stages" Sw..S-1 run one at a time,
// a thread on one row pair of the stage, with a CTA barrier after each.
// Where the whole lattice lives in the global scratch (n >= 4096 or
// a forced global form), the warp stages' messages are loaded from and
// stored to the scratch around each use instead of staying resident, and
// the schedule is otherwise the same. The check packs a warp's hard
// decisions with ballots, runs the XOR butterfly's stages 1..5 as shifts
// and masks within 32-bit words and the upper ones as XORs of words.
//
// The routine is written over a "team" policy: on the card one CTA (a
// thread per lane, shuffles, ballots, __syncthreads); on the host one
// thread that runs every lane in turn between barriers, reading a partner
// lane's values from its state where the card shuffles. Both run the same
// arithmetic in the same control flow.
#pragma once

#include "fg.cuh"

namespace polar_torch {

constexpr int kBpMaxThreads = 512;
constexpr int kBpWarpStages = 5;      // stages whose partners share a warp
constexpr int kBpRows = 64;           // rows of a block (2 per lane)
// the shared form up to n = 2^11: beyond it a warp would keep more than
// two blocks' warp-stage messages in registers
constexpr int kBpMaxSharedS = 11;

struct BpArgs {
  const float* llr;            // [n, bs], strides below, in elements
  long long llr_rs, llr_cs;
  const float* prior;          // [n]
  float* out;                  // [n, bs], strides below
  long long out_rs, out_cs;
  int32_t* done;               // [bs] or null
  int32_t* sweeps;             // [bs] or null: the sweeps a codeword ran
  void* lattice;               // [bs, 2 (S + 1) n] global scratch of the
                               // message type, or null
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

// floats of one codeword's whole lattice (lmsg and rmsg): the global form
PT_HD PT_INLINE long long bp_lattice_elems(int S) {
  return 2LL * (S + 1) * (1LL << S);
}

PT_HD PT_INLINE int bp_warp_stages(int S) {
  return S < kBpWarpStages ? S : kBpWarpStages;
}

PT_HD PT_INLINE int bp_blocks(int S) {
  return S >= 6 ? 1 << (S - 6) : 1;
}

// floats of the shared form's lattice: stages Sw..S of lmsg and rmsg
PT_HD PT_INLINE long long bp_shared_elems(int S) {
  return 2LL * (S - bp_warp_stages(S) + 1) * (1LL << S);
}

// the launch: threads of the CTA and 64-row blocks per warp. The shared
// form keeps one block resident per warp, or two where one would take more
// than 512 threads (n = 2048); the global form runs 512 threads at most and
// loops over its blocks.
struct BpPlan {
  int threads;
  int warp_blocks;
};

// the shared form with kb blocks resident per warp (at most the blocks)
PT_HD PT_INLINE BpPlan bp_shared_plan(int S, int kb) {
  const int blocks = bp_blocks(S);
  if (kb > blocks) kb = blocks;
  return {blocks / kb * 32, kb};
}

PT_HD PT_INLINE BpPlan bp_plan(int S, bool shared) {
  const int blocks = bp_blocks(S);
  if (shared)
    return bp_shared_plan(S, blocks * 32 > kBpMaxThreads
                                 ? blocks * 32 / kBpMaxThreads : 1);
  int warps = blocks < kBpMaxThreads / 32 ? blocks : kBpMaxThreads / 32;
  return {warps * 32, blocks / warps};
}

// bytes of dynamic shared memory: the shared lattice (if any) of
// msg_bytes-byte messages and the check's four words per block
PT_HD PT_INLINE long long bp_smem_bytes(int S, bool shared, int msg_bytes) {
  return (shared ? (long long)msg_bytes * bp_shared_elems(S) : 0)
      + 16LL * bp_blocks(S);
}

// bits k of a 32-bit word whose bit s is clear: the upper rows of the
// XOR butterfly's stage s + 1 in a word of every other row
PT_HD PT_INLINE uint32_t bp_word_mask(int s) {
  switch (s) {
    case 0: return 0x55555555u;
    case 1: return 0x33333333u;
    case 2: return 0x0f0f0f0fu;
    case 3: return 0x00ff00ffu;
    default: return 0x0000ffffu;
  }
}

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

// the lattice's message type: T in memory, ld/st between T and the f32
// registers, rnd the rounding after an op
template <bool kBf16>
struct BpMsg {
  using T = float;
  PT_HD static PT_INLINE float ld(float x) { return x; }
  PT_HD static PT_INLINE float st(float x) { return x; }
  PT_HD static PT_INLINE float rnd(float x) { return x; }
};

// bf16 as its 16 bits; every value stored is already a bf16 value, so the
// store keeps the upper half of its float
template <>
struct BpMsg<true> {
  using T = uint16_t;
  PT_HD static PT_INLINE float ld(uint16_t b) {
    return f32_of((uint32_t)b << 16);
  }
  PT_HD static PT_INLINE uint16_t st(float x) {
    return (uint16_t)(f32_bits(x) >> 16);
  }
  PT_HD static PT_INLINE float rnd(float x) { return bf16_round(x); }
};

// the u output f(a, y) and the v output f(a, b) + add of a processing
// element, with the rounding of the header note
template <bool kBf16>
struct BpOps {
  using M = BpMsg<kBf16>;
  float m, msf;
  int exact;
  bool scaled;
  PT_HD PT_INLINE float f(float a, float b) const {
    if constexpr (kBf16) return exact ? f_exact_bf16(a, b, m)
                                      : minsum(a, b, m);
    else return f_op(a, b, m, exact);
  }
  PT_HD PT_INLINE float u(float a, float y) const {
    const float fy = f(a, y);
    return scaled ? M::rnd(mul_rn(msf, fy)) : fy;
  }
  // bf16: the product's rounding (integer ops) stands between the product
  // and the add, so no contraction can fuse them
  PT_HD PT_INLINE float v(float a, float b, float add) const {
    const float fb = f(a, b);
    if constexpr (kBf16)
      return M::rnd((scaled ? M::rnd(mul_rn(msf, fb)) : fb) + add);
    else return scaled ? fmaf(msf, fb, add) : fb + add;
  }
  // one element on rows (u, v): left writes l_s, right r_{s+1}
  PT_HD PT_INLINE void pe(bool left, float lu, float lv, float ru, float rv,
                          float& du, float& dv) const {
    const float a = left ? lu : ru;
    du = u(a, M::rnd(lv + rv));
    dv = v(a, left ? ru : lu, left ? lv : rv);
  }
};

// one codeword's lattice stages lo..S (l then r), each n messages
template <class T>
struct BpLattice {
  T* l;
  T* r;
  int lo, n;
  PT_HD PT_INLINE T* L(int s) const { return l + (long long)(s - lo) * n; }
  PT_HD PT_INLINE T* R(int s) const { return r + (long long)(s - lo) * n; }
};

// one lane's messages at the warp stages of its kB resident blocks: index
// [block][stage][row]; stage Sw holds the top boundary while a sweep runs
template <int kB>
struct BpLane {
  float l[kB][kBpWarpStages + 1][2];
  float r[kB][kBpWarpStages + 1][2];
  float own, give;      // a warp stage's outputs: own row, partner's row
  uint32_t bits;        // the check's predicates (compute_bits)
  int ok;
};

#define PT_FOR_LANES(t) for (int i_ = 0; i_ < (t).per(); ++i_)

template <class Team, int kB, bool kRes, bool kBf16>
struct BpCodeword {
  using M = BpMsg<kBf16>;
  using T = typename M::T;
  const Team& t;
  const BpArgs& A;
  BpLane<kB>* ln;       // the lanes this thread runs (t.per() of them)
  BpLattice<T> lat;     // stages lat.lo..S (the global form: 0..S)
  uint32_t* words;      // [blocks][4]: the check's words
  int col, n, Sw, blocks, warps, nb;
  BpOps<kBf16> ops;

  PT_HD PT_INLINE int lane(int i) const { return t.tid(i) & 31; }
  PT_HD PT_INLINE int warp(int i) const { return t.tid(i) >> 5; }
  // row j (0, 1) of lane i in its k-th block; -1 past n
  PT_HD PT_INLINE int row(int i, int k, int j) const {
    const int r = (warp(i) + k * warps) * kBpRows + 2 * lane(i) + j;
    return r < n ? r : -1;
  }

  // ---- the warp stages of one block ----
  // stage s of the l (left) or r pass on block slot kk of every lane
  PT_HD PT_INLINE void warp_stage(int kk, int s, bool left) const {
    if (s == 0) {                 // both rows in the lane
      PT_FOR_LANES(t) {
        BpLane<kB>& x = ln[i_];
        float du, dv;
        ops.pe(left, x.l[kk][1][0], x.l[kk][1][1], x.r[kk][0][0],
               x.r[kk][0][1], du, dv);
        if (left) {
          x.l[kk][0][0] = du;
          x.l[kk][0][1] = dv;
        } else {
          x.r[kk][1][0] = du;
          x.r[kk][1][1] = dv;
        }
      }
      return;
    }
    // stage s >= 1: lane k and its partner k ^ 2^(s-1) share two
    // elements, one per row slot j; the upper lane computes the element of
    // slot 0, the lower lane that of slot 1, each from its own row and the
    // partner's (one shuffle each of l and r), and hands the partner the
    // output on the partner's row (a third shuffle)
    const int m = 1 << (s - 1);
    PT_FOR_LANES(t) {
      BpLane<kB>& x = ln[i_];
      const BpLane<kB>& y = ln[t.partner(i_, m)];
      const bool up = (lane(i_) & m) == 0;
      const float l0 = x.l[kk][s + 1][0], l1 = x.l[kk][s + 1][1];
      const float r0 = x.r[kk][s][0], r1 = x.r[kk][s][1];
      // send slot up ? 1 : 0, receive the partner's slot up ? 0 : 1
      const float pl = t.peer(up ? l1 : l0, up ? y.l[kk][s + 1][0]
                                               : y.l[kk][s + 1][1], m);
      const float pr = t.peer(up ? r1 : r0, up ? y.r[kk][s][0]
                                               : y.r[kk][s][1], m);
      const float ml = up ? l0 : l1, mr = up ? r0 : r1;
      float du, dv;
      ops.pe(left, up ? ml : pl, up ? pl : ml, up ? mr : pr, up ? pr : mr,
             du, dv);
      x.own = up ? du : dv;
      x.give = up ? dv : du;
    }
    PT_FOR_LANES(t) {
      BpLane<kB>& x = ln[i_];
      const bool up = (lane(i_) & m) == 0;
      const float got = t.peer(x.give, ln[t.partner(i_, m)].give, m);
      const float o0 = up ? x.own : got, o1 = up ? got : x.own;
      if (left) {
        x.l[kk][s][0] = o0;
        x.l[kk][s][1] = o1;
      } else {
        x.r[kk][s + 1][0] = o0;
        x.r[kk][s + 1][1] = o1;
      }
    }
  }

  // the global form: the lanes' warp-stage messages of block k from and to
  // the scratch
  PT_HD PT_INLINE void move_state(int k, bool load) const {
    PT_FOR_LANES(t) {
      BpLane<kB>& x = ln[i_];
#pragma unroll
      for (int s = 0; s < kBpWarpStages; ++s) {
        if (s >= Sw) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = row(i_, k, j);
          if (r < 0) continue;
          if (load) {
            x.l[0][s][j] = M::ld(lat.L(s)[r]);
            x.r[0][s][j] = M::ld(lat.R(s)[r]);
          } else {
            lat.L(s)[r] = M::st(x.l[0][s][j]);
            lat.R(s)[r] = M::st(x.r[0][s][j]);
          }
        }
      }
    }
  }

  // l_Sw of block k into its lanes' slot kk (the top of the warp stages)
  PT_HD PT_INLINE void load_top(int k, int kk) const {
    PT_FOR_LANES(t) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = row(i_, k, j);
        const float v = r < 0 ? 0.0f : M::ld(lat.L(Sw)[r]);
        // constant indices only, so the lane's arrays stay in registers
#pragma unroll
        for (int s = 1; s <= kBpWarpStages; ++s)
          if (s == Sw) ln[i_].l[kk][s][j] = v;
      }
    }
  }
  // r_Sw of block k from its lanes' slot kk
  PT_HD PT_INLINE void store_top(int k, int kk) const {
    PT_FOR_LANES(t) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = row(i_, k, j);
        float v = 0.0f;
#pragma unroll
        for (int s = 1; s <= kBpWarpStages; ++s)
          if (s == Sw) v = ln[i_].r[kk][s][j];
        if (r >= 0) lat.R(Sw)[r] = M::st(v);
      }
    }
  }

  // both passes of the warp stages, for every block of each warp; reads
  // l_Sw, writes r_Sw. Resident blocks run stage by stage side by side,
  // so their chains overlap; the global form runs one block at a time
  // through slot 0.
  PT_HD PT_INLINE void warp_sweep() const {
    if constexpr (kRes) {
#pragma unroll
      for (int k = 0; k < kB; ++k) load_top(k, k);
#pragma unroll
      for (int s = kBpWarpStages - 1; s >= 0; --s)
#pragma unroll
        for (int k = 0; k < kB; ++k)
          if (s < Sw) warp_stage(k, s, true);
#pragma unroll
      for (int s = 0; s < kBpWarpStages; ++s)
#pragma unroll
        for (int k = 0; k < kB; ++k)
          if (s < Sw) warp_stage(k, s, false);
#pragma unroll
      for (int k = 0; k < kB; ++k) store_top(k, k);
    } else {
      for (int k = 0; k < nb; ++k) {
        move_state(k, true);
        load_top(k, 0);
#pragma unroll
        for (int s = kBpWarpStages - 1; s >= 0; --s)
          if (s < Sw) warp_stage(0, s, true);
#pragma unroll
        for (int s = 0; s < kBpWarpStages; ++s)
          if (s < Sw) warp_stage(0, s, false);
        store_top(k, 0);
        move_state(k, false);
      }
    }
  }

  // ---- the CTA stages ----
  // stage s, one element per row pair
  PT_HD PT_INLINE void cta_single(int s, bool left) const {
    const T* l1 = lat.L(s + 1);
    const T* r0 = lat.R(s);
    T* dst = left ? lat.L(s) : lat.R(s + 1);
    PT_FOR_LANES(t) {
      for (int j = t.tid(i_); j < n / 2; j += t.size()) {
        const int u = bp_upper(j, s), v = u + (1 << s);
        if constexpr (kBf16) {
          float du, dv;
          ops.pe(left, M::ld(l1[u]), M::ld(l1[v]), M::ld(r0[u]),
                 M::ld(r0[v]), du, dv);
          dst[u] = M::st(du);
          dst[v] = M::st(dv);
        } else {
          ops.pe(left, l1[u], l1[v], r0[u], r0[v], dst[u], dst[v]);
        }
      }
    }
  }

  // one sweep: l at the CTA stages S-1..Sw, each followed by a barrier,
  // the warp stages, then r at Sw..S-1. No barrier follows the last r
  // stage: the next sweep's first stage reads what the same thread wrote,
  // and the check starts with a barrier.
  PT_HD PT_INLINE void sweep() const {
    const int S = A.S;
    for (int s = S - 1; s >= Sw; --s) {
      cta_single(s, true);
      t.sync();
    }
    warp_sweep();
    if (Sw < S) t.sync();
    for (int s = Sw; s < S; ++s) {
      cta_single(s, false);
      if (s < S - 1) t.sync();
    }
  }

  // l_0 + r_0 of row j of lane i's k-th block
  PT_HD PT_INLINE float total0(int i, int k, int j) const {
    if constexpr (kRes) {
      return M::rnd(ln[i].l[k][0][j] + ln[i].r[k][0][j]);
    } else {
      const int r = row(i, k, j);
      return M::rnd(M::ld(lat.L(0)[r]) + M::ld(lat.R(0)[r]));
    }
  }
  PT_HD PT_INLINE float prior0(int i, int k, int j) const {
    if constexpr (kRes) return ln[i].r[k][0][j];
    else return M::ld(lat.R(0)[row(i, k, j)]);
  }

  // lane i's predicates in block k, as bits of ln[i].bits: 0, the even
  // row's info-side decision after the XOR butterfly's stage 0 (row 2k ^=
  // row 2k + 1), 1 the odd row's; 2, 3 the channel-side decisions
  PT_HD PT_INLINE void compute_bits(int i, int k) const {
    bool u[2], x[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = row(i, k, j);
      u[j] = r >= 0 && !(prior0(i, k, j) > 0.0f) && total0(i, k, j) <= 0.0f;
      x[j] = r >= 0 && channel_total(r) <= 0.0f;
    }
    ln[i].bits = (uint32_t)(u[0] != u[1]) | (uint32_t)u[1] << 1
        | (uint32_t)x[0] << 2 | (uint32_t)x[1] << 3;
  }

  // the G-matrix check; uniform over the CTA
  PT_HD PT_INLINE bool converged() const {
    const int S = A.S;
    t.sync();
    const int nblk = kRes ? kB : nb;
    // the words of every block: the info side through the XOR butterfly's
    // stages 0..5 (shifts and masks within a word), the channel side
#pragma unroll
    for (int k = 0; k < nblk; ++k) {
      PT_FOR_LANES(t) compute_bits(i_, k);
      PT_FOR_LANES(t) {
        uint32_t e = t.ballot(ln, i_, 0), o = t.ballot(ln, i_, 1);
        const uint32_t xe = t.ballot(ln, i_, 2), xo = t.ballot(ln, i_, 3);
        for (int s = 1; s < S && s <= kBpWarpStages; ++s) {
          const int sh = 1 << (s - 1);
          e ^= (e >> sh) & bp_word_mask(s - 1);
          o ^= (o >> sh) & bp_word_mask(s - 1);
        }
        if (lane(i_) == 0) {
          uint32_t* w = words + 4 * (warp(i_) + k * warps);
          w[0] = e; w[1] = o; w[2] = xe; w[3] = xo;
        }
      }
    }
    t.sync();
    // warp 0: the XOR stages 6..S-1 across blocks, then the comparison
    for (int s = kBpWarpStages + 1; s < S; ++s) {
      PT_FOR_LANES(t) {
        if (warp(i_) != 0) continue;
        for (int p = lane(i_); p < blocks / 2; p += 32) {
          const int bk = bp_upper(p, s - kBpWarpStages - 1);
          const int bh = bk + (1 << (s - kBpWarpStages - 1));
          words[4 * bk] ^= words[4 * bh];
          words[4 * bk + 1] ^= words[4 * bh + 1];
        }
      }
      t.warp_sync();
    }
    PT_FOR_LANES(t) {
      bool ok = true;
      if (warp(i_) == 0)
        for (int bk = lane(i_); bk < blocks; bk += 32)
          ok = ok && words[4 * bk] == words[4 * bk + 2]
                  && words[4 * bk + 1] == words[4 * bk + 3];
      ln[i_].ok = ok;
    }
    return t.all(ln);
  }

  // l_S + r_S of row r (the channel-side total)
  PT_HD PT_INLINE float channel_total(int r) const {
    return M::rnd(M::ld(lat.L(A.S)[r]) + M::ld(lat.R(A.S)[r]));
  }

  PT_HD PT_INLINE void run() {
    const int S = A.S;
    const float sign = A.negate ? -1.0f : 1.0f;
    // lattice stages lat.lo..S: l_S the channel, the rest 0 (r_0 the prior
    // where the global form keeps it)
    PT_FOR_LANES(t) {
      for (int i = t.tid(i_); i < n; i += t.size()) {
        for (int s = lat.lo; s < S; ++s) lat.L(s)[i] = M::st(0.0f);
        lat.L(S)[i] = M::st(M::rnd(sign * A.llr[i * A.llr_rs
                                                + col * A.llr_cs]));
        for (int s = lat.lo; s <= S; ++s)
          lat.R(s)[i] = M::st(s == 0 ? M::rnd(A.prior[i]) : 0.0f);
      }
      if (kRes) {
        BpLane<kB>& x = ln[i_];
#pragma unroll
        for (int k = 0; k < kB; ++k)
#pragma unroll
          for (int s = 0; s <= kBpWarpStages; ++s)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int r = row(i_, k, j);
              x.l[k][s][j] = 0.0f;
              x.r[k][s][j] = s == 0 && r >= 0 ? M::rnd(A.prior[r]) : 0.0f;
            }
      }
    }
    t.sync();

    bool done = false;
    int left = A.num_iter;
    if (A.early_stop) {
      for (int c = 0; c < A.num_iter / A.check_every && !done; ++c) {
        for (int k = 0; k < A.check_every; ++k) sweep();
        left -= A.check_every;
        done = converged();
      }
    }
    if (!done)
      for (; left > 0; --left) sweep();

    const int nblk = kRes ? kB : nb;
    PT_FOR_LANES(t) {
#pragma unroll
      for (int k = 0; k < nblk; ++k)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = row(i_, k, j);
          if (r >= 0)
            A.out[r * A.out_rs + col * A.out_cs] = total0(i_, k, j);
        }
      if (A.done != nullptr && t.tid(i_) == 0) A.done[col] = done ? 1 : 0;
      if (A.sweeps != nullptr && t.tid(i_) == 0)
        A.sweeps[col] = A.num_iter - left;
    }
  }
};

#undef PT_FOR_LANES

// the CTA on the host: one thread runs the T lanes in turn; a shuffle reads
// the partner lane's state, a ballot the predicates of the warp's lanes
struct BpHostTeam {
  int T;
  PT_HD int per() const { return T; }
  PT_HD int tid(int i) const { return i; }
  PT_HD int size() const { return T; }
  PT_HD void sync() const {}
  PT_HD void warp_sync() const {}
  PT_HD int partner(int i, int m) const { return i ^ m; }
  PT_HD float peer(float, float other, int) const { return other; }
  // bit q of the bits of lane i's warp
  template <class Lane>
  PT_HD uint32_t ballot(const Lane* x, int i, int q) const {
    uint32_t w = 0;
    const int base = i & ~31;
    for (int j = 0; j < 32 && base + j < T; ++j)
      w |= ((x[base + j].bits >> q) & 1u) << j;
    return w;
  }
  template <class Lane>
  PT_HD bool all(const Lane* x) const {
    bool ok = true;
    for (int i = 0; i < T; ++i) ok = ok && x[i].ok;
    return ok;
  }
};

// decode column col. lat: the shared form's stages Sw..S (kRes), or the
// whole global lattice (2 (S + 1) n messages); words: 4 per block of
// scratch. kBf16: the bf16 lattice (msf and llr_max rounded to bf16, as
// the JAX package casts them).
template <int kB, bool kRes, bool kBf16, class Team>
PT_HD PT_INLINE void bp_column(const Team& t, const BpArgs& A, int col,
                               typename BpMsg<kBf16>::T* lat,
                               uint32_t* words, BpLane<kB>* lanes) {
  using M = BpMsg<kBf16>;
  const int n = 1 << A.S;
  const int Sw = bp_warp_stages(A.S);
  const int blocks = bp_blocks(A.S);
  const int warps = (t.size() + 31) / 32;
  const int lo = kRes ? Sw : 0;
  const long long stages = A.S - lo + 1;
  const BpLattice<typename M::T> l{lat, lat + stages * n, lo, n};
  const float msf = M::rnd(A.msf);
  const BpOps<kBf16> ops{M::rnd(A.llr_max), msf, A.exact,
                         !A.exact && msf != 1.0f};
  BpCodeword<Team, kB, kRes, kBf16> cw{t, A, lanes, l, words, col, n, Sw,
                                       blocks, warps, blocks / warps, ops};
  cw.run();
}

}  // namespace polar_torch
