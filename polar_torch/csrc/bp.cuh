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
// The bf16 message lattice (the kBf16 instances): the lattice holds bf16
// values, 16 bits each in shared memory and in the global scratch, and the
// threads' registers hold f32 values that are bf16 values. Every add,
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
// Two schedules.
//
// The tiled form (BpTile; n <= 2048, the lattice in shared memory). The
// stages are cut into groups of three from stage 0, {0, 1, 2}, {3, 4, 5},
// ..., the last group taking the S mod 3 stages left. In each group a
// thread owns 8 rows: those whose indices differ only in the group's three
// bits (in the last group of fewer stages, the top three bits). Every
// processing element of the group's stages then couples two of the
// thread's own rows: 4 independent elements a stage, on registers with
// fixed indices, with no shuffle, select or address arithmetic. A group's
// interior messages (l and r at its inner levels) stay in the owning
// thread's registers from sweep to sweep, since no other thread reads them;
// shared memory holds only the levels between groups (l and r at 3, 6,
// ...) and l_S, the channel; the prior r_0 is a constant in registers. A
// sweep runs the groups' l passes top down and their r passes bottom up,
// with a CTA barrier between two groups: 2 (groups - 1) barriers a sweep.
// Group 0 runs its l pass and r pass back to back, and the top group its r
// pass and the next sweep's l pass, with no barrier between them. l_0 and
// r_S are read by the check and the output alone, so a sweep skips them and
// the check and the output compute them from what their stage read (l_1
// and r_0; r_{S-1} and l_S), which no later stage of the sweep changes.
// The levels in shared memory carry 16 bytes of padding after every 128,
// so that a warp's loads and stores of any group fall in distinct banks;
// group 0's 8 contiguous rows move as 16-byte vectors. The mode (scaled
// min-sum, min-sum, exact) and S are template parameters, so no processing
// element branches on them.
// The check: group 0's threads hold the info-side decisions of 8
// contiguous rows as 8 bits and run the XOR butterfly's stages 0..2 inside
// the thread, the stages of the lane bits by shuffles and those of the
// warp bits through a byte a thread in shared memory; the top group writes
// the channel-side decisions as a byte a row.
//
// The global form (BpCodeword; n >= 4096 or forced, the whole lattice in a
// global scratch). Rows are cut into blocks of 64; lane k of a warp owns
// rows 2k and 2k + 1 of each of its blocks. The partners of stages 0..4
// then lie in the same lane (stage 0) or in lane k ^ 2^(s-1) of the same
// warp, so those "warp stages" exchange through shuffles with no CTA
// barrier (a lane and its partner compute one of their two elements each);
// their messages are loaded from and stored to the scratch around each
// use. The "CTA stages" 5..S-1 run one at a time, a thread on one row
// pair of the stage, with a CTA barrier after each. The check packs a
// warp's hard decisions with ballots, runs the XOR butterfly's stages 1..5
// as shifts and masks within 32-bit words and the upper ones as XORs of
// words.
//
// Both are written over a "team" policy: on the card one CTA (a thread per
// lane, shuffles, ballots, __syncthreads); on the host one thread that runs
// every lane in turn between barriers, reading a partner lane's values from
// its state where the card shuffles. Both run the same arithmetic in the
// same control flow.
#pragma once

#include "fg.cuh"

namespace polar_torch {

constexpr int kBpMaxThreads = 512;    // the global form's CTA
constexpr int kBpWarpStages = 5;      // the global form: stages of a warp
constexpr int kBpRows = 64;           // the global form: rows of a block
constexpr int kBpMaxSharedS = 11;     // the tiled form up to n = 2^11

// the processing element's arithmetic: scaled min-sum, min-sum, the exact
// boxplus, or whichever the run's arguments ask for (the global form)
constexpr int kBpScaled = 0;
constexpr int kBpMinsum = 1;
constexpr int kBpExact = 2;
constexpr int kBpAnyMode = 3;

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

// ---- the tiled form's geometry ----
// the element offset of row r of a level in shared memory: 16 bytes of
// padding after every 128, so that the rows a warp of any group touches
// fall in distinct banks. Additive over rows of disjoint bits, so a
// thread's row offsets are its first row's plus constants.
template <bool kBf16>
PT_HD PT_INLINE constexpr int bp_pad(int r) {
  return kBf16 ? r + 8 * (r >> 6) : r + 4 * (r >> 5);
}

// groups of stages at 2^kS rows
template <int kS>
struct BpTiles {
  static constexpr int kN = 1 << kS;
  static constexpr int kRb = kS < 3 ? kS : 3;   // row bits a thread owns
  static constexpr int kR = 1 << kRb;           // rows a thread owns
  static constexpr int kT = kN >> kRb;          // threads of the CTA
  static constexpr int kWarps = (kT + 31) / 32;
  static constexpr int kGroups = (kS + 2) / 3;
  // group g runs stages lo(g)..hi(g) - 1 on rows that differ in bits
  // base(g)..base(g) + kRb - 1
  PT_HD static constexpr int lo(int g) { return 3 * g; }
  PT_HD static constexpr int hi(int g) {
    return 3 * g + 3 <= kS ? 3 * g + 3 : kS;
  }
  PT_HD static constexpr int base(int g) {
    return 3 * g + 3 <= kS ? 3 * g : kS - kRb;
  }
};

// CTAs an SM should hold (__launch_bounds__): three of 128 threads
PT_HD PT_INLINE constexpr int bp_tiled_ctas(int threads) {
  return threads >= 256 ? 1 : 384 / threads < 32 ? 384 / threads : 32;
}

// bytes of the tiled form's shared memory: the levels between groups (l and
// r) and l_S, padded, of msg_bytes-byte messages; the check's byte a row
// and byte a thread
PT_HD PT_INLINE long long bp_tiled_smem_bytes(int S, int msg_bytes) {
  const int n = 1 << S;
  const int rb = S < 3 ? S : 3;
  const int stride = msg_bytes == 2 ? bp_pad<true>(n) : bp_pad<false>(n);
  const long long levels = 2 * ((S + 2) / 3 - 1) + 1;
  const long long bytes = msg_bytes * levels * stride + n + (n >> rb);
  return (bytes + 15) / 16 * 16;
}

// the launch: threads of the CTA, CTA barriers a sweep, dynamic shared
// memory bytes. The global form runs 512 threads at most and loops over its
// 64-row blocks; its shared memory holds the check's four words a block.
struct BpPlan {
  int threads;
  int syncs;
  long long smem;
};

PT_HD PT_INLINE BpPlan bp_plan(int S, bool shared, int msg_bytes) {
  if (shared) {
    const int rb = S < 3 ? S : 3;
    return {(1 << S) >> rb, 2 * ((S + 2) / 3 - 1),
            bp_tiled_smem_bytes(S, msg_bytes)};
  }
  const int blocks = bp_blocks(S);
  const int warps = blocks < kBpMaxThreads / 32 ? blocks
                                                : kBpMaxThreads / 32;
  return {warps * 32, 2 * (S - bp_warp_stages(S)), 16LL * blocks};
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

// the mode of a run's arguments (msf rounded as the lattice's type rounds it)
template <bool kBf16>
PT_HD PT_INLINE int bp_mode(const BpArgs& A) {
  if (A.exact) return kBpExact;
  return BpMsg<kBf16>::rnd(A.msf) != 1.0f ? kBpScaled : kBpMinsum;
}

// the u output f(a, y) and the v output f(a, b) + add of a processing
// element, with the rounding of the header note; kMode fixes the
// arithmetic, or kBpAnyMode reads it from exact and scaled
template <bool kBf16, int kMode = kBpAnyMode>
struct BpOps {
  using M = BpMsg<kBf16>;
  float m, msf;
  int exact;
  bool scaled;
  PT_HD PT_INLINE bool is_exact() const {
    if constexpr (kMode == kBpAnyMode) return exact != 0;
    else return kMode == kBpExact;
  }
  PT_HD PT_INLINE bool is_scaled() const {
    if constexpr (kMode == kBpAnyMode) return scaled;
    else return kMode == kBpScaled;
  }
  PT_HD PT_INLINE float f(float a, float b) const {
    if constexpr (kBf16) return is_exact() ? f_exact_bf16(a, b, m)
                                           : minsum(a, b, m);
    else return f_op(a, b, m, is_exact());
  }
  PT_HD PT_INLINE float u(float a, float y) const {
    const float fy = f(a, y);
    return is_scaled() ? M::rnd(mul_rn(msf, fy)) : fy;
  }
  // bf16: the product's rounding (integer ops) stands between the product
  // and the add, so no contraction can fuse them
  PT_HD PT_INLINE float v(float a, float b, float add) const {
    const float fb = f(a, b);
    if constexpr (kBf16)
      return M::rnd((is_scaled() ? M::rnd(mul_rn(msf, fb)) : fb) + add);
    else return is_scaled() ? fmaf(msf, fb, add) : fb + add;
  }
  // one element on rows (u, v): left writes l_s, right r_{s+1}
  PT_HD PT_INLINE void pe(bool left, float lu, float lv, float ru, float rv,
                          float& du, float& dv) const {
    const float a = left ? lu : ru;
    du = u(a, M::rnd(lv + rv));
    dv = v(a, left ? ru : lu, left ? lv : rv);
  }
};

#define PT_FOR_LANES(t) for (int i_ = 0; i_ < (t).per(); ++i_)

// ---- the tiled form ----
// one thread's registers: a group's interior levels lo + 1, lo + 2 (l and
// r at the group's rows), the prior at group 0's rows, the check's bits
template <int kS>
struct BpTileLane {
  using P = BpTiles<kS>;
  float l[P::kGroups][2][P::kR];
  float r[P::kGroups][2][P::kR];
  float r0[P::kR];
  uint32_t bits, give;  // the check: the thread's bits, a shuffled copy
  int ok;
};

template <class Team, int kS, int kMode, bool kBf16>
struct BpTile {
  using P = BpTiles<kS>;
  using M = BpMsg<kBf16>;
  using T = typename M::T;
  using Lane = BpTileLane<kS>;
  static constexpr int kR = P::kR;
  static constexpr int kRb = P::kRb;
  static constexpr int kG = P::kGroups;
  static constexpr int kStride = bp_pad<kBf16>(P::kN);   // a level's elements
  static constexpr unsigned kMask =
      P::kT >= 32 ? 0xffffffffu : (1u << P::kT) - 1u;
  const Team& t;
  const BpArgs& A;
  Lane* ln;             // the lanes this thread runs (t.per() of them)
  T* lat;               // l, r at levels 3, 6, ... below S; then l_S
  uint8_t* xh;          // [n]: the channel-side decisions
  uint8_t* xb;          // [threads]: the info side's bits past the lanes
  int col;
  BpOps<kBf16, kMode> ops;

  // level lv's l or r (is_r) in shared memory
  PT_HD PT_INLINE T* level(int lv, bool is_r) const {
    return lat + (lv == kS ? 2 * (kG - 1) : 2 * (lv / 3 - 1) + is_r)
        * kStride;
  }
  // row j of thread tid in a group whose rows differ in bits B..B+kRb-1
  template <int B>
  PT_HD PT_INLINE static int row(int tid, int j) {
    return ((tid >> B) << (B + kRb)) | (j << B) | (tid & ((1 << B) - 1));
  }
  template <int B>
  PT_HD PT_INLINE static int first(int tid) {
    return bp_pad<kBf16>(row<B>(tid, 0));
  }

  // the thread's rows of a level (offset at of its first row): group 0's
  // 8 contiguous rows as 16-byte vectors, others one at a time
  template <int B>
  PT_HD PT_INLINE void load(float (&v)[kR], const T* a, int at) const {
#ifdef __CUDA_ARCH__
    if constexpr (B == 0 && kR == 8) {
      if constexpr (kBf16) {
        const uint4 q = *reinterpret_cast<const uint4*>(a + at);
        const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          v[2 * k] = f32_of(w[k] << 16);
          v[2 * k + 1] = f32_of(w[k] & 0xffff0000u);
        }
      } else {
        const float4 p = *reinterpret_cast<const float4*>(a + at);
        const float4 q = *reinterpret_cast<const float4*>(a + at + 4);
        v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
        v[4] = q.x; v[5] = q.y; v[6] = q.z; v[7] = q.w;
      }
      return;
    }
#endif
#pragma unroll
    for (int j = 0; j < kR; ++j) v[j] = M::ld(a[at + bp_pad<kBf16>(j << B)]);
  }
  template <int B>
  PT_HD PT_INLINE void store(T* a, const float (&v)[kR], int at) const {
#ifdef __CUDA_ARCH__
    if constexpr (B == 0 && kR == 8) {
      if constexpr (kBf16) {
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          w[k] = (uint32_t)M::st(v[2 * k])
              | (uint32_t)M::st(v[2 * k + 1]) << 16;
        *reinterpret_cast<uint4*>(a + at) = make_uint4(w[0], w[1], w[2],
                                                       w[3]);
      } else {
        *reinterpret_cast<float4*>(a + at) = make_float4(v[0], v[1], v[2],
                                                         v[3]);
        *reinterpret_cast<float4*>(a + at + 4) = make_float4(v[4], v[5],
                                                             v[6], v[7]);
      }
      return;
    }
#endif
#pragma unroll
    for (int j = 0; j < kR; ++j) a[at + bp_pad<kBf16>(j << B)] = M::st(v[j]);
  }

  // one stage on the thread's rows, bit k of the group: from l_{s+1} (il)
  // and r_s (ir) to l_s (left) or r_{s+1}
  template <bool kLeft>
  PT_HD PT_INLINE void stage(int k, const float (&il)[kR],
                             const float (&ir)[kR], float (&o)[kR]) const {
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      if (u & (1 << k)) continue;
      const int v = u | (1 << k);
      ops.pe(kLeft, il[u], il[v], ir[u], ir[v], o[u], o[v]);
    }
  }

  // group g's l pass (kL) and r pass (kRp) for lane i: l at stages
  // hi - 1..lo (but 0), then r at stages lo..hi - 1 (but S - 1)
  template <int g, bool kL, bool kRp>
  PT_HD PT_INLINE void pass(int i) const {
    constexpr int B = P::base(g), LO = P::lo(g), HI = P::hi(g);
    Lane& x = ln[i];
    const int at = first<B>(t.tid(i));
    float lv[4][kR], rv[4][kR];       // levels B..B + 3 at the thread's rows
    load<B>(lv[HI - B], level(HI, false), at);
#pragma unroll
    for (int s = LO + 1; s < HI; ++s)
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        lv[s - B][j] = x.l[g][s - LO - 1][j];
        rv[s - B][j] = x.r[g][s - LO - 1][j];
      }
    if constexpr (kL) {
      if constexpr (LO == 0) {
#pragma unroll
        for (int j = 0; j < kR; ++j) rv[0][j] = x.r0[j];
      } else {
        load<B>(rv[LO - B], level(LO, true), at);
      }
#pragma unroll
      for (int s = HI - 1; s >= LO; --s)
        if (s > 0) stage<true>(s - B, lv[s + 1 - B], rv[s - B], lv[s - B]);
      if constexpr (LO > 0) store<B>(level(LO, false), lv[LO - B], at);
    }
    if constexpr (kRp) {
      if constexpr (LO == 0) {
#pragma unroll
        for (int j = 0; j < kR; ++j) rv[0][j] = x.r0[j];
      } else {
        load<B>(rv[LO - B], level(LO, true), at);
      }
#pragma unroll
      for (int s = LO; s < HI; ++s)
        if (s < kS - 1)
          stage<false>(s - B, lv[s + 1 - B], rv[s - B], rv[s + 1 - B]);
      if constexpr (HI < kS) store<B>(level(HI, true), rv[HI - B], at);
    }
#pragma unroll
    for (int s = LO + 1; s < HI; ++s)
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        x.l[g][s - LO - 1][j] = lv[s - B][j];
        x.r[g][s - LO - 1][j] = rv[s - B][j];
      }
  }

  // the l passes of groups g..1, top down, a barrier after each
  template <int g>
  PT_HD PT_INLINE void l_down() const {
    if constexpr (g > 0) {
      PT_FOR_LANES(t) pass<g, true, false>(i_);
      t.sync();
      l_down<g - 1>();
    }
  }
  // the r passes of groups g..top, a barrier before each
  template <int g>
  PT_HD PT_INLINE void r_up() const {
    if constexpr (g < kG) {
      t.sync();
      PT_FOR_LANES(t) pass<g, false, true>(i_);
      r_up<g + 1>();
    }
  }
  PT_HD PT_INLINE void sweep() const {
    l_down<kG - 1>();
    PT_FOR_LANES(t) pass<0, true, true>(i_);
    r_up<1>();
  }

  // l_0 at lane i's rows of group 0: stage 0 of the l pass
  PT_HD PT_INLINE void l0(int i, float (&o)[kR]) const {
    const Lane& x = ln[i];
    float l1[kR];
    if constexpr (kS == 1) {
      load<0>(l1, level(1, false), first<0>(t.tid(i)));
    } else {
#pragma unroll
      for (int j = 0; j < kR; ++j) l1[j] = x.l[0][0][j];
    }
    stage<true>(0, l1, x.r0, o);
  }

  // l_S and r_S at lane i's rows of the top group: stage S - 1 of the r
  // pass
  PT_HD PT_INLINE void top(int i, float (&ls)[kR], float (&o)[kR]) const {
    constexpr int g = kG - 1, B = P::base(g), LO = P::lo(g);
    const Lane& x = ln[i];
    const int at = first<B>(t.tid(i));
    load<B>(ls, level(kS, false), at);
    float r1[kR];                        // r_{S-1}
    if constexpr (kS - 1 > LO) {
#pragma unroll
      for (int j = 0; j < kR; ++j) r1[j] = x.r[g][kS - 2 - LO][j];
    } else if constexpr (LO == 0) {
#pragma unroll
      for (int j = 0; j < kR; ++j) r1[j] = x.r0[j];
    } else {
      load<B>(r1, level(LO, true), at);
    }
    stage<false>(kS - 1 - B, ls, r1, o);
  }

  // the G-matrix check; uniform over the CTA. Follows a sweep, whose last
  // barrier orders the levels it reads.
  PT_HD PT_INLINE bool converged() const {
    constexpr int BT = P::base(kG - 1);
    PT_FOR_LANES(t) {
      Lane& x = ln[i_];
      const int tid = t.tid(i_);
      // the channel side at the top group's rows, a byte a row
      float ls[kR], rs[kR];
      top(i_, ls, rs);
#pragma unroll
      for (int j = 0; j < kR; ++j)
        xh[row<BT>(tid, j)] = M::rnd(ls[j] + rs[j]) <= 0.0f;
      // the info side at group 0's rows, through the XOR butterfly's
      // stages 0..kRb - 1
      float l0v[kR];
      l0(i_, l0v);
      uint32_t b = 0;
#pragma unroll
      for (int j = 0; j < kR; ++j)
        b |= (uint32_t)(!(x.r0[j] > 0.0f)
                        && M::rnd(l0v[j] + x.r0[j]) <= 0.0f) << j;
#pragma unroll
      for (int s = 0; s < kRb; ++s) b ^= (b >> (1 << s)) & bp_word_mask(s);
      x.bits = b;
    }
    // the stages of the lane bits: the upper lane takes the XOR
#pragma unroll
    for (int m = 1; m < (P::kT < 32 ? P::kT : 32); m <<= 1) {
      PT_FOR_LANES(t) ln[i_].give = ln[i_].bits;
      PT_FOR_LANES(t) {
        const uint32_t got = t.peer(ln[i_].give, ln[t.partner(i_, m)].give,
                                    m, kMask);
        if ((t.tid(i_) & m) == 0) ln[i_].bits ^= got;
      }
    }
    if constexpr (P::kWarps > 1)
      PT_FOR_LANES(t) xb[t.tid(i_)] = (uint8_t)ln[i_].bits;
    t.sync();
    PT_FOR_LANES(t) {
      Lane& x = ln[i_];
      const int tid = t.tid(i_);
      uint32_t b = x.bits;
      if constexpr (P::kWarps > 1) {
        // the stages of the warp bits: the XOR over the warps whose index
        // holds this warp's bits
        const int w = tid >> 5;
        b = 0;
#pragma unroll
        for (int W = 0; W < P::kWarps; ++W)
          if ((W & w) == w) b ^= xb[(W << 5) | (tid & 31)];
      }
      uint32_t c = 0;
#pragma unroll
      for (int j = 0; j < kR; ++j) c |= (uint32_t)xh[tid * kR + j] << j;
      x.ok = b == c;
    }
    return t.all(ln);
  }

  PT_HD PT_INLINE void run() {
    const float sign = A.negate ? -1.0f : 1.0f;
    PT_FOR_LANES(t) {
      Lane& x = ln[i_];
      const int tid = t.tid(i_);
      // the levels between groups: 0; l_S: the channel at group 0's rows
      for (int e = tid; e < 2 * (kG - 1) * kStride; e += P::kT)
        lat[e] = M::st(0.0f);
      float ch[kR];
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const long long r = tid * kR + j;
        ch[j] = M::rnd(sign * A.llr[r * A.llr_rs + col * A.llr_cs]);
        x.r0[j] = M::rnd(A.prior[r]);
      }
      store<0>(level(kS, false), ch, first<0>(tid));
#pragma unroll
      for (int g = 0; g < kG; ++g)
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int j = 0; j < kR; ++j) x.l[g][k][j] = x.r[g][k][j] = 0.0f;
    }
    t.sync();

    // sweeps, a check after every check_every of the full chunks
    const int checks = A.early_stop ? A.num_iter / A.check_every : 0;
    bool done = false;
    int ran = 0, chunk = 0;
    while (ran < A.num_iter) {
      sweep();
      ++ran;
      if (++chunk == A.check_every && ran <= checks * A.check_every) {
        chunk = 0;
        if (converged()) {
          done = true;
          break;
        }
      }
    }

    PT_FOR_LANES(t) {
      const Lane& x = ln[i_];
      const int tid = t.tid(i_);
      float l0v[kR];
      l0(i_, l0v);
#pragma unroll
      for (int j = 0; j < kR; ++j)
        A.out[(tid * kR + j) * A.out_rs + col * A.out_cs] =
            M::rnd(l0v[j] + x.r0[j]);
      if (A.done != nullptr && tid == 0) A.done[col] = done ? 1 : 0;
      if (A.sweeps != nullptr && tid == 0) A.sweeps[col] = ran;
    }
  }
};

// decode column col by the tiled form: smem holds
// bp_tiled_smem_bytes(kS, sizeof(T)) bytes, lanes t.per() lanes
template <int kS, int kMode, bool kBf16, class Team>
PT_HD PT_INLINE void bp_tiled_column(const Team& t, const BpArgs& A, int col,
                                     unsigned char* smem,
                                     BpTileLane<kS>* lanes) {
  using M = BpMsg<kBf16>;
  using Tile = BpTile<Team, kS, kMode, kBf16>;
  constexpr int kLevels = 2 * (Tile::kG - 1) + 1;
  uint8_t* xh = smem + sizeof(typename M::T) * kLevels * Tile::kStride;
  const float msf = M::rnd(A.msf);
  Tile tile{t, A, lanes, reinterpret_cast<typename M::T*>(smem), xh,
            xh + (1 << kS), col,
            BpOps<kBf16, kMode>{M::rnd(A.llr_max), msf, A.exact,
                                !A.exact && msf != 1.0f}};
  tile.run();
}

// ---- the global form ----
// one lane's messages at the warp stages of its current block: index
// [stage][row]; stage Sw holds the top boundary while a sweep runs
struct BpLane {
  float l[kBpWarpStages + 1][2];
  float r[kBpWarpStages + 1][2];
  float own, give;      // a warp stage's outputs: own row, partner's row
  uint32_t bits;        // the check's predicates (compute_bits)
  int ok;
};

template <class Team, bool kBf16>
struct BpCodeword {
  using M = BpMsg<kBf16>;
  using T = typename M::T;
  const Team& t;
  const BpArgs& A;
  BpLane* ln;           // the lanes this thread runs (t.per() of them)
  T* l_;                // the whole lattice: l at stages 0..S, then r
  T* r_;
  uint32_t* words;      // [blocks][4]: the check's words
  int col, n, Sw, blocks, warps, nb;
  BpOps<kBf16> ops;

  PT_HD PT_INLINE T* L(int s) const { return l_ + (long long)s * n; }
  PT_HD PT_INLINE T* R(int s) const { return r_ + (long long)s * n; }
  PT_HD PT_INLINE int lane(int i) const { return t.tid(i) & 31; }
  PT_HD PT_INLINE int warp(int i) const { return t.tid(i) >> 5; }
  // row j (0, 1) of lane i in its k-th block; -1 past n
  PT_HD PT_INLINE int row(int i, int k, int j) const {
    const int r = (warp(i) + k * warps) * kBpRows + 2 * lane(i) + j;
    return r < n ? r : -1;
  }

  // ---- the warp stages of one block ----
  // stage s of the l (left) or r pass on every lane's current block
  PT_HD PT_INLINE void warp_stage(int s, bool left) const {
    if (s == 0) {                 // both rows in the lane
      PT_FOR_LANES(t) {
        BpLane& x = ln[i_];
        float du, dv;
        ops.pe(left, x.l[1][0], x.l[1][1], x.r[0][0], x.r[0][1], du, dv);
        if (left) {
          x.l[0][0] = du;
          x.l[0][1] = dv;
        } else {
          x.r[1][0] = du;
          x.r[1][1] = dv;
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
      BpLane& x = ln[i_];
      const BpLane& y = ln[t.partner(i_, m)];
      const bool up = (lane(i_) & m) == 0;
      const float l0 = x.l[s + 1][0], l1 = x.l[s + 1][1];
      const float r0 = x.r[s][0], r1 = x.r[s][1];
      // send slot up ? 1 : 0, receive the partner's slot up ? 0 : 1
      const float pl = t.peer(up ? l1 : l0, up ? y.l[s + 1][0]
                                               : y.l[s + 1][1], m);
      const float pr = t.peer(up ? r1 : r0, up ? y.r[s][0] : y.r[s][1], m);
      const float ml = up ? l0 : l1, mr = up ? r0 : r1;
      float du, dv;
      ops.pe(left, up ? ml : pl, up ? pl : ml, up ? mr : pr, up ? pr : mr,
             du, dv);
      x.own = up ? du : dv;
      x.give = up ? dv : du;
    }
    PT_FOR_LANES(t) {
      BpLane& x = ln[i_];
      const bool up = (lane(i_) & m) == 0;
      const float got = t.peer(x.give, ln[t.partner(i_, m)].give, m);
      const float o0 = up ? x.own : got, o1 = up ? got : x.own;
      if (left) {
        x.l[s][0] = o0;
        x.l[s][1] = o1;
      } else {
        x.r[s + 1][0] = o0;
        x.r[s + 1][1] = o1;
      }
    }
  }

  // the lanes' warp-stage messages of block k from and to the scratch
  PT_HD PT_INLINE void move_state(int k, bool load) const {
    PT_FOR_LANES(t) {
      BpLane& x = ln[i_];
#pragma unroll
      for (int s = 0; s < kBpWarpStages; ++s) {
        if (s >= Sw) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = row(i_, k, j);
          if (r < 0) continue;
          if (load) {
            x.l[s][j] = M::ld(L(s)[r]);
            x.r[s][j] = M::ld(R(s)[r]);
          } else {
            L(s)[r] = M::st(x.l[s][j]);
            R(s)[r] = M::st(x.r[s][j]);
          }
        }
      }
    }
  }

  // l_Sw of block k into its lanes (the top of the warp stages)
  PT_HD PT_INLINE void load_top(int k) const {
    PT_FOR_LANES(t) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = row(i_, k, j);
        const float v = r < 0 ? 0.0f : M::ld(L(Sw)[r]);
        // constant indices only, so the lane's arrays stay in registers
#pragma unroll
        for (int s = 1; s <= kBpWarpStages; ++s)
          if (s == Sw) ln[i_].l[s][j] = v;
      }
    }
  }
  // r_Sw of block k from its lanes
  PT_HD PT_INLINE void store_top(int k) const {
    PT_FOR_LANES(t) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = row(i_, k, j);
        float v = 0.0f;
#pragma unroll
        for (int s = 1; s <= kBpWarpStages; ++s)
          if (s == Sw) v = ln[i_].r[s][j];
        if (r >= 0) R(Sw)[r] = M::st(v);
      }
    }
  }

  // both passes of the warp stages, for every block of each warp, one
  // block at a time; reads l_Sw, writes r_Sw
  PT_HD PT_INLINE void warp_sweep() const {
    for (int k = 0; k < nb; ++k) {
      move_state(k, true);
      load_top(k);
#pragma unroll
      for (int s = kBpWarpStages - 1; s >= 0; --s)
        if (s < Sw) warp_stage(s, true);
#pragma unroll
      for (int s = 0; s < kBpWarpStages; ++s)
        if (s < Sw) warp_stage(s, false);
      store_top(k);
      move_state(k, false);
    }
  }

  // ---- the CTA stages ----
  // stage s, one element per row pair
  PT_HD PT_INLINE void cta_single(int s, bool left) const {
    const T* l1 = L(s + 1);
    const T* r0 = R(s);
    T* dst = left ? L(s) : R(s + 1);
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
    const int r = row(i, k, j);
    return M::rnd(M::ld(L(0)[r]) + M::ld(R(0)[r]));
  }

  // lane i's predicates in block k, as bits of ln[i].bits: 0, the even
  // row's info-side decision after the XOR butterfly's stage 0 (row 2k ^=
  // row 2k + 1), 1 the odd row's; 2, 3 the channel-side decisions
  PT_HD PT_INLINE void compute_bits(int i, int k) const {
    bool u[2], x[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = row(i, k, j);
      u[j] = r >= 0 && !(M::ld(R(0)[r]) > 0.0f) && total0(i, k, j) <= 0.0f;
      x[j] = r >= 0 && channel_total(r) <= 0.0f;
    }
    ln[i].bits = (uint32_t)(u[0] != u[1]) | (uint32_t)u[1] << 1
        | (uint32_t)x[0] << 2 | (uint32_t)x[1] << 3;
  }

  // the G-matrix check; uniform over the CTA
  PT_HD PT_INLINE bool converged() const {
    const int S = A.S;
    t.sync();
    // the words of every block: the info side through the XOR butterfly's
    // stages 0..5 (shifts and masks within a word), the channel side
    for (int k = 0; k < nb; ++k) {
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
    return M::rnd(M::ld(L(A.S)[r]) + M::ld(R(A.S)[r]));
  }

  PT_HD PT_INLINE void run() {
    const int S = A.S;
    const float sign = A.negate ? -1.0f : 1.0f;
    // the lattice: l_S the channel, r_0 the prior, the rest 0
    PT_FOR_LANES(t) {
      for (int i = t.tid(i_); i < n; i += t.size()) {
        for (int s = 0; s < S; ++s) L(s)[i] = M::st(0.0f);
        L(S)[i] = M::st(M::rnd(sign * A.llr[i * A.llr_rs + col * A.llr_cs]));
        for (int s = 0; s <= S; ++s)
          R(s)[i] = M::st(s == 0 ? M::rnd(A.prior[i]) : 0.0f);
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

    PT_FOR_LANES(t) {
      for (int k = 0; k < nb; ++k)
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

// decode column col by the global form: lat, its whole lattice
// (2 (S + 1) n messages); words: 4 per block of scratch
template <bool kBf16, class Team>
PT_HD PT_INLINE void bp_global_column(const Team& t, const BpArgs& A,
                                      int col, typename BpMsg<kBf16>::T* lat,
                                      uint32_t* words, BpLane* lanes) {
  using M = BpMsg<kBf16>;
  const int n = 1 << A.S;
  const int blocks = bp_blocks(A.S);
  const int warps = (t.size() + 31) / 32;
  const float msf = M::rnd(A.msf);
  const BpOps<kBf16> ops{M::rnd(A.llr_max), msf, A.exact,
                         !A.exact && msf != 1.0f};
  BpCodeword<Team, kBf16> cw{t, A, lanes, lat,
                             lat + (long long)(A.S + 1) * n, words, col, n,
                             bp_warp_stages(A.S), blocks, warps,
                             blocks / warps, ops};
  cw.run();
}

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
  template <class V>
  PT_HD V peer(V, V other, int, unsigned = 0xffffffffu) const {
    return other;
  }
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

}  // namespace polar_torch
