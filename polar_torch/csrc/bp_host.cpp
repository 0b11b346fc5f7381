// Host build of the BP decode schedules (bp.cuh), compiled with g++ and no
// CUDA or torch headers: one thread runs each column's CTA, its lanes in
// turn between barriers, with the launch plan the card would use (the
// tiled form for a shared lattice, the global form for a global one). The
// CPU tests hold it against the plain PyTorch version, which checks the
// CUDA kernel's logic where no card exists. The main path never uses it.
//
// Build: g++ -std=c++17 -O2 -shared -fPIC -o libbp_host.so bp_host.cpp
#include <vector>

#include "bp.cuh"

namespace {

using polar_torch::BpArgs;

template <int kS, int kMode, bool kBf16>
void run_tiled(const BpArgs& A) {
  using namespace polar_torch;
  constexpr int kT = BpTiles<kS>::kT;
  std::vector<unsigned char> smem(bp_tiled_smem_bytes(kS, kBf16 ? 2 : 4));
  std::vector<BpTileLane<kS>> lanes(kT);
  for (int col = 0; col < A.bs; ++col)
    bp_tiled_column<kS, kMode, kBf16>(BpHostTeam{kT}, A, col, smem.data(),
                                      lanes.data());
}

template <int kS, bool kBf16>
void tiled_mode(const BpArgs& A, int mode) {
  using namespace polar_torch;
  if (mode == kBpScaled) run_tiled<kS, kBpScaled, kBf16>(A);
  else if (mode == kBpMinsum) run_tiled<kS, kBpMinsum, kBf16>(A);
  else run_tiled<kS, kBpExact, kBf16>(A);
}

template <bool kBf16>
void run_shared(const BpArgs& A) {
  const int mode = polar_torch::bp_mode<kBf16>(A);
  switch (A.S) {
    case 1: return tiled_mode<1, kBf16>(A, mode);
    case 2: return tiled_mode<2, kBf16>(A, mode);
    case 3: return tiled_mode<3, kBf16>(A, mode);
    case 4: return tiled_mode<4, kBf16>(A, mode);
    case 5: return tiled_mode<5, kBf16>(A, mode);
    case 6: return tiled_mode<6, kBf16>(A, mode);
    case 7: return tiled_mode<7, kBf16>(A, mode);
    case 8: return tiled_mode<8, kBf16>(A, mode);
    case 9: return tiled_mode<9, kBf16>(A, mode);
    case 10: return tiled_mode<10, kBf16>(A, mode);
    default: return tiled_mode<11, kBf16>(A, mode);
  }
}

template <bool kBf16>
void run_global(const BpArgs& A) {
  using namespace polar_torch;
  using T = typename BpMsg<kBf16>::T;
  const int threads = bp_plan(A.S, false, kBf16 ? 2 : 4).threads;
  std::vector<uint32_t> words(4 * bp_blocks(A.S));
  std::vector<BpLane> lanes(threads);
  for (int col = 0; col < A.bs; ++col)
    bp_global_column<kBf16>(BpHostTeam{threads}, A, col,
                            static_cast<T*>(A.lattice)
                                + col * bp_lattice_elems(A.S),
                            words.data(), lanes.data());
}

}  // namespace

// lattice == nullptr: the shared (tiled) form; else the global form, column
// col's whole lattice at lattice + col * 2 (S + 1) n messages (f32, or bf16
// with bf16 != 0). done and sweeps (each [bs] or nullptr) receive the
// convergence flag and the sweeps each codeword ran.
extern "C" int bp_host(const float* llr, long long llr_rs, long long llr_cs,
                       const float* prior, float* out, long long out_rs,
                       long long out_cs, int32_t* done, int32_t* sweeps,
                       void* lattice, int S, int bs, int num_iter,
                       int check_every, int early_stop, int exact,
                       int negate, float msf, float llr_max, int bf16) {
  using namespace polar_torch;
  BpArgs A{llr, llr_rs, llr_cs, prior, out, out_rs, out_cs, done, sweeps,
           lattice, S, bs, num_iter, check_every, early_stop, exact, negate,
           msf, llr_max};
  const bool shared = lattice == nullptr;
  if (S < 1 || S > 16 || (shared && S > kBpMaxSharedS)) return 1;
  if (shared) {
    if (bf16) run_shared<true>(A);
    else run_shared<false>(A);
  } else {
    if (bf16) run_global<true>(A);
    else run_global<false>(A);
  }
  return 0;
}

// the card's launch plan: threads, CTA barriers a sweep, dynamic shared
// memory bytes (of bf16 messages with bf16 != 0)
extern "C" void bp_plan_of(int S, int shared, int bf16, int* out) {
  using namespace polar_torch;
  const BpPlan p = bp_plan(S, shared != 0, bf16 ? 2 : 4);
  out[0] = p.threads;
  out[1] = p.syncs;
  out[2] = (int)p.smem;
}

// x[i] rounded to bf16 (bf16_round, the kernel's rounding) for i < count
extern "C" void bp_bf16_round(const float* x, float* out, long long count) {
  for (long long i = 0; i < count; ++i) out[i] = polar_torch::bf16_round(x[i]);
}
