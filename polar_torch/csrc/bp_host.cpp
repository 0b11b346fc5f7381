// Host build of the BP decode schedule (bp.cuh), compiled with g++ and no
// CUDA or torch headers: one thread runs each column's CTA, its lanes in
// turn between barriers, with the launch plan the card would use. The CPU
// tests hold it against the plain PyTorch version, which checks the CUDA
// kernel's logic where no card exists. The main path never uses it.
//
// Build: g++ -std=c++17 -O2 -shared -fPIC -o libbp_host.so bp_host.cpp
#include <vector>

#include "bp.cuh"

namespace {

template <int kB, bool kRes, bool kBf16>
void run_columns(const polar_torch::BpArgs& A, int threads) {
  using namespace polar_torch;
  using T = typename BpMsg<kBf16>::T;
  const long long lat_elems = kRes ? bp_shared_elems(A.S) : 0;
  std::vector<T> local(lat_elems);
  std::vector<uint32_t> words(4 * bp_blocks(A.S));
  std::vector<BpLane<kB>> lanes(threads);
  for (int col = 0; col < A.bs; ++col) {
    T* lat = kRes ? local.data()
                  : static_cast<T*>(A.lattice)
                        + col * bp_lattice_elems(A.S);
    bp_column<kB, kRes, kBf16>(BpHostTeam{threads}, A, col, lat,
                               words.data(), lanes.data());
  }
}

template <bool kBf16>
void run_plan(const polar_torch::BpArgs& A, bool shared,
              const polar_torch::BpPlan& p) {
  if (!shared) run_columns<1, false, kBf16>(A, p.threads);
  else if (p.warp_blocks == 2) run_columns<2, true, kBf16>(A, p.threads);
  else run_columns<1, true, kBf16>(A, p.threads);
}

}  // namespace

// lattice == nullptr: the shared form (stages Sw..S of one column, reused
// by every column); else the global form, column col's whole lattice at
// lattice + col * 2 (S + 1) n messages (f32, or bf16 with bf16 != 0).
// warp_blocks > 0 sets the shared form's resident blocks per warp (1 or 2)
// in place of the card's plan, so the tests reach the two-block form (the
// card's at n = 2048) at small n. done and sweeps (each [bs] or nullptr)
// receive the convergence flag and the sweeps each codeword ran.
extern "C" int bp_host(const float* llr, long long llr_rs, long long llr_cs,
                       const float* prior, float* out, long long out_rs,
                       long long out_cs, int32_t* done, int32_t* sweeps,
                       void* lattice, int S, int bs, int num_iter,
                       int check_every, int early_stop, int exact,
                       int negate, float msf, float llr_max, int bf16,
                       int warp_blocks) {
  using namespace polar_torch;
  BpArgs A{llr, llr_rs, llr_cs, prior, out, out_rs, out_cs, done, sweeps,
           lattice, S, bs, num_iter, check_every, early_stop, exact, negate,
           msf, llr_max};
  const bool shared = lattice == nullptr;
  if (S < 1 || S > 16 || (shared && S > kBpMaxSharedS)) return 1;
  const BpPlan p = shared && warp_blocks > 0
      ? bp_shared_plan(S, warp_blocks) : bp_plan(S, shared);
  if (bf16) run_plan<true>(A, shared, p);
  else run_plan<false>(A, shared, p);
  return 0;
}

// the card's launch plan: threads, warp_blocks, dynamic shared memory bytes
// (of bf16 messages with bf16 != 0)
extern "C" void bp_plan_of(int S, int shared, int bf16, int* out) {
  using namespace polar_torch;
  const BpPlan p = bp_plan(S, shared != 0);
  out[0] = p.threads;
  out[1] = p.warp_blocks;
  out[2] = (int)bp_smem_bytes(S, shared != 0, bf16 ? 2 : 4);
}

// x[i] rounded to bf16 (bf16_round, the kernel's rounding) for i < count
extern "C" void bp_bf16_round(const float* x, float* out, long long count) {
  for (long long i = 0; i < count; ++i) out[i] = polar_torch::bf16_round(x[i]);
}
