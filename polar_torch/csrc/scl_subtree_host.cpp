// Host build of the per-codeword subtree routine (scl_subtree.cuh), compiled
// with g++ and no CUDA or torch headers. One thread runs a codeword's L
// lanes in turn between the group's barriers, with its block's shared
// arrays in host memory (the card's kThreads / L codewords a block, each
// in its own slots); the stages from n_shared up, and the codeword's
// stage-b sums, live in the global scratch lloc / uloc as on the card. The
// CPU tests hold it against the plain PyTorch version, which checks the
// CUDA kernel's logic where no card exists. The main path never uses it.
//
// Build: g++ -std=c++17 -O2 -shared -fPIC -o libscl_subtree_host.so
//        scl_subtree_host.cpp
#include <vector>

#include "scl_subtree.cuh"

namespace {

// the columns block by block, as on the card: kThreads / L codewords share
// the block's shared stages, each in its own slots, one after another
template <int L, bool kPc>
void run_columns_as(const polar_torch::SubtreeArgs& A) {
  using namespace polar_torch;
  constexpr int C = kThreads / L;
  const size_t rows = ((size_t)1 << A.n_shared) - 1;
  std::vector<float> lsh(rows * C * L);
  std::vector<int8_t> ush(rows * C * L);
  GroupShared<L> gs;
  for (int col = 0; col < A.bs; ++col)
    subtree_codeword<L, kPc>(HostGroup<L>{}, A, gs, lsh.data(), ush.data(),
                             C, col % C, col);
}

// the routine's build with the PC register or without, as on the card
template <int L>
void run_columns(const polar_torch::SubtreeArgs& A) {
  if (A.pc)
    run_columns_as<L, true>(A);
  else
    run_columns_as<L, false>(A);
}

// cw [2^b, L, bs] int32 from the stage-b sums (the card's transpose is a
// tiled kernel in scl_subtree.cu)
void cw_from_sums(const polar_torch::SubtreeArgs& A, int L) {
  const int8_t* src = polar_torch::stage_b_sums(A, L);
  for (int j = 0; j < (1 << A.b); ++j)
    for (int col = 0; col < A.bs; ++col)
      for (int l = 0; l < L; ++l)
        A.cw[((size_t)j * L + l) * A.bs + col] =
            A.b >= 2 ? src[(((size_t)(j >> 2) * A.bs + col) * L + l) * 4
                           + (j & 3)]
                     : src[((size_t)j * A.bs + col) * L + l];
}

}  // namespace

// bytes of dynamic shared memory of a block on the card (kThreads / L
// codewords) with stages 0..n_shared-1 in shared memory
extern "C" long long scl_subtree_smem_bytes(int L, int n_shared) {
  return polar_torch::block_smem_bytes(L, n_shared);
}

extern "C" int scl_subtree_host(const float* a, long long a_row_stride,
                                long long a_l_stride, const float* pm_in,
                                const int32_t* frz, const int32_t* sched,
                                int n_ops, int32_t* cw,
                                int32_t* p_out, float* pm_out, float* lloc,
                                int8_t* uloc, int b, int L, int bs,
                                float llr_max, int exact, int n_shared,
                                int pc) {
  using namespace polar_torch;
  if (n_shared < 0 || n_shared > b) return 1;
  SubtreeArgs A{a, a_row_stride, a_l_stride, pm_in, frz, sched, n_ops, cw,
                p_out, pm_out, lloc, uloc, b, bs, llr_max, exact, n_shared,
                pc};
  switch (L) {
    case 1: run_columns<1>(A); break;
    case 2: run_columns<2>(A); break;
    case 4: run_columns<4>(A); break;
    case 8: run_columns<8>(A); break;
    case 16: run_columns<16>(A); break;
    case 32: run_columns<32>(A); break;
    default: return 1;
  }
  cw_from_sums(A, L);
  return 0;
}
