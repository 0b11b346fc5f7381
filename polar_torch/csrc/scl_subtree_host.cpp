// Host build of the per-codeword subtree routine (scl_subtree.cuh), compiled
// with g++ and no CUDA or torch headers. The CPU tests hold it against the
// plain PyTorch version, which checks the CUDA kernel's logic where no card
// exists. The main path never uses it.
//
// Build: g++ -std=c++17 -O2 -shared -fPIC -o libscl_subtree_host.so
//        scl_subtree_host.cpp
#include "scl_subtree.cuh"

extern "C" int scl_subtree_host(const float* a, long long a_row_stride,
                                long long a_l_stride, const float* pm_in,
                                const int32_t* frz, const int32_t* sched,
                                int n_ops, int32_t* cw,
                                int32_t* p_out, float* pm_out, float* lloc,
                                int8_t* uloc, int b, int L, int bs,
                                float llr_max, int exact) {
  using namespace polar_torch;
  SubtreeArgs A{a, a_row_stride, a_l_stride, pm_in, frz, sched, n_ops, cw,
                p_out, pm_out, lloc, uloc, b, bs, llr_max, exact};
  for (int col = 0; col < bs; ++col) {
    switch (L) {
      case 1: subtree_column<1>(A, col); break;
      case 2: subtree_column<2>(A, col); break;
      case 4: subtree_column<4>(A, col); break;
      case 8: subtree_column<8>(A, col); break;
      case 16: subtree_column<16>(A, col); break;
      case 32: subtree_column<32>(A, col); break;
      default: return 1;
    }
  }
  return 0;
}
