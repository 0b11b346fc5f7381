// Host build of the per-codeword SC subtree routine (sc_subtree.cuh),
// compiled with g++ and no CUDA or torch headers. The CPU tests hold it
// against the plain PyTorch version, which checks the CUDA kernel's logic
// where no card exists. The main path never uses it.
//
// Build: g++ -std=c++17 -O2 -shared -fPIC -o libsc_subtree_host.so
//        sc_subtree_host.cpp
#include "sc_subtree.cuh"

extern "C" int sc_subtree_host(const float* a, long long a_row_stride,
                               const int32_t* frz, const int32_t* sched,
                               int n_ops, int32_t* cw, float* lloc,
                               int8_t* uloc, int b, int bs, float llr_max,
                               int exact) {
  using namespace polar_torch;
  ScArgs A{a, a_row_stride, frz, sched, n_ops, cw, lloc, uloc, b, bs,
           llr_max, exact};
  for (int col = 0; col < bs; ++col) sc_column(A, col);
  return 0;
}
