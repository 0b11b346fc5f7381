// Host build of the per-codeword SC subtree routine (sc_subtree.cuh),
// compiled with g++ and no CUDA or torch headers. One thread runs a
// codeword's G lanes in turn between the group's barriers, with the
// codeword's tiles and shared stages in host memory; the stages from
// n_shared up live in the global scratch lloc / uloc as on the card. The
// CPU tests hold it against the plain PyTorch version, which checks the
// CUDA kernel's logic where no card exists. The main path never uses it.
//
// Build: g++ -std=c++17 -O2 -shared -fPIC -o libsc_subtree_host.so
//        sc_subtree_host.cpp
#include <vector>

#include "sc_subtree.cuh"

namespace {

template <int G>
void run_columns(const polar_torch::ScArgs& A) {
  using namespace polar_torch;
  const int w = 1 << A.b;
  const int rows = sc_rows(A.n_shared);
  std::vector<float> at(w), lsh(rows);
  std::vector<int8_t> ush(rows), ct(w);
  for (int col = 0; col < A.bs; ++col) {
    for (int j = 0; j < w; ++j) at[j] = A.a[j * A.a_row_stride + col];
    const ScWork W{A, at.data(), lsh.data(), ush.data(), ct.data(), col};
    sc_codeword<G>(ScHostGroup<G>{}, A, W);
    for (int j = 0; j < w; ++j) A.cw[(size_t)j * A.bs + col] = ct[j];
  }
}

}  // namespace

// bytes of dynamic shared memory of a block on the card (128 / G
// codewords) with stages 0..n_shared-1 in shared memory
extern "C" long long sc_subtree_smem_bytes(int b, int G, int n_shared) {
  return (long long)polar_torch::sc_smem_bytes(
      b, n_shared, polar_torch::kScThreads / G, 0, 0, 0);
}

extern "C" int sc_subtree_host(const float* a, long long a_row_stride,
                               const int32_t* frz, const int32_t* sched,
                               int n_ops, int32_t* cw, float* lloc,
                               int8_t* uloc, int b, int bs, float llr_max,
                               int exact, int n_shared, int lanes) {
  using namespace polar_torch;
  if (b < 1 || b > kScMaxB || n_shared < 0 || n_shared > b) return 1;
  ScArgs A{a, a_row_stride, frz, sched, n_ops, cw, lloc, uloc, b, bs,
           llr_max, exact, n_shared};
  switch (lanes) {
    case 4: run_columns<4>(A); break;
    case 8: run_columns<8>(A); break;
    case 16: run_columns<16>(A); break;
    case 32: run_columns<32>(A); break;
    default: return 1;
  }
  return 0;
}
