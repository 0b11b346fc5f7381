// Host build of the BP decode schedule (bp.cuh), compiled with g++ and no
// CUDA or torch headers: one thread runs each column's schedule with a
// barrier that does nothing. The CPU tests hold it against the plain
// PyTorch version, which checks the CUDA kernel's logic where no card
// exists. The main path never uses it.
//
// Build: g++ -std=c++17 -O2 -shared -fPIC -o libbp_host.so bp_host.cpp
#include <vector>

#include "bp.cuh"

// lattice == nullptr: one column-sized lattice reused by every column (the
// kernel's shared-memory form); else column col's lattice at
// lattice + col * 2 (S + 1) n (its global form).
extern "C" int bp_host(const float* llr, long long llr_rs, long long llr_cs,
                       const float* prior, float* out, long long out_rs,
                       long long out_cs, int32_t* done, float* lattice, int S,
                       int bs, int num_iter, int check_every, int early_stop,
                       int exact, int negate, float msf, float llr_max) {
  using namespace polar_torch;
  BpArgs A{llr, llr_rs, llr_cs, prior, out, out_rs, out_cs, done, lattice,
           S, bs, num_iter, check_every, early_stop, exact, negate, msf,
           llr_max};
  const long long lat_elems = bp_lattice_elems(S);
  std::vector<float> local(lattice == nullptr ? lat_elems : 0);
  std::vector<uint8_t> bits((size_t)1 << S);
  for (int col = 0; col < bs; ++col) {
    float* lat = lattice == nullptr ? local.data() : lattice + col * lat_elems;
    bp_column(SerialTeam{}, A, col, lat, bits.data());
  }
  return 0;
}
