// Host build of the probe routines (probes.cuh), compiled with g++ and no
// CUDA or torch headers: one thread runs every column in turn, with the
// card's column mapping (k_bcast reads block 0's column; k_big a 1,024-row
// scratch a column). The CPU tests hold it bit-equal to the plain PyTorch
// versions, which checks the CUDA kernels' arithmetic where no card
// exists. The main path never uses it.
//
// Build: g++ -std=c++17 -O2 -shared -fPIC -o libprobes_host.so
//        probes_host.cpp
#include <vector>

#include "probes.cuh"

namespace {

template <int P>
void run_f32(const float* x, float* o, int cols) {
  using namespace polar_torch;
  for (int c = 0; c < cols; ++c)
    probe_column<P>(x + (P == kProbeBcast ? c % kProbeBlockCols : c), o + c,
                    cols);
}

}  // namespace

// probes_launch's contract (probes.cu), run on the host. Returns 0, or 1
// on arguments the card would refuse.
extern "C" int probes_host(int probe, const void* x, const int32_t* p,
                           void* out, int rows, int cols) {
  using namespace polar_torch;
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (probe < 0 || probe >= kProbeCount || rows < 1 || cols < 1) return 1;
  if (probe < kProbeArith
      && (rows != kProbeRows || cols % kProbeBlockCols != 0))
    return 1;
  switch (probe) {
    case kProbeFori: run_f32<kProbeFori>(xf, of, cols); break;
    case kProbeBcast: run_f32<kProbeBcast>(xf, of, cols); break;
    case kProbeRoll: run_f32<kProbeRoll>(xf, of, cols); break;
    case kProbeReduce: run_f32<kProbeReduce>(xf, of, cols); break;
    case kProbeShift: run_f32<kProbeShift>(xf, of, cols); break;
    case kProbeScratchFori: run_f32<kProbeScratchFori>(xf, of, cols); break;
    case kProbeSweepCombo: run_f32<kProbeSweepCombo>(xf, of, cols); break;
    case kProbeBigSweep:
    case kProbeBigSweepNoLoop: {
      std::vector<float> col(kProbeBigRows);
      const int sweeps = probe == kProbeBigSweep ? kProbeLoopSweeps : 1;
      for (int c = 0; c < cols; ++c)
        probe_big_column(xf + c, of + c, cols, col.data(), sweeps);
      break;
    }
    case kProbeArith:
      for (int c = 0; c < cols; ++c)
        probe_arith_column(static_cast<const uint16_t*>(x) + c,
                           static_cast<uint16_t*>(out) + c, rows, cols);
      break;
    case kProbeGather:
      for (int c = 0; c < cols; ++c)
        probe_gather_column(static_cast<const uint16_t*>(x) + c, p + c,
                            static_cast<uint16_t*>(out) + c, rows, cols);
      break;
    default:
      for (int c = 0; c < cols; ++c)
        probe_int8_column(static_cast<const int8_t*>(x) + c,
                          static_cast<int8_t*>(out) + c, rows, cols);
      break;
  }
  return 0;
}
