// Host build of the probe routines (probes.cuh), compiled with g++ and no
// CUDA or torch headers: one thread runs every column in turn, with the
// card's column mapping (k_bcast reads block 0's column), k_big's warps and
// lanes (run_big), k_sweepcombo's row groups, k_i8's 16-byte units, and
// k_reduce's and k_gather's slabs in the card's order (every thread's
// first round, then every thread's second). The
// CPU tests hold it bit-equal to the plain PyTorch versions, which checks
// the CUDA kernels' arithmetic where no card exists. The main path never
// uses it.
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

template <bool kVec>
void run_reduce(const float* x, float* o, int cols) {
  using namespace polar_torch;
  ProbeVec part[kReduceChunks][kReduceQuads];
  for (int s = 0; s < cols / kReduceCols; ++s) {
    for (int g = 0; g < kReduceChunks; ++g)
      for (int q = 0; q < kReduceQuads; ++q)
        part[g][q] =
            probe_reduce_chunk<kVec>(x + s * kReduceCols + 4 * q, cols, g);
    for (int g = 0; g < kReduceChunks; ++g)
      for (int q = 0; q < kReduceQuads; ++q)
        probe_reduce_store<kVec>(
            o + s * kReduceCols + 4 * q, cols, g,
            probe_reduce_combine(&part[0][q], kReduceQuads));
  }
}

// The card's gather: the tiled form's two rounds a slab (every pointer read
// in the first), or element by element past kGatherTileRows rows.
template <bool kVec>
void run_gather(const uint16_t* x, const int32_t* p, uint16_t* o, int rows,
                int cols) {
  using namespace polar_torch;
  if (rows > kGatherTileRows) {
    for (size_t i = 0; i < (size_t)rows * cols; ++i)
      o[i] = probe_gather_direct(x, p, cols, i);
    return;
  }
  const int n8 = probe_gather_n8(rows), units = rows * n8;
  std::vector<uint16_t> tile((size_t)units * 8);
  std::vector<int32_t> ptr((size_t)units * 8);
  for (int s = 0; s * 8 * n8 < cols; ++s) {
    for (int u = 0; u < units; ++u) {
      probe_gather_stage<kVec>(x, tile.data(), cols, n8, s, u);
      probe_gather_ptrs<kVec>(p, cols, n8, s, u, &ptr[(size_t)u * 8]);
    }
    for (int u = 0; u < units; ++u)
      probe_gather_store<kVec>(tile.data(), &ptr[(size_t)u * 8], o, cols, n8,
                               s, u);
  }
}

// The card's k_big (probe_big_kernel) over column c: a warp a quarter, its
// 32 lanes run in turn at each step, the cross-lane stages reading what
// the partner lane's rows sent (their t from before the stage) as a
// shuffle does; the four quarters' rows 0..63 folded into the output.
template <int kSweeps>
void run_big(const float* x, float* o, int cols, int c) {
  using namespace polar_torch;
  uint32_t v[kProbeBigQuarters][32][kProbeBigLaneRows];
  uint32_t w[32][kProbeBigLaneRows], t[32][kProbeBigLaneRows];
  uint32_t part[32][kProbeBigLaneRows];
  for (int q = 0; q < kProbeBigQuarters; ++q) {
    for (int l = 0; l < 32; ++l) probe_big_fill(x + c, cols, l, v[q][l]);
    for (int i = 0; i < kSweeps; ++i) {
      for (int l = 0; l < 32; ++l) probe_big_start(v[q][l], w[l], t[l]);
      for (int s = 0; s < kProbeBigInLane; ++s)
        for (int l = 0; l < 32; ++l)
          probe_big_lane_stage<kSweeps>(v[q][l], w[l], t[l], s);
      for (int s = kProbeBigInLane; s < kProbeBigStages; ++s) {
        for (int l = 0; l < 32; ++l)
          for (int k = 0; k < kProbeBigLaneRows; ++k)
            part[l][k] = t[l ^ 1 << (s - kProbeBigInLane)][k];
        for (int l = 0; l < 32; ++l)
          probe_big_cross_stage<kSweeps>(v[q][l], w[l], t[l], part[l], s);
      }
    }
  }
  for (int r = 0; r < kProbeRows; ++r)
    o[r * cols + c] = probe_big_fold(
        &v[0][r / kProbeBigLaneRows][r % kProbeBigLaneRows],
        32 * kProbeBigLaneRows);
}

// The card's k_sweepcombo (probe_combo_kernel): each (column, row group).
void run_combo(const float* x, float* o, int cols) {
  using namespace polar_torch;
  for (int g = 0; g < kProbeRows / kProbeComboRows; ++g)
    for (int c = 0; c < cols; ++c) {
      const size_t at = (size_t)g * kProbeComboRows * cols + c;
      probe_combo_group(x + at, o + at, cols);
    }
}

// The card's k_i8 (probe_int8_kernel): every 16-byte unit of the n bytes.
template <bool kVec>
void run_int8(const int8_t* x, int8_t* o, size_t n) {
  using namespace polar_torch;
  for (size_t u = 0; u * kInt8Unit < n; ++u)
    probe_int8_store<kVec>(o, n, u, probe_int8_load<kVec>(x, n, u));
}

bool aligned16(const void* a, const void* b, const void* c = nullptr) {
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) & 15) == 0;
}

}  // namespace

// k_big's copy table (probes.cuh probe_big_copy): the chain whose value a
// row sends its stage-s partner with `sweeps` sweeps; for the tests.
extern "C" int probes_host_big_copy(int s, int sweeps) {
  return polar_torch::probe_big_copy(s, sweeps);
}

// Probe `probe` (a ProbeId) as the card's entry point probe_<name>
// (probes.cu) runs it: x [rows, cols] (f32 [64, 128 g], bf16 or int8), for
// k_gather the int32 pointers p of x's shape, out of x's shape and type;
// k_reduce, k_gather and k_i8 take the vector form where the card would
// (16-byte aligned tensors; for k_gather also cols a multiple of 8).
// Returns 0, or 1 on arguments the card would refuse.
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
    case kProbeReduce:
      if (aligned16(x, out))
        run_reduce<true>(xf, of, cols);
      else
        run_reduce<false>(xf, of, cols);
      break;
    case kProbeShift: run_f32<kProbeShift>(xf, of, cols); break;
    case kProbeScratchFori: run_f32<kProbeScratchFori>(xf, of, cols); break;
    case kProbeSweepCombo: run_combo(xf, of, cols); break;
    case kProbeBigSweep:
      for (int c = 0; c < cols; ++c)
        run_big<kProbeLoopSweeps>(xf, of, cols, c);
      break;
    case kProbeBigSweepNoLoop:
      for (int c = 0; c < cols; ++c) run_big<1>(xf, of, cols, c);
      break;
    case kProbeArith:
      for (int c = 0; c < cols; ++c)
        probe_arith_column(static_cast<const uint16_t*>(x) + c,
                           static_cast<uint16_t*>(out) + c, rows, cols);
      break;
    case kProbeGather: {
      const auto* xb = static_cast<const uint16_t*>(x);
      auto* ob = static_cast<uint16_t*>(out);
      if (cols % 8 == 0 && aligned16(x, p, out))
        run_gather<true>(xb, p, ob, rows, cols);
      else
        run_gather<false>(xb, p, ob, rows, cols);
      break;
    }
    default: {
      const auto* xi = static_cast<const int8_t*>(x);
      auto* oi = static_cast<int8_t*>(out);
      const size_t n = (size_t)rows * cols;
      if (aligned16(x, out))
        run_int8<true>(xi, oi, n);
      else
        run_int8<false>(xi, oi, n);
      break;
    }
  }
  return 0;
}
