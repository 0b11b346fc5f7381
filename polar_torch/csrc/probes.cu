// The probe kernels for Hopper (sm_90a).
//
// Replaces the eleven Pallas kernels of benchmarks/probe_r4.py, each of
// which isolates one construct of a decoder kernel: k_fori (:213),
// k_bcast (:220), k_roll (:223), k_reduce (:227), k_shift (:238),
// k_scratchfori (:247), k_sweepcombo (:256) and k_big (make_bigsweep,
// :275, with and without its loop), all on f32 [64, 512] over a grid of
// four (64, 128) blocks (launched at :313); and k_arith, k_gather and k_i8
// (:333-342, launched at :358), one bf16 or int8 block each. Their
// arithmetic lives in probes.cuh and is shared with the host build that
// the CPU tests run.
//
// What bounds them: bytes. An f32 probe moves 256 KiB (0.078 us at 3.35
// TB/s), a bf16 or int8 probe 16 KiB. The stage sweeps need little
// arithmetic: the two rows of a pair take one value, so each group of rows
// that the stages pair inside (8 rows for k_sweepcombo, the 64-row block
// for k_big, whose 16 scratch tiles stay equal) ends as its least |x|,
// whatever the sweeps. These kernels do the work op by op as the TPU
// kernels do, k_big over all 16 tiles (about 8.4e7 operations in four
// sweeps), so they run far above that bound; a launch costs several
// microseconds besides. The design aims only at being plainly right.
//
// Design. Every probe mixes rows of one column only (the roll, the
// reduction, the row-bit selects and the stage partners), so a thread owns
// a column and needs no barrier.
// * The f32 probes but k_big: 4 CTAs of 128 threads, one CTA per TPU grid
//   block, thread c on column c of its block; the column's 64 values in
//   registers. k_bcast reads block 0's column in every CTA, as its
//   constant index map does.
// * k_big: its scratch is 1,024 x 128 x 4 B = 512 KiB a TPU block, more
//   than the 227 KB of shared memory a CTA may take. Columns are
//   independent, so each CTA takes 32 of them: a [1024][32] f32 tile, 128
//   KiB of dynamic shared memory (a warp's 32 lanes on 32 columns hit 32
//   banks), 16 CTAs for 512 columns. The 16 warps of a CTA split each
//   stage's 512 pairs, with a barrier between stages; the two rows of a
//   pair take the same value, so a stage updates in place (probes.cuh
//   probe_pair).
// * bf16 and int8: CTAs of 256 threads, one thread a column (one CTA at
//   the probes' 256 columns), looping over the rows.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libprobes.so probes.cu
#include <cuda_runtime.h>

#include "probes.cuh"

namespace polar_torch {

constexpr int kProbeBigCols = 32;      // k_big's columns a CTA
constexpr int kProbeBigThreads = 512;  // 16 warps
constexpr int kProbeSmallThreads = 256;

template <int P>
__global__ void __launch_bounds__(kProbeBlockCols)
    probe_f32_kernel(const float* x, float* o, int cols) {
  const int c = threadIdx.x;
  const int col = blockIdx.x * kProbeBlockCols + c;
  probe_column<P>(x + (P == kProbeBcast ? c : col), o + col, cols);
}

__global__ void __launch_bounds__(kProbeBigThreads)
    probe_big_kernel(const float* x, float* o, int cols, int sweeps) {
  extern __shared__ float tile[];  // [kProbeBigRows][kProbeBigCols]
  constexpr int kWarps = kProbeBigThreads / 32;
  const int c = threadIdx.x % 32, w = threadIdx.x / 32;
  const int col = blockIdx.x * kProbeBigCols + c;
  for (int r = w; r < kProbeBigRows; r += kWarps)
    tile[r * kProbeBigCols + c] = probe_big_fill(x + col, cols, r);
  __syncthreads();
  for (int i = 0; i < sweeps; ++i) {
    for (int s = 0; s < kProbeBigStages; ++s) {
      for (int p = w; p < kProbeBigRows / 2; p += kWarps)
        probe_pair(tile + c, kProbeBigCols, s, p);
      __syncthreads();
    }
  }
  for (int r = w; r < kProbeRows; r += kWarps)
    o[r * cols + col] = tile[r * kProbeBigCols + c];
}

template <int P>
__global__ void __launch_bounds__(kProbeSmallThreads)
    probe_small_kernel(const void* x, const int32_t* p, void* o, int rows,
                       int cols) {
  const int c = blockIdx.x * kProbeSmallThreads + threadIdx.x;
  if (c >= cols) return;
  if constexpr (P == kProbeArith) {
    probe_arith_column(static_cast<const uint16_t*>(x) + c,
                       static_cast<uint16_t*>(o) + c, rows, cols);
  } else if constexpr (P == kProbeGather) {
    probe_gather_column(static_cast<const uint16_t*>(x) + c, p + c,
                        static_cast<uint16_t*>(o) + c, rows, cols);
  } else {
    probe_int8_column(static_cast<const int8_t*>(x) + c,
                      static_cast<int8_t*>(o) + c, rows, cols);
  }
}

template <int P>
void launch_f32(const float* x, float* o, int cols, cudaStream_t st) {
  probe_f32_kernel<P><<<cols / kProbeBlockCols, kProbeBlockCols, 0, st>>>(
      x, o, cols);
}

template <int P>
void launch_small(const void* x, const int32_t* p, void* o, int rows,
                  int cols, cudaStream_t st) {
  const int grid = (cols + kProbeSmallThreads - 1) / kProbeSmallThreads;
  probe_small_kernel<P><<<grid, kProbeSmallThreads, 0, st>>>(x, p, o, rows,
                                                             cols);
}

int launch_big(const float* x, float* o, int cols, int sweeps,
               cudaStream_t st) {
  constexpr int kSmem = kProbeBigRows * kProbeBigCols * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      probe_big_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  probe_big_kernel<<<cols / kProbeBigCols, kProbeBigThreads, kSmem, st>>>(
      x, o, cols, sweeps);
  return 0;
}

}  // namespace polar_torch

// One launch of probe `probe` (a ProbeId) on stream `stream`: x [rows,
// cols] (f32, bf16 or int8 as the probe takes), for k_gather the int32
// pointers p of x's shape, out of x's shape and type. The f32 probes take
// rows = 64 and cols a multiple of 128. Returns a cudaError_t.
extern "C" int probes_launch(int probe, const void* x, const int32_t* p,
                             void* out, int rows, int cols, void* stream) {
  using namespace polar_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (probe < 0 || probe >= kProbeCount || rows < 1 || cols < 1)
    return (int)cudaErrorInvalidValue;
  if (probe < kProbeArith
      && (rows != kProbeRows || cols % kProbeBlockCols != 0))
    return (int)cudaErrorInvalidValue;
  switch (probe) {
    case kProbeFori: launch_f32<kProbeFori>(xf, of, cols, st); break;
    case kProbeBcast: launch_f32<kProbeBcast>(xf, of, cols, st); break;
    case kProbeRoll: launch_f32<kProbeRoll>(xf, of, cols, st); break;
    case kProbeReduce: launch_f32<kProbeReduce>(xf, of, cols, st); break;
    case kProbeShift: launch_f32<kProbeShift>(xf, of, cols, st); break;
    case kProbeScratchFori:
      launch_f32<kProbeScratchFori>(xf, of, cols, st);
      break;
    case kProbeSweepCombo:
      launch_f32<kProbeSweepCombo>(xf, of, cols, st);
      break;
    case kProbeBigSweep: {
      const int err = launch_big(xf, of, cols, kProbeLoopSweeps, st);
      if (err) return err;
      break;
    }
    case kProbeBigSweepNoLoop: {
      const int err = launch_big(xf, of, cols, 1, st);
      if (err) return err;
      break;
    }
    case kProbeArith:
      launch_small<kProbeArith>(x, p, out, rows, cols, st);
      break;
    case kProbeGather:
      launch_small<kProbeGather>(x, p, out, rows, cols, st);
      break;
    default: launch_small<kProbeInt8>(x, p, out, rows, cols, st); break;
  }
  return (int)cudaGetLastError();
}
