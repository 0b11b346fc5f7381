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
// TB/s), a bf16 or int8 probe 16 KiB (0.005 us). A launch costs far more:
// the lightest kernels here take 1.5-1.8 us alone on the card, and a
// wrapper's call 9-15 us of the host's time (NVIDIA H100 80GB HBM3,
// 700.00 W; chip_smoke.py phase 15). That floor sits 20-190x above
// k_reduce's bound and 300-3000x, three orders of magnitude, above
// k_gather's; so their designs aim at the fewest dependent round trips
// to memory a launch, not at bandwidth. The stage sweeps need little
// arithmetic: off NaN the two rows of a pair take one value, so each group
// of rows that the stages pair inside (8 rows for k_sweepcombo, the 64-row
// block for k_big, whose 16 scratch tiles stay equal) ends as its least
// |x|, whatever the sweeps. These kernels do the work op by op as the TPU
// kernels do, k_big over all 16 tiles (about 1.7e7 row updates in four
// sweeps), so they run far above that bound. Every stage update takes the
// NaN bits XLA gives on the CPU (probes.cuh probe_minsum_rule: with a NaN
// the two rows of a pair may differ; k_big's partners send XLA's copies,
// probe_big_copy), in integer operations and selects.
//
// Design. Every probe mixes rows of one column only (the roll, the
// reduction, the row-bit selects, the gather and the stage partners).
// * k_fori, k_bcast, k_roll, k_shift and k_scratchfori: 4 CTAs of 128
//   threads, one CTA per TPU grid block, thread c on column c of its
//   block; the column's 64 values in registers; no barrier. k_bcast reads
//   block 0's column in every CTA, as its constant index map does. Aimed
//   only at being plainly right.
// * k_sweepcombo (replaces k_sweepcombo, :256): stages 0..2 pair rows
//   within aligned groups of 8, so each (column, group) evolves alone:
//   4,096 of them at [64, 512]. One thread a (column, group), its 8 values
//   in registers, read in one round of 8 loads and written by 8 stores; a
//   CTA of 128 threads takes 128 neighbouring columns of one group, so a
//   warp's access to a row is one 128-byte segment: 32 CTAs, 128 warps at
//   [64, 512]. Each stage's 4 pair updates are independent chains
//   (probes.cuh probe_combo_group).
// * k_reduce (replaces k_reduce, :227; bytes-bound, 256 KiB): CTAs of 64
//   threads on slabs of 32 columns (16 CTAs at [64, 512]). A thread owns
//   4 neighbouring columns of 8 consecutive rows and reads them in one
//   round of eight 16-byte loads; the 64 rows split across the 2 warps
//   (32 rows each). Each thread folds its rows, the 8 chunks' minima meet
//   in shared memory and every thread folds them in row order (ordered
//   trees, depth 3 + 3: the bits of one fold over the rows, probes.cuh
//   probe_min), then writes its rows of the broadcast as 16-byte stores.
//   Tensors not 16-byte aligned take the same kernel with 4-byte accesses.
// * k_big (replaces k_big, :275-298; make_bigsweep with and without its
//   loop): a scratch of 1,024 rows a column, 8 stages a sweep, 4 sweeps or
//   1. Stage s pairs row r with r ^ 2^s, so each 256-row quarter of the
//   scratch is swept alone, and stages 0..4 stay within 32 rows. So one
//   warp takes a (column, quarter) and holds it in registers, 8 rows a
//   lane: stages 0..2 pair a lane's registers, stages 3..7 lanes by
//   __shfl_xor_sync, each lane computing its own rows' values (probes.cuh
//   probe_big_*). A row's partner gets the copy XLA's fusion would give
//   it (probe_big_copy): each lane carries its rows' main and alternative
//   chains and computes, from the pair it updates, the value it sends at
//   the next stage, so one value a row is shuffled a stage. CTAs of 16
//   warps (4 columns, 128 CTAs at [64, 512]).
//   No shared memory and no barrier inside the sweep; the sweep count is a
//   template argument and every loop unrolls. The fill reads x straight
//   (64 values a column, 8 loads a lane). The quarters that never reach o
//   stay live by the fold: each output row is that row of the four
//   quarters folded by probe_min, which returns the bits of four equal
//   values, through a 4 KiB shared tile and the CTA's one barrier after
//   the sweeps; chip_smoke.py phase 15 counts each instance's shuffles in
//   its SASS (5 stages x 8 rows a sweep: 40 and 160). The TPU kernel's
//   whole sweep stays: every row of every quarter through every stage of
//   every sweep.
// * k_gather (replaces k_gather, :337; bytes-bound, 16 KiB at [8, 256]):
//   all of a slab's loads in one round, then one barrier, then the
//   stores, every NaN written as XLA's gather writes it (probes.cuh
//   probe_bf16_canon; two values a word at once, probe_bf16x2_canon). CTAs of 256 threads on slabs of up to 256 columns and all rows
//   (one CTA at [8, 256]): each thread stages 8 neighbouring columns of x
//   in a shared tile with one 16-byte load and reads their 8 pointers as
//   two 16-byte loads, then gathers its 8 outputs from the tile and
//   stores them as one 16-byte store: one round trip to memory where a
//   thread that walks its column's rows (a pointer load, a dependent x
//   load and a store a row, through pointers that may alias) makes 16 at
//   8 rows. Widths that are not a multiple of 8, and unaligned tensors,
//   take the same kernel element by element, the columns past the last
//   masked. A thread takes 4 units of 8 columns with their pointers held
//   from the first round, and more (up to 12, at 3,072 rows, whose 8
//   columns fill the 48 KiB tile) with their pointers read after the
//   barrier. More rows than the tile holds gather each element straight
//   from x (probe_gather_direct_kernel).
// * k_i8 (replaces k_i8, :340; bytes-bound, 16 KiB at [32, 256]): an
//   elementwise map, so the tensor is taken as n bytes in 16-byte units.
//   CTAs of 256 threads, two units a thread: both 16-byte loads issued
//   before either store, through __restrict__ pointers, so a launch makes
//   one round trip to memory (a thread that walked its column's 32 rows,
//   a load and a store a row through pointers that may alias, made 32).
//   The bytes map four a word in integer operations (probes.cuh
//   probe_int8x4, the wrap of int8 by construction). One CTA at [32, 256],
//   512 units: a second would only add a block to schedule. Unaligned
//   tensors take the same kernel byte by byte, and the last, partial unit
//   of a size not a multiple of 16 is masked byte by byte.
// * k_arith: CTAs of 256 threads, one thread a column (one CTA at the
//   probe's 256 columns), looping over the rows.
//
// The C ABI is one entry point a probe (probe_<name>), each launching its
// kernel on the given stream and returning a cudaError_t, so a wrapper
// makes one short call a launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libprobes.so probes.cu
#include <cuda_runtime.h>

#include "probes.cuh"

namespace polar_torch {

constexpr int kProbeBigCtaCols = 4;   // k_big's columns a CTA
constexpr int kProbeBigThreads = 32 * kProbeBigQuarters * kProbeBigCtaCols;
constexpr int kProbeSmallThreads = 256;
constexpr int kInt8Units = 2;         // k_i8's 16-byte units a thread
constexpr int kGatherDirectGrid = 132 * 8;  // grid-stride CTAs, 8 an SM

template <int P>
__global__ void __launch_bounds__(kProbeBlockCols)
    probe_f32_kernel(const float* x, float* o, int cols) {
  const int c = threadIdx.x;
  const int col = blockIdx.x * kProbeBlockCols + c;
  probe_column<P>(x + (P == kProbeBcast ? c : col), o + col, cols);
}

// k_sweepcombo: thread c of CTA (b, g) runs row group g (rows 8 g .. 8 g
// + 7) of column 128 b + c, so a warp's loads and stores of a row are 32
// neighbouring columns.
__global__ void __launch_bounds__(kProbeBlockCols)
    probe_combo_kernel(const float* __restrict__ x, float* __restrict__ o,
                       int cols) {
  const size_t at = (size_t)blockIdx.y * kProbeComboRows * cols
                    + blockIdx.x * kProbeBlockCols + threadIdx.x;
  probe_combo_group(x + at, o + at, cols);
}

template <bool kVec>
__global__ void __launch_bounds__(kReduceThreads)
    probe_reduce_kernel(const float* __restrict__ x, float* __restrict__ o,
                        int cols) {
  __shared__ ProbeVec part[kReduceChunks][kReduceQuads];
  const int q = threadIdx.x % kReduceQuads;   // 4 columns of the slab
  const int g = threadIdx.x / kReduceQuads;   // a chunk of rows
  const int col = blockIdx.x * kReduceCols + 4 * q;
  part[g][q] = probe_reduce_chunk<kVec>(x + col, cols, g);
  __syncthreads();
  probe_reduce_store<kVec>(o + col, cols, g,
                           probe_reduce_combine(&part[0][q], kReduceQuads));
}

// k_big: one warp a (column, quarter), kProbeBigCtaCols columns a CTA;
// lane l holds its quarter's rows 8 l .. 8 l + 7 (probes.cuh). No shared
// memory and no barrier until the sweeps end; then each warp's lanes 0..7
// leave their rows 0..63 in a shared tile, and the CTA folds the four
// quarters of each row and writes it.
template <int kSweeps>
__global__ void __launch_bounds__(kProbeBigThreads)
    probe_big_kernel(const float* __restrict__ x, float* __restrict__ o,
                     int cols) {
  __shared__ uint32_t rows[kProbeBigCtaCols][kProbeBigQuarters][kProbeRows];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int q = warp % kProbeBigQuarters, c = warp / kProbeBigQuarters;
  const int col0 = blockIdx.x * kProbeBigCtaCols;
  uint32_t v[kProbeBigLaneRows], w[kProbeBigLaneRows], t[kProbeBigLaneRows];
  probe_big_fill(x + col0 + c, cols, lane, v);
#pragma unroll
  for (int i = 0; i < kSweeps; ++i) {
    probe_big_start(v, w, t);
#pragma unroll
    for (int s = 0; s < kProbeBigInLane; ++s)
      probe_big_lane_stage<kSweeps>(v, w, t, s);
#pragma unroll
    for (int s = kProbeBigInLane; s < kProbeBigStages; ++s) {
      uint32_t part[kProbeBigLaneRows];
#pragma unroll
      for (int k = 0; k < kProbeBigLaneRows; ++k)
        part[k] = __shfl_xor_sync(0xffffffffu, t[k],
                                  1 << (s - kProbeBigInLane));
      probe_big_cross_stage<kSweeps>(v, w, t, part, s);
    }
  }
  if (lane < kProbeRows / kProbeBigLaneRows) {
#pragma unroll
    for (int k = 0; k < kProbeBigLaneRows; ++k)
      rows[c][q][kProbeBigLaneRows * lane + k] = v[k];
  }
  __syncthreads();
  // thread t writes row t / kProbeBigCtaCols of column t % kProbeBigCtaCols:
  // each row's columns side by side
  for (int t = threadIdx.x; t < kProbeRows * kProbeBigCtaCols;
       t += kProbeBigThreads) {
    const int r = t / kProbeBigCtaCols, cc = t % kProbeBigCtaCols;
    o[r * cols + col0 + cc] = probe_big_fold(&rows[cc][0][r], kProbeRows);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kGatherThreads)
    probe_gather_kernel(const uint16_t* __restrict__ x,
                        const int32_t* __restrict__ p,
                        uint16_t* __restrict__ o, int rows, int cols,
                        int n8) {
  extern __shared__ ProbeVec smem[];  // the tile [rows][8 n8]
  uint16_t* tile = reinterpret_cast<uint16_t*>(smem);
  const int units = rows * n8, s = blockIdx.x;
  int32_t ptr[kGatherUnits][8];
#pragma unroll
  for (int k = 0; k < kGatherUnits; ++k) {
    const int u = threadIdx.x + k * kGatherThreads;
    if (u < units) {
      probe_gather_stage<kVec>(x, tile, cols, n8, s, u);
      probe_gather_ptrs<kVec>(p, cols, n8, s, u, ptr[k]);
    }
  }
  // units past the held pointers; kept rolled, as unrolled they made ptxas
  // spill held pointers to local memory (16 bytes, in the first round)
#pragma unroll 1
  for (int u = threadIdx.x + kGatherCtaUnits; u < units; u += kGatherThreads)
    probe_gather_stage<kVec>(x, tile, cols, n8, s, u);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kGatherUnits; ++k) {
    const int u = threadIdx.x + k * kGatherThreads;
    if (u < units) probe_gather_store<kVec>(tile, ptr[k], o, cols, n8, s, u);
  }
#pragma unroll 1
  for (int u = threadIdx.x + kGatherCtaUnits; u < units;
       u += kGatherThreads) {
    int32_t later[8];
    probe_gather_ptrs<kVec>(p, cols, n8, s, u, later);
    probe_gather_store<kVec>(tile, later, o, cols, n8, s, u);
  }
}

__global__ void __launch_bounds__(kGatherThreads)
    probe_gather_direct_kernel(const uint16_t* __restrict__ x,
                               const int32_t* __restrict__ p,
                               uint16_t* __restrict__ o, int cols,
                               size_t n) {
  const size_t step = (size_t)gridDim.x * kGatherThreads;
  for (size_t i = blockIdx.x * (size_t)kGatherThreads + threadIdx.x; i < n;
       i += step)
    o[i] = probe_gather_direct(x, p, cols, i);
}

template <int P>
__global__ void __launch_bounds__(kProbeSmallThreads)
    probe_small_kernel(const void* x, void* o, int rows, int cols) {
  const int c = blockIdx.x * kProbeSmallThreads + threadIdx.x;
  if (c >= cols) return;
  static_assert(P == kProbeArith, "k_arith's kernel");
  probe_arith_column(static_cast<const uint16_t*>(x) + c,
                     static_cast<uint16_t*>(o) + c, rows, cols);
}

// k_i8: thread i of CTA b maps units b kInt8Units kProbeSmallThreads + k
// kProbeSmallThreads + i, k < kInt8Units: every load of the thread, then
// every store.
template <bool kVec>
__global__ void __launch_bounds__(kProbeSmallThreads)
    probe_int8_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ o,
                      size_t n) {
  const size_t units = (n + kInt8Unit - 1) / kInt8Unit;
  const size_t u0 = (size_t)blockIdx.x * kInt8Units * kProbeSmallThreads
                    + threadIdx.x;
  ProbeVec v[kInt8Units];
#pragma unroll
  for (int k = 0; k < kInt8Units; ++k) {
    const size_t u = u0 + k * kProbeSmallThreads;
    if (u < units) v[k] = probe_int8_load<kVec>(x, n, u);
  }
#pragma unroll
  for (int k = 0; k < kInt8Units; ++k) {
    const size_t u = u0 + k * kProbeSmallThreads;
    if (u < units) probe_int8_store<kVec>(o, n, u, v[k]);
  }
}

bool f32_shape_ok(int cols) {
  return cols >= kProbeBlockCols && cols % kProbeBlockCols == 0;
}

bool aligned16(const void* a, const void* b, const void* c = nullptr) {
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) & 15) == 0;
}

template <int P>
int launch_f32(const float* x, float* o, int cols, void* st) {
  if (!f32_shape_ok(cols)) return (int)cudaErrorInvalidValue;
  probe_f32_kernel<P><<<cols / kProbeBlockCols, kProbeBlockCols, 0,
                        static_cast<cudaStream_t>(st)>>>(x, o, cols);
  return (int)cudaGetLastError();
}

template <int kSweeps>
int launch_big(const float* x, float* o, int cols, void* st) {
  if (!f32_shape_ok(cols)) return (int)cudaErrorInvalidValue;
  probe_big_kernel<kSweeps><<<cols / kProbeBigCtaCols, kProbeBigThreads, 0,
                              static_cast<cudaStream_t>(st)>>>(x, o, cols);
  return (int)cudaGetLastError();
}

template <int P>
int launch_small(const void* x, void* o, int rows, int cols, void* st) {
  if (rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  const int grid = (cols + kProbeSmallThreads - 1) / kProbeSmallThreads;
  probe_small_kernel<P><<<grid, kProbeSmallThreads, 0,
                          static_cast<cudaStream_t>(st)>>>(x, o, rows, cols);
  return (int)cudaGetLastError();
}

}  // namespace polar_torch

// One entry point a probe: one launch on stream `stream` of x (f32 [64,
// cols] with cols a multiple of 128; bf16 or int8 [rows, cols] for arith,
// gather and int8; for gather also the int32 pointers p of x's shape)
// into out, of x's shape and type. Each returns a cudaError_t:
// cudaErrorInvalidValue for a shape its kernel does not take (an f32
// probe's columns not a multiple of 128, an empty tensor).
extern "C" {

#define PROBE_F32_ENTRY(name, id)                                     \
  int probe_##name(const float* x, float* out, int cols, void* stream) { \
    return polar_torch::launch_f32<polar_torch::id>(x, out, cols, stream); \
  }
PROBE_F32_ENTRY(fori, kProbeFori)
PROBE_F32_ENTRY(bcast, kProbeBcast)
PROBE_F32_ENTRY(roll, kProbeRoll)
PROBE_F32_ENTRY(shift, kProbeShift)
PROBE_F32_ENTRY(scratchfori, kProbeScratchFori)
#undef PROBE_F32_ENTRY

int probe_sweepcombo(const float* x, float* out, int cols, void* stream) {
  using namespace polar_torch;
  if (!f32_shape_ok(cols)) return (int)cudaErrorInvalidValue;
  const dim3 grid(cols / kProbeBlockCols, kProbeRows / kProbeComboRows);
  probe_combo_kernel<<<grid, kProbeBlockCols, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, out, cols);
  return (int)cudaGetLastError();
}

int probe_bigsweep(const float* x, float* out, int cols, void* stream) {
  return polar_torch::launch_big<polar_torch::kProbeLoopSweeps>(x, out, cols,
                                                                stream);
}

int probe_bigsweep_noloop(const float* x, float* out, int cols,
                          void* stream) {
  return polar_torch::launch_big<1>(x, out, cols, stream);
}

int probe_reduce(const float* x, float* out, int cols, void* stream) {
  using namespace polar_torch;
  if (!f32_shape_ok(cols)) return (int)cudaErrorInvalidValue;
  const int grid = cols / kReduceCols;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (aligned16(x, out))
    probe_reduce_kernel<true><<<grid, kReduceThreads, 0, st>>>(x, out, cols);
  else
    probe_reduce_kernel<false><<<grid, kReduceThreads, 0, st>>>(x, out, cols);
  return (int)cudaGetLastError();
}

int probe_arith(const void* x, void* out, int rows, int cols, void* stream) {
  return polar_torch::launch_small<polar_torch::kProbeArith>(x, out, rows,
                                                             cols, stream);
}

int probe_int8(const void* x, void* out, int rows, int cols, void* stream) {
  using namespace polar_torch;
  if (rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)rows * cols;
  const size_t per_cta = (size_t)kInt8Units * kProbeSmallThreads * kInt8Unit;
  const unsigned grid = (unsigned)((n + per_cta - 1) / per_cta);
  const auto* xb = static_cast<const int8_t*>(x);
  auto* ob = static_cast<int8_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (aligned16(x, out))
    probe_int8_kernel<true><<<grid, kProbeSmallThreads, 0, st>>>(xb, ob, n);
  else
    probe_int8_kernel<false><<<grid, kProbeSmallThreads, 0, st>>>(xb, ob, n);
  return (int)cudaGetLastError();
}

int probe_gather(const uint16_t* x, const int32_t* p, uint16_t* out,
                 int rows, int cols, void* stream) {
  using namespace polar_torch;
  if (rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows > kGatherTileRows) {
    const size_t n = (size_t)rows * cols;
    const size_t blocks = (n + kGatherThreads - 1) / kGatherThreads;
    const int grid = blocks < kGatherDirectGrid ? (int)blocks
                                                : kGatherDirectGrid;
    probe_gather_direct_kernel<<<grid, kGatherThreads, 0, st>>>(x, p, out,
                                                                cols, n);
    return (int)cudaGetLastError();
  }
  const int n8 = probe_gather_n8(rows);
  const int slab = 8 * n8;
  const dim3 grid((cols + slab - 1) / slab);
  const size_t smem = (size_t)rows * n8 * sizeof(ProbeVec);
  if (cols % 8 == 0 && aligned16(x, p, out))
    probe_gather_kernel<true><<<grid, kGatherThreads, smem, st>>>(
        x, p, out, rows, cols, n8);
  else
    probe_gather_kernel<false><<<grid, kGatherThreads, smem, st>>>(
        x, p, out, rows, cols, n8);
  return (int)cudaGetLastError();
}

}  // extern "C"
