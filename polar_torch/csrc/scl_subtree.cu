// Fast-SCL subtree kernel for Hopper (sm_90a).
//
// Replaces, in polar_tpu/models/polar/pallas_scl.py, _subtree_kernel (its
// sched_static form, ops z/r/o/s/f/i, and its traced 't' form with
// cond_leaves) and _subtree_kernel_blocked (the same contract at L = 16, 32,
// which the TPU holds as (8, TB) blocks only because Mosaic gathers one
// 8-row tile at a time). The per-codeword routine lives in scl_subtree.cuh
// and is shared with the host build that the CPU tests run. The static form
// also takes p, the parity-check leaf of PC-aided decoding, which the JAX
// package runs only on its unrolled XLA tree (polar_tpu/models/polar/
// scl.py, _node): a path's PC register rides its per-lane state.
//
// Design: a group of L threads of one warp decodes one codeword, one
// thread per path (32 / L codewords per warp; a block of 128 threads holds
// 128 / L codewords). Each thread keeps its path's metric, stage pointers
// and flip bits in registers. The workspaces (f32 LLRs and int8 partial
// sums, stages 0..b-1) sit in the block's dynamic shared memory, each stage
// of at least 4 rows as row quads [quad][codeword][path][4], so a lane moves
// 4 rows of its path in one 16-byte (or 4-byte) access and a warp's lanes
// touch 512 (128) neighbouring bytes, without bank conflicts; stages 0 and
// 1 keep the scalar [row][codeword][path] in three rows after the quads.
// The upper stages that do not fit the wrapper's budget go to a global
// scratch laid out alike over the batch ([quad][bs][path][4]), which a
// warp also reads and writes in whole lines. A fork is top-L by rank over
// the group (2L compares a thread) and one exchange of the parent's state
// through shared memory, between __syncwarp barriers of the group's mask.
// The stage-b input is read from global memory, twice per element (the
// first f and the middle g), with any path stride (0 for a broadcast). The
// codeword's partial sums rise into the int8 global scratch as quads like
// any stage's; a second, tiled kernel writes them to cw [2^b, L, bs]
// int32, whose path-major rows a group could only write 4 bytes to a line.
//
// What bounds it: the bytes bound is the input a, read once, and the
// codeword cw written once (for the main path's one call at b=10, L=8,
// bs=8192 about 0.09 ms at 3.35 TB/s); the f/g, softplus and top-L work is
// smaller still. What sets the pace instead is the row loops' memory
// instructions and round trips: every f/g row is a dependent load, op,
// store per lane, and every fork three group barriers. So the loops move a
// quad a lane an access and, from 8 rows on, issue two quads' loads before
// their stores (8 rows a round trip); 98% of the main path's f/g and rise
// rows a path lie in stages of at least 4 rows (cuda_scl.row_counts).
// Occupancy: the budget's 48 KiB (5 L (2^n_shared - 1) bytes of workspace
// per codeword plus its exchange arrays, the same in either layout) gives
// 4 blocks an SM at n_shared 6, L = 8, which holds the whole bs 8192 batch
// (512 blocks against 528 places); at most 128 registers a thread keep it
// there. A leaf schedule (the plain and PC sweeps) spends its time in ops
// over stages of 1-4 rows, where quads save little and each op's fixed
// cost (schedule read, live masks, pointer resets, rise, barrier) sets the
// pace; the PC build walks each aligned block of frozen leaves inside one
// op (OP_FRUN), stages 1 and 2 in registers. Leaf and fast decodes slow
// down with the kernel's code size (H100 runs: a few hundred instructions
// more cost up to 10%), so the loops keep one copy of each op where they
// can, and the frozen-run walk exists in the PC build only.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libscl_subtree.so scl_subtree.cu
#include <cuda_runtime.h>

#include "scl_subtree.cuh"

namespace polar_torch {

// the L lanes of one codeword inside a warp; host-callable so that the
// routine's template needs no __device__-only calls, but only the device
// pass reaches the barrier
template <int L>
struct WarpGroup {
  static constexpr int kPer = 1;
  int l;
  unsigned mask;
  PT_HD int lane(int) const { return l; }
  PT_HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp(mask);
#endif
  }
};

// at least 4 blocks an SM: at most 128 registers a thread
template <int L, bool kPc>
__global__ void __launch_bounds__(kThreads, 4)
    scl_subtree_kernel(SubtreeArgs A) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int C = kThreads / L;
  const int c = threadIdx.x / L;
  const int col = blockIdx.x * C + c;
  if (col >= A.bs) return;            // whole groups leave together
  size_t off_gs, off_u;
  smem_bytes<L>(A.n_shared, C, &off_gs, &off_u);
  GroupShared<L>* gs = reinterpret_cast<GroupShared<L>*>(smem + off_gs);
  const int lane = threadIdx.x % 32;
  const unsigned mask = L == 32 ? 0xffffffffu
      : ((1u << L) - 1u) << (lane & ~(L - 1));
  const WarpGroup<L> g{(int)(threadIdx.x % L), mask};
  subtree_codeword<L, kPc>(g, A, gs[c], reinterpret_cast<float*>(smem),
                      reinterpret_cast<int8_t*>(smem + off_u), C, c, col);
}

// cw [2^b, L, bs] int32 from the stage-b sums: a block takes kCwCols
// columns of one quad of rows (from b = 2 on; else of one row) through a
// shared tile, so both the read (kCwCols * L neighbouring words) and the
// writes (kCwCols neighbouring int32 per path and row) are whole lines
constexpr int kCwCols = 32;

template <int L>
__global__ void __launch_bounds__(kCwCols * L) scl_cw_kernel(SubtreeArgs A) {
  constexpr int kPitch = L | 1;   // words between columns: no bank conflict
  __shared__ uint32_t tile[kCwCols * kPitch];
  const int j = blockIdx.y;
  const int c0 = blockIdx.x * kCwCols;
  const int t = threadIdx.x;
  const int8_t* sums = stage_b_sums(A, L);
  const int l = t / kCwCols, c = t % kCwCols;
  if (A.b >= 2) {
    // quad j: one word of 4 rows per (column, path)
    const uint32_t* src = reinterpret_cast<const uint32_t*>(sums)
        + ((size_t)j * A.bs + c0) * L;
    if (c0 + t / L < A.bs) tile[(t / L) * kPitch + t % L] = src[t];
    __syncthreads();
    if (c0 + c < A.bs) {
      const uint32_t w = tile[c * kPitch + l];
      for (int k = 0; k < 4; ++k)
        A.cw[((size_t)(4 * j + k) * L + l) * A.bs + c0 + c] =
            (int8_t)(w >> (8 * k));
    }
  } else {
    const int8_t* src = sums + ((size_t)j * A.bs + c0) * L;
    if (c0 + t / L < A.bs) tile[(t / L) * kPitch + t % L] = (uint8_t)src[t];
    __syncthreads();
    if (c0 + c < A.bs)
      A.cw[((size_t)j * L + l) * A.bs + c0 + c] =
          (int8_t)tile[c * kPitch + l];
  }
}

// the decode: the routine's build with the PC register (kPc) or without
template <int L, bool kPc>
cudaError_t launch_decode(const SubtreeArgs& A, cudaStream_t st) {
  const size_t smem = smem_bytes<L>(A.n_shared, kThreads / L, 0, 0);
  cudaError_t err = cudaFuncSetAttribute(
      scl_subtree_kernel<L, kPc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int per_block = kThreads / L;
  const dim3 grid((A.bs + per_block - 1) / per_block);
  scl_subtree_kernel<L, kPc><<<grid, kThreads, smem, st>>>(A);
  return cudaGetLastError();
}

template <int L>
int launch(const SubtreeArgs& A, cudaStream_t st) {
  cudaError_t err = A.pc ? launch_decode<L, true>(A, st)
                         : launch_decode<L, false>(A, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 cw_grid((A.bs + kCwCols - 1) / kCwCols,
                     A.b >= 2 ? 1 << (A.b - 2) : 1 << A.b);
  scl_cw_kernel<L><<<cw_grid, kCwCols * L, 0, st>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace polar_torch

// bytes of dynamic shared memory of a block with stages 0..n_shared-1 in
// shared memory
extern "C" long long scl_subtree_smem_bytes(int L, int n_shared) {
  return polar_torch::block_smem_bytes(L, n_shared);
}

namespace polar_torch {

template <int L>
int decode_blocks_per_sm(int pc, int n_shared) {
  const size_t smem = smem_bytes<L>(n_shared, kThreads / L, 0, 0);
  const void* fn = pc ? (const void*)scl_subtree_kernel<L, true>
                      : (const void*)scl_subtree_kernel<L, false>;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  int n = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads, smem)
      != cudaSuccess)
    return -1;
  return n;
}

}  // namespace polar_torch

// resident blocks an SM of the decode kernel at list size L (the PC build
// when pc) with stages 0..n_shared-1 in shared memory; -1 on an error
extern "C" int scl_subtree_blocks_per_sm(int L, int pc, int n_shared) {
  using namespace polar_torch;
  switch (L) {
    case 1: return decode_blocks_per_sm<1>(pc, n_shared);
    case 2: return decode_blocks_per_sm<2>(pc, n_shared);
    case 4: return decode_blocks_per_sm<4>(pc, n_shared);
    case 8: return decode_blocks_per_sm<8>(pc, n_shared);
    case 16: return decode_blocks_per_sm<16>(pc, n_shared);
    case 32: return decode_blocks_per_sm<32>(pc, n_shared);
    default: return -1;
  }
}

// lloc: the global LLR stages n_shared..b-1, 2^b - 2^n_shared rows of bs *
// L floats, quads then scalar rows (null when n_shared == b); uloc: the
// global partial-sum stages n_shared..b, 2^(b+1) - 2^n_shared rows of bs *
// L bytes, laid out alike; pc: 1 when the schedule has
// p leaves. Launches the decode, then the transpose of the stage-b sums
// into cw. Returns a cudaError_t.
extern "C" int scl_subtree_launch(const float* a, long long a_row_stride,
                                  long long a_l_stride, const float* pm_in,
                                  const int32_t* frz, const int32_t* sched,
                                  int n_ops, int32_t* cw,
                                  int32_t* p_out, float* pm_out, float* lloc,
                                  int8_t* uloc, int b, int L, int bs,
                                  float llr_max, int exact, int n_shared,
                                  int pc, void* stream) {
  using namespace polar_torch;
  if (n_shared < 0 || n_shared > b) return (int)cudaErrorInvalidValue;
  SubtreeArgs A{a, a_row_stride, a_l_stride, pm_in, frz, sched, n_ops, cw,
                p_out, pm_out, lloc, uloc, b, bs, llr_max, exact, n_shared,
                pc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 1: return launch<1>(A, st);
    case 2: return launch<2>(A, st);
    case 4: return launch<4>(A, st);
    case 8: return launch<8>(A, st);
    case 16: return launch<16>(A, st);
    case 32: return launch<32>(A, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
