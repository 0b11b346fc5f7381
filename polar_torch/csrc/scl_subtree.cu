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
// sums, stages 0..b-1) sit in the block's dynamic shared memory as
// [row][codeword][path], so a warp's lanes touch 32 neighbouring words;
// the upper stages that do not fit the wrapper's budget go to a global
// scratch [row][bs][path], which a warp also reads and writes in whole
// lines. A fork is top-L by rank over the group (2L compares a thread) and
// one exchange of the parent's state through shared memory, between
// __syncwarp barriers of the group's mask. The stage-b input is read from
// global memory, twice per element (the first f and the middle g), with
// any path stride (0 for a broadcast). The codeword's partial sums rise
// into the int8 global scratch like any stage's; a second, tiled kernel
// writes them to cw [2^b, L, bs] int32, whose path-major rows a group
// could only write 4 bytes to a line.
//
// What bounds it: the bytes bound is the input a, read once, and the
// codeword cw written once (for one fast main-path step at b=6, L=8,
// bs=8192 about 0.14 ms at 3.35 TB/s); the f/g, softplus and top-L work is
// smaller still. What sets the pace instead is latency: every f/g is a
// dependent shared-memory load, op, store per thread, and every fork three
// group barriers. Occupancy is set by registers and by the shared-memory
// budget (5 L (2^n_shared - 1) bytes of workspace per codeword plus its
// exchange arrays).
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

template <int L, bool kPc>
__global__ void __launch_bounds__(kThreads) scl_subtree_kernel(SubtreeArgs A) {
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

// cw [2^b, L, bs] int32 from the stage-b sums [2^b, bs, L] int8: a block
// takes kCwCols columns of one row through a shared tile, so both the read
// (kCwCols * L neighbouring bytes) and the write (kCwCols neighbouring
// int32 per path) are whole lines
constexpr int kCwCols = 32;

template <int L>
__global__ void __launch_bounds__(kCwCols * L) scl_cw_kernel(SubtreeArgs A) {
  __shared__ int8_t tile[kCwCols * L];
  const int j = blockIdx.y;
  const int c0 = blockIdx.x * kCwCols;
  const int t = threadIdx.x;
  const int8_t* src = stage_b_sums(A, L) + ((size_t)j * A.bs + c0) * L;
  if (c0 + t / L < A.bs) tile[t] = src[t];
  __syncthreads();
  const int l = t / kCwCols, c = t % kCwCols;
  if (c0 + c < A.bs)
    A.cw[((size_t)j * L + l) * A.bs + c0 + c] = tile[c * L + l];
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
  const dim3 cw_grid((A.bs + kCwCols - 1) / kCwCols, 1 << A.b);
  scl_cw_kernel<L><<<cw_grid, kCwCols * L, 0, st>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace polar_torch

// bytes of dynamic shared memory of a block with stages 0..n_shared-1 in
// shared memory
extern "C" long long scl_subtree_smem_bytes(int L, int n_shared) {
  return polar_torch::block_smem_bytes(L, n_shared);
}

// lloc: the global LLR stages n_shared..b-1, [2^b - 2^n_shared, bs, L]
// (null when n_shared == b); uloc: the global partial-sum stages
// n_shared..b, [2^(b+1) - 2^n_shared, bs, L]; pc: 1 when the schedule has
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
