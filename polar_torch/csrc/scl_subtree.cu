// Fast-SCL subtree kernel for Hopper (sm_90a).
//
// Replaces, in polar_tpu/models/polar/pallas_scl.py, _subtree_kernel (its
// sched_static form, ops z/r/o/s/f/i, and its traced 't' form with
// cond_leaves) and _subtree_kernel_blocked (the same contract at L = 16, 32,
// which the TPU holds as (8, TB) blocks only because Mosaic gathers one
// 8-row tile at a time). One thread decodes one codeword; the per-codeword
// routine lives in scl_subtree.cuh and is shared with the host build that
// the CPU tests run. L = 16, 32 keep their path pointers as one byte per
// path, and their list state (pm, candidates, rate-1 order) lives in the
// thread's stack in local memory (9.5 KB per thread at L = 32).
//
// What bounds it: the workspaces (lloc f32, uloc int8, [2^b - 1, L, bs]) sit
// in global memory, so every f/g evaluation is a dependent load/store through
// L2 and HBM; reads through a forked path pointer break coalescing (threads of
// a warp read different path slots). The arithmetic is a few fp32 ALU ops per
// loaded value. And bs = 8192 codewords give 8192 threads, about two warps per
// SM on 132 SMs, too few to hide that latency. L = 16, 32 launch one warp
// per block, so a batch of 2048 codewords still reaches 64 SMs.
//
// What a later design would do about it: give each codeword a group of L
// threads (one per path) with warp-shuffle top-L, keep the upper stages of
// lloc/uloc in shared memory or registers (a b=10 subtree needs 36 KB per
// codeword at L=8, so tile the batch and split the tree at a smaller b), and
// pick b from the card's shared-memory budget.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libscl_subtree.so scl_subtree.cu
#include <cuda_runtime.h>

#include "scl_subtree.cuh"

namespace polar_torch {

template <int L>
__global__ void scl_subtree_kernel(SubtreeArgs A) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col < A.bs) subtree_column<L>(A, col);
}

}  // namespace polar_torch

extern "C" int scl_subtree_launch(const float* a, long long a_row_stride,
                                  long long a_l_stride, const float* pm_in,
                                  const int32_t* frz, const int32_t* sched,
                                  int n_ops, int32_t* cw,
                                  int32_t* p_out, float* pm_out, float* lloc,
                                  int8_t* uloc, int b, int L, int bs,
                                  float llr_max, int exact, void* stream) {
  using namespace polar_torch;
  SubtreeArgs A{a, a_row_stride, a_l_stride, pm_in, frz, sched, n_ops, cw,
                p_out, pm_out, lloc, uloc, b, bs, llr_max, exact};
  const int threads = L <= 8 ? 64 : 32;
  const dim3 grid((bs + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 1: scl_subtree_kernel<1><<<grid, threads, 0, st>>>(A); break;
    case 2: scl_subtree_kernel<2><<<grid, threads, 0, st>>>(A); break;
    case 4: scl_subtree_kernel<4><<<grid, threads, 0, st>>>(A); break;
    case 8: scl_subtree_kernel<8><<<grid, threads, 0, st>>>(A); break;
    case 16: scl_subtree_kernel<16><<<grid, threads, 0, st>>>(A); break;
    case 32: scl_subtree_kernel<32><<<grid, threads, 0, st>>>(A); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
