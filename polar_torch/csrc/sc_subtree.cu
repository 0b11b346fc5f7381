// SC subtree kernel for Hopper (sm_90a).
//
// Replaces polar_tpu/models/polar/pallas_scl.py::_sc_subtree_kernel
// (pallas_scl.py:832, launched by sc_subtree_pallas): the successive-
// cancellation decode of one 2^b-leaf subtree per codeword, static
// rate-0-pruned schedule (ops z/f/i) or the traced form (op 't', frozen-ness
// read from frz). One thread decodes one codeword; the per-codeword routine
// lives in sc_subtree.cuh and is shared with the host build that the CPU
// tests run.
//
// What bounds it: the workspaces (lloc f32, uloc int8, [2^b - 1, bs]) sit in
// global memory, so every f/g evaluation is a load/store pair through L2 and
// HBM, coalesced across the warp (batch-minor layout) but latency-bound: the
// f/g arithmetic is a few fp32 ALU ops per value. One thread per codeword
// gives bs = 8192 threads, two warps per SM on 132 SMs, far too few to hide
// that latency. Blocks of 32 threads spread them over every SM.
//
// What a later design would do about it: several threads per codeword (one
// per element of a stage segment, as the TPU kernel's lanes do) with the
// upper stages of lloc/uloc in shared memory, or the tree cut at a smaller b
// so the upper stages run as whole-batch tensor ops (the sweep's depth).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsc_subtree.so sc_subtree.cu
#include <cuda_runtime.h>

#include "sc_subtree.cuh"

namespace polar_torch {

__global__ void sc_subtree_kernel(ScArgs A) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col < A.bs) sc_column(A, col);
}

}  // namespace polar_torch

extern "C" int sc_subtree_launch(const float* a, long long a_row_stride,
                                 const int32_t* frz, const int32_t* sched,
                                 int n_ops, int32_t* cw, float* lloc,
                                 int8_t* uloc, int b, int bs, float llr_max,
                                 int exact, void* stream) {
  using namespace polar_torch;
  ScArgs A{a, a_row_stride, frz, sched, n_ops, cw, lloc, uloc, b, bs,
           llr_max, exact};
  const int threads = 32;
  const dim3 grid((bs + threads - 1) / threads);
  sc_subtree_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}
