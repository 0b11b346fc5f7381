// SC subtree kernel for Hopper (sm_90a).
//
// Replaces polar_tpu/models/polar/pallas_scl.py::_sc_subtree_kernel
// (pallas_scl.py:832, launched by sc_subtree_pallas): the successive-
// cancellation decode of one 2^b-leaf subtree per codeword, static
// rate-0-pruned schedule (ops z/f/i) or the traced form (op 't', frozen-ness
// read from frz). The per-codeword routine lives in sc_subtree.cuh and is
// shared with the host build that the CPU tests run. The static form also
// takes p, the parity-check leaf of PC-aided decoding, which the JAX
// package runs only on its unrolled XLA tree (polar_tpu/models/polar/
// sc.py, _decode_tree): lane 0 keeps the codeword's PC register.
//
// What bounds it: bytes. One call must read a (f32) and write cw (int32)
// once, 8 bytes per leaf and codeword (at b = 8, bs = 8192, 16 MiB, 0.005
// ms at 3.35 TB/s); the f/g and partial-sum work is a few f32 operations
// per element and smaller still. The first design ran one thread per
// codeword with the workspaces in global memory: every f/g was a
// dependent global load, op and store, and bs = 8192 threads gave two warps
// an SM to hide it (69x the bound at b = 8).
//
// Design (the pattern of the SCL kernel's redesign): a group of G threads
// of one warp decodes one codeword (G = 4..32, a template parameter; a
// block of 128 threads holds 128 / G codewords; the wrapper takes 8,
// which beat 4, 16 and 32 on the card: most stages of a decode are a few
// rows wide, and a wider group idles there). A stage's segment is split
// across the group's lanes, with a __syncwarp on the group's mask after
// each stage. The workspaces (lloc f32, uloc int8: 5 (2^b - 1) bytes a
// codeword) sit in shared memory up to the wrapper's budget, the stages
// above it in a codeword-major global scratch (48 KiB a block: at b=9, 8
// lanes, stages 0..5 shared and four blocks an SM beat all nine stages
// shared and two). The block reads a's rows into per-codeword tiles in
// shared memory (a row's 128 / G neighbouring columns at a time) and
// writes cw from a tile of the codeword's sums the same way, so no group
// walks a batch-minor array with a stride of bs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsc_subtree.so sc_subtree.cu
#include <cuda_runtime.h>

#include "sc_subtree.cuh"

namespace polar_torch {

// the G lanes of one codeword inside a warp; host-callable so that the
// routine's template needs no __device__-only calls, but only the device
// pass reaches the barrier
template <int G>
struct ScWarpGroup {
  static constexpr int kPer = 1;
  int l;
  unsigned mask;
  PT_HD PT_INLINE int lane(int) const { return l; }
  PT_HD PT_INLINE void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp(mask);
#endif
  }
};

template <int G>
__global__ void __launch_bounds__(kScThreads) sc_subtree_kernel(ScArgs A) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int C = kScThreads / G;
  const int w = 1 << A.b;
  const int col0 = blockIdx.x * C;
  const int t = threadIdx.x;
  size_t off_l, off_u, off_cw;
  sc_smem_bytes(A.b, A.n_shared, C, &off_l, &off_u, &off_cw);
  float* at = reinterpret_cast<float*>(smem);
  int8_t* ct = reinterpret_cast<int8_t*>(smem + off_cw);
  const int ts = sc_tile_stride(A.b), cs = sc_cw_stride(A.b);
  // a's rows into the tiles, C neighbouring columns at a time
  for (int i = t; i < w * C; i += kScThreads) {
    const int j = i / C, c = i % C;
    if (col0 + c < A.bs) at[c * ts + j] = A.a[j * A.a_row_stride + col0 + c];
  }
  __syncthreads();
  const int c = t / G;
  const int col = col0 + c;
  if (col < A.bs) {                   // whole groups leave together
    const int rows = sc_rows(A.n_shared);
    const ScWork W{A, at + c * ts,
                   reinterpret_cast<float*>(smem + off_l) + c * rows,
                   reinterpret_cast<int8_t*>(smem + off_u) + c * rows,
                   ct + c * cs, col};
    const int lane = t % 32;
    const unsigned mask = G == 32 ? 0xffffffffu
        : ((1u << G) - 1u) << (lane & ~(G - 1));
    sc_codeword<G>(ScWarpGroup<G>{t % G, mask}, A, W);
  }
  __syncthreads();
  for (int i = t; i < w * C; i += kScThreads) {
    const int j = i / C, cc = i % C;
    if (col0 + cc < A.bs)
      A.cw[(size_t)j * A.bs + col0 + cc] = ct[cc * cs + j];
  }
}

template <int G>
int launch(const ScArgs& A, cudaStream_t st) {
  constexpr int C = kScThreads / G;
  const size_t smem = sc_smem_bytes(A.b, A.n_shared, C, 0, 0, 0);
  cudaError_t err = cudaFuncSetAttribute(
      sc_subtree_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((A.bs + C - 1) / C);
  sc_subtree_kernel<G><<<grid, kScThreads, smem, st>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace polar_torch

// bytes of dynamic shared memory of a block (128 / G codewords) with
// stages 0..n_shared-1 in shared memory
extern "C" long long sc_subtree_smem_bytes(int b, int G, int n_shared) {
  return (long long)polar_torch::sc_smem_bytes(
      b, n_shared, polar_torch::kScThreads / G, 0, 0, 0);
}

// lloc / uloc: the global stages n_shared..b-1, [bs, 2^b - 2^n_shared]
// each (null when n_shared == b). Returns a cudaError_t.
extern "C" int sc_subtree_launch(const float* a, long long a_row_stride,
                                 const int32_t* frz, const int32_t* sched,
                                 int n_ops, int32_t* cw, float* lloc,
                                 int8_t* uloc, int b, int bs, float llr_max,
                                 int exact, int n_shared, int lanes,
                                 void* stream) {
  using namespace polar_torch;
  if (b < 1 || b > kScMaxB || n_shared < 0 || n_shared > b)
    return (int)cudaErrorInvalidValue;
  ScArgs A{a, a_row_stride, frz, sched, n_ops, cw, lloc, uloc, b, bs,
           llr_max, exact, n_shared};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 4: return launch<4>(A, st);
    case 8: return launch<8>(A, st);
    case 16: return launch<16>(A, st);
    case 32: return launch<32>(A, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// blocks of the kernel that one SM holds at once (the occupancy API) at
// depth b, G lanes a codeword and n_shared shared stages; -1 on error
extern "C" int sc_subtree_blocks_per_sm(int b, int G, int n_shared) {
  using namespace polar_torch;
  const size_t smem = sc_smem_bytes(b, n_shared, kScThreads / G, 0, 0, 0);
  void (*kernel)(ScArgs) = G == 4 ? sc_subtree_kernel<4>
      : G == 8 ? sc_subtree_kernel<8> : G == 16 ? sc_subtree_kernel<16>
      : sc_subtree_kernel<32>;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  int n = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kScThreads,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}
