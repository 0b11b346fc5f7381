// Belief-propagation decoder kernel for Hopper (sm_90a).
//
// Replaces polar_tpu/models/polar/pallas_bp.py::_bp_kernel (pallas_bp.py:57,
// launched by bp_pallas / _bp_pallas_impl): the whole BP decode, num_iter
// sweeps of scaled min-sum or exact processing-element updates over the
// message lattice, with the G-matrix early stop every check_every sweeps
// and the optional convergence flag. The schedule and the arithmetic live in
// bp.cuh and are shared with the host build that the CPU tests run.
//
// What bounds it: issue slots. A processing element (PE) of scaled min-sum
// is about 13 instructions (an add, two 5-instruction minsums, a product, a
// fused multiply-add); the bytes (the LLRs in, the decisions out) are far
// below. The warp-stage design (a CTA of 512 threads a codeword, stages
// 0..4 by warp shuffles, stages 5..S-1 one at a time in shared memory
// between barriers) spent about 85-95 issue slots a PE at n = 1024
// (PERF.md §6): shuffles and selects in the warp stages; index
// arithmetic, four shared loads, two stores and a barrier a stage in the
// CTA stages; runtime mode flags in every PE; one PE a thread a stage,
// each hanging on the one before. Cutting its barriers from 10 to 6 a
// sweep alone tied.
//
// Design (bp.cuh, BpTile): the stages in groups of three, a thread owning
// the 8 rows of its group's three bits, so that the PEs of three stages
// run on its own registers with fixed indices (no shuffle, select or
// address arithmetic), 4 independent PEs a stage. Only the levels between
// groups pass through shared memory (padded so that every group's accesses
// are free of bank conflicts); a group's interior messages stay in its
// owner's registers across sweeps. At n = 1024: 128 threads a codeword, 6
// barriers a sweep, 33,408 B of shared memory a CTA, and l_0 and r_S (read
// by the check and the output alone) left out of the sweeps. The mode and S are template parameters (bp_kernel_tiled<S, mode,
// bf16>, 66 instances), so no PE branches. The check runs the XOR
// butterfly's stages 0..2 on a thread's 8 bits, the lane bits' stages by
// shuffles and the warp bits' through a byte a thread in shared memory.
// The bf16 lattice (bp_launch(..., bf16 = 1)) is the same template with
// kBf16: 16-bit messages in shared memory and a rounding to bf16 after
// every op; its bound is the f32 form's.
// From n = 4096 (or with the global form forced) the lattice sits in a
// global scratch that the wrapper allocates, and bp_kernel<bf16> keeps the
// warp-stage schedule: 512 threads loop over the 64-row blocks, the warp
// stages' messages go through the scratch around each use.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbp.so bp.cu
#include <cuda_runtime.h>

#include "bp.cuh"

namespace polar_torch {

// one CTA, a lane per thread; host-callable so that the routine's template
// needs no __device__-only calls, but only the device pass reaches the
// CUDA builtins
struct BpCta {
  PT_HD PT_INLINE int per() const { return 1; }
  PT_HD PT_INLINE int tid(int) const {
#ifdef __CUDA_ARCH__
    return threadIdx.x;
#else
    return 0;
#endif
  }
  PT_HD PT_INLINE int size() const {
#ifdef __CUDA_ARCH__
    return blockDim.x;
#else
    return 1;
#endif
  }
  PT_HD PT_INLINE void sync() const {
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }
  PT_HD PT_INLINE void warp_sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
  // a lane's partner is itself: its value comes by shuffle
  PT_HD PT_INLINE int partner(int i, int) const { return i; }
  template <class V>
  PT_HD PT_INLINE V peer(V mine, V, int m,
                         unsigned mask = 0xffffffffu) const {
#ifdef __CUDA_ARCH__
    return __shfl_xor_sync(mask, mine, m);
#else
    return mine;
#endif
  }
  template <class Lane>
  PT_HD PT_INLINE uint32_t ballot(const Lane* x, int i, int q) const {
#ifdef __CUDA_ARCH__
    return __ballot_sync(0xffffffffu, (x[i].bits >> q) & 1u);
#else
    return (x[i].bits >> q) & 1u;
#endif
  }
  template <class Lane>
  PT_HD PT_INLINE bool all(const Lane* x) const {
#ifdef __CUDA_ARCH__
    return __syncthreads_and(x[0].ok) != 0;
#else
    return x[0].ok != 0;
#endif
  }
};

// the tiled form: the lattice between groups in shared memory, the
// interior levels in registers; held to the registers that let at least
// three CTAs of 128 threads share an SM
template <int kS, int kMode, bool kBf16>
__global__ void __launch_bounds__(BpTiles<kS>::kT,
                                  bp_tiled_ctas(BpTiles<kS>::kT))
    bp_kernel_tiled(BpArgs A) {
  extern __shared__ __align__(16) unsigned char smem[];
  BpTileLane<kS> lane;
  bp_tiled_column<kS, kMode, kBf16>(BpCta{}, A, blockIdx.x, smem, &lane);
}

// the global form: the lattice in the scratch, the check's words in shared
// memory
template <bool kBf16>
__global__ void __launch_bounds__(kBpMaxThreads, 1) bp_kernel(BpArgs A) {
  using T = typename BpMsg<kBf16>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  BpLane lane;
  bp_global_column<kBf16>(BpCta{}, A, blockIdx.x,
                          static_cast<T*>(A.lattice)
                              + blockIdx.x * bp_lattice_elems(A.S),
                          reinterpret_cast<uint32_t*>(smem), &lane);
}

using BpKernel = void (*)(BpArgs);

template <int kS, bool kBf16>
BpKernel tiled_of(int mode) {
  if (mode == kBpScaled) return bp_kernel_tiled<kS, kBpScaled, kBf16>;
  if (mode == kBpMinsum) return bp_kernel_tiled<kS, kBpMinsum, kBf16>;
  return bp_kernel_tiled<kS, kBpExact, kBf16>;
}

// the launch's kernel: the tiled instance of (S, mode) or the global form
template <bool kBf16>
BpKernel kernel_of(int S, bool shared, int mode) {
  if (!shared) return bp_kernel<kBf16>;
  switch (S) {
    case 1: return tiled_of<1, kBf16>(mode);
    case 2: return tiled_of<2, kBf16>(mode);
    case 3: return tiled_of<3, kBf16>(mode);
    case 4: return tiled_of<4, kBf16>(mode);
    case 5: return tiled_of<5, kBf16>(mode);
    case 6: return tiled_of<6, kBf16>(mode);
    case 7: return tiled_of<7, kBf16>(mode);
    case 8: return tiled_of<8, kBf16>(mode);
    case 9: return tiled_of<9, kBf16>(mode);
    case 10: return tiled_of<10, kBf16>(mode);
    case 11: return tiled_of<11, kBf16>(mode);
    default: return nullptr;
  }
}

BpKernel kernel_for(int S, bool shared, int bf16, int mode) {
  return bf16 ? kernel_of<true>(S, shared, mode)
              : kernel_of<false>(S, shared, mode);
}

}  // namespace polar_torch

// lattice == nullptr: the shared (tiled) form; else the global form in
// lattice, a [bs, 2 (S + 1) n] scratch of the message type (f32, or bf16
// with bf16 != 0). done and sweeps (each [bs] or nullptr) receive the
// convergence flag and the sweeps each codeword ran. Returns a cudaError_t.
extern "C" int bp_launch(const float* llr, long long llr_rs, long long llr_cs,
                         const float* prior, float* out, long long out_rs,
                         long long out_cs, int32_t* done, int32_t* sweeps,
                         void* lattice, int S, int bs, int num_iter,
                         int check_every, int early_stop, int exact,
                         int negate, float msf, float llr_max, int bf16,
                         void* stream) {
  using namespace polar_torch;
  BpArgs A{llr, llr_rs, llr_cs, prior, out, out_rs, out_cs, done, sweeps,
           lattice, S, bs, num_iter, check_every, early_stop, exact, negate,
           msf, llr_max};
  const bool shared = lattice == nullptr;
  if (S < 1 || S > 16 || (shared && S > kBpMaxSharedS))
    return (int)cudaErrorInvalidValue;
  const BpPlan p = bp_plan(S, shared, bf16 ? 2 : 4);
  BpKernel kernel = kernel_for(S, shared, bf16,
                               bf16 ? bp_mode<true>(A) : bp_mode<false>(A));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<bs, p.threads, (size_t)p.smem,
           static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

// the launch plan: threads, CTA barriers a sweep, dynamic shared memory
// bytes (of bf16 messages with bf16 != 0)
extern "C" void bp_plan_of(int S, int shared, int bf16, int* out) {
  using namespace polar_torch;
  const BpPlan p = bp_plan(S, shared != 0, bf16 ? 2 : 4);
  out[0] = p.threads;
  out[1] = p.syncs;
  out[2] = (int)p.smem;
}

// CTAs of the kernel that one SM holds at once (the occupancy API), for
// the form (shared != 0), message type (bf16 != 0) and mode (kBpScaled,
// kBpMinsum, kBpExact) of a launch at 2^S rows; -1 on error
extern "C" int bp_blocks_per_sm(int S, int shared, int bf16, int mode) {
  using namespace polar_torch;
  const BpPlan p = bp_plan(S, shared != 0, bf16 ? 2 : 4);
  BpKernel kernel = kernel_for(S, shared != 0, bf16, mode);
  if (kernel == nullptr
      || cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)p.smem) != cudaSuccess)
    return -1;
  int n = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, p.threads,
                                                    (size_t)p.smem)
      != cudaSuccess)
    return -1;
  return n;
}
