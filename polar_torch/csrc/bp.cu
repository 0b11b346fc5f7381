// Belief-propagation decoder kernel for Hopper (sm_90a).
//
// Replaces polar_tpu/models/polar/pallas_bp.py::_bp_kernel (pallas_bp.py:57,
// launched by bp_pallas / _bp_pallas_impl): the whole BP decode, num_iter
// sweeps of scaled min-sum or exact processing-element updates over the
// message lattice, with the G-matrix early stop every check_every sweeps
// and the optional convergence flag. The schedule and the arithmetic live in
// bp.cuh and are shared with the host build that the CPU tests run.
//
// What bounds it: operations. At n = 1024, bs = 8192 and 20 sweeps with no
// early stop, about 3.4e10 f32 operations (two check-node updates, two adds
// and two scalings per element and stage), 0.5 ms at 67 TFLOP/s; the bytes
// (llr in, out back, 64 MiB) take 0.02 ms. The first design (one thread per
// element of a stage, the whole 90,112-byte lattice in shared memory, a
// __syncthreads() after every stage: 2 S = 20 per sweep and S + 2 per
// check) ran at 13.5-15x that bound.
//
// Design: one CTA per codeword, as before; what changed is where the
// messages live, how often the CTA waits, and what an element costs.
// * Warp stages. Lane k of a warp owns rows 2k, 2k + 1 of each of its
//   64-row blocks, so stages 0..4 exchange by __shfl_xor_sync inside the
//   warp and need no CTA barrier. A lane and its partner split their two
//   elements, one each, so no lane idles on the other's branch (three
//   shuffles an element). The l and r messages of these stages stay in
//   the lane's registers across sweeps, and shared memory holds only
//   stages 5..S: 49,152 B at n = 1024 (was 90,112), 114,688 B at n = 2048.
//   A warp keeps one block (512 threads at n = 1024) or two (n = 2048),
//   run side by side.
// * CTA stages. Stages 5..S-1 run one at a time, a barrier after each: at
//   n = 1024 a sweep waits 10 times (was 20). A trial that ran them two at
//   a time (6 barriers a sweep) tied this with early stop, so the simpler
//   schedule stayed (PERF.md §6).
// * The check in bits. A warp's hard decisions are two ballots a block;
//   the XOR butterfly's stages 1..5 are shifts and masks of those words,
//   its upper stages XORs of words in warp 0, and one __syncthreads_and
//   hands the verdict to the CTA: 3 barriers a check at n = 1024 (was 12).
// * A cheaper min-sum (fg.cuh minsum: 5 instructions, the same bits as
//   the sign-product form).
// What the card showed (PERF.md §6): the first design was issue-bound more
// than barrier-bound (about 50 instructions an element, an estimate from
// the code; no profiler counted them), and so is this one. The lane split
// and the cheaper f paid the most; cutting barriers alone bought nothing.
// 512 threads a CTA, held to 64 registers so that two CTAs share an SM,
// beat 256 threads with two resident blocks a warp.
// From n = 4096 (or with the global form forced) the lattice sits in a
// global scratch that the wrapper allocates, 512 threads loop over the
// blocks, and the warp stages' messages go through the scratch around each
// use: the same schedule, without the register residency.
// The bf16 lattice (bp_launch(..., bf16 = 1)) is its own set of template
// instances (kBf16), so the f32 instances' code does not change: the same
// schedule and launch plan, 16-bit messages in shared memory and the
// scratch (24,832 B a CTA at n = 1024, 57,856 B at n = 2048), and a
// rounding to bf16 after every op (bp.cuh). It does the f32 form's
// operations plus the roundings; its bound is the f32 form's.
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
  PT_HD PT_INLINE float peer(float mine, float, int m) const {
#ifdef __CUDA_ARCH__
    return __shfl_xor_sync(0xffffffffu, mine, m);
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

// one resident block a warp at 512 threads: at most 64 registers, so that
// two CTAs share an SM
template <int kB, bool kRes, bool kBf16>
__global__ void __launch_bounds__(kBpMaxThreads, kB == 1 && kRes ? 2 : 1)
    bp_kernel(BpArgs A) {
  using T = typename BpMsg<kBf16>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  BpLane<kB> lane;
  T* lat;
  uint32_t* words;
  if (kRes) {
    lat = reinterpret_cast<T*>(smem);
    words = reinterpret_cast<uint32_t*>(smem + sizeof(T)
                                        * bp_shared_elems(A.S));
  } else {
    lat = static_cast<T*>(A.lattice) + blockIdx.x * bp_lattice_elems(A.S);
    words = reinterpret_cast<uint32_t*>(smem);
  }
  bp_column<kB, kRes, kBf16>(BpCta{}, A, blockIdx.x, lat, words, &lane);
}

template <int kB, bool kRes, bool kBf16>
int launch(const BpArgs& A, const BpPlan& p, cudaStream_t st) {
  const size_t smem = (size_t)bp_smem_bytes(
      A.S, kRes, sizeof(typename BpMsg<kBf16>::T));
  cudaError_t err = cudaFuncSetAttribute(
      bp_kernel<kB, kRes, kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  bp_kernel<kB, kRes, kBf16><<<A.bs, p.threads, smem, st>>>(A);
  return (int)cudaGetLastError();
}

template <bool kBf16>
int dispatch(const BpArgs& A, bool shared, cudaStream_t st) {
  const BpPlan p = bp_plan(A.S, shared);
  if (!shared) return launch<1, false, kBf16>(A, p, st);
  if (p.warp_blocks == 2) return launch<2, true, kBf16>(A, p, st);
  return launch<1, true, kBf16>(A, p, st);
}

template <bool kBf16>
void (*kernel_of(const BpPlan& p, bool shared))(BpArgs) {
  if (!shared) return bp_kernel<1, false, kBf16>;
  return p.warp_blocks == 2 ? bp_kernel<2, true, kBf16>
                            : bp_kernel<1, true, kBf16>;
}

}  // namespace polar_torch

// lattice == nullptr: the shared form; else the global form in lattice, a
// [bs, 2 (S + 1) n] scratch of the message type (f32, or bf16 with
// bf16 != 0). done and sweeps (each [bs] or nullptr) receive the
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool shared = lattice == nullptr;
  if (S < 1 || S > 16 || (shared && S > kBpMaxSharedS))
    return (int)cudaErrorInvalidValue;
  return bf16 ? dispatch<true>(A, shared, st) : dispatch<false>(A, shared, st);
}

// CTAs of the kernel that one SM holds at once (the occupancy API), for
// the form (shared != 0) and message type (bf16 != 0) of a launch at 2^S
// rows; -1 on error
extern "C" int bp_blocks_per_sm(int S, int shared, int bf16) {
  using namespace polar_torch;
  const BpPlan p = bp_plan(S, shared != 0);
  const size_t smem = (size_t)bp_smem_bytes(S, shared != 0, bf16 ? 2 : 4);
  void (*kernel)(BpArgs) = bf16 ? kernel_of<true>(p, shared != 0)
                                : kernel_of<false>(p, shared != 0);
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  int n = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, p.threads,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}
