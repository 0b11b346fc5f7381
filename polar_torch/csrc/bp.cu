// Belief-propagation decoder kernel for Hopper (sm_90a).
//
// Replaces polar_tpu/models/polar/pallas_bp.py::_bp_kernel (pallas_bp.py:57,
// launched by bp_pallas / _bp_pallas_impl): the whole BP decode, num_iter
// sweeps of scaled min-sum or exact processing-element updates over the
// message lattice, with the G-matrix early stop every check_every sweeps
// and the optional convergence flag. The schedule and the arithmetic live in
// bp.cuh and are shared with the host build that the CPU tests run.
//
// Design: one CTA per codeword. The TPU kernel holds a whole batch tile's
// lattice in VMEM and runs every chunk for every lane; here a codeword's
// lattice, 2 (S + 1) n floats (90,112 B at n = 1024, 196,608 B at n = 2048),
// sits in dynamic shared memory, and the CTA's threads loop over the n/2
// butterflies of a stage with a barrier between stages. A codeword stops at
// its first passing check; the flag is uniform in the CTA, so the exit does
// not diverge. From n = 4096 the lattice does not fit the 232,448-byte
// opt-in limit, and the same kernel keeps it in a global scratch that the
// wrapper allocates (kShared = false); the check's n bytes of bits stay in
// shared memory in both forms.
//
// What bounds it: operations. At n = 1024, bs = 8192 and 20 sweeps with no
// early stop, about 3.4e10 f32 operations (two check-node updates, two adds
// and two scalings per butterfly and stage), 0.5 ms at 67 TFLOP/s; the
// bytes (llr in, out back, 64 MiB) take 0.02 ms. Each stage is a few dozen
// instructions per thread between two barriers, so the barriers and the
// shared-memory latency, not the ALUs, set the pace of this first design.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbp.so bp.cu
#include <cuda_runtime.h>

#include "bp.cuh"

namespace polar_torch {

constexpr int kBpMaxThreads = 512;

template <bool kShared>
__global__ void __launch_bounds__(kBpMaxThreads) bp_kernel(BpArgs A) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long lat_elems = bp_lattice_elems(A.S);
  float* lat;
  uint8_t* bits;
  if (kShared) {
    lat = reinterpret_cast<float*>(smem);
    bits = smem + lat_elems * sizeof(float);
  } else {
    lat = A.lattice + blockIdx.x * lat_elems;
    bits = smem;
  }
  bp_column(CtaTeam{}, A, blockIdx.x, lat, bits);
}

}  // namespace polar_torch

// lattice == nullptr: the lattice in shared memory; else in lattice, a
// [bs, 2 (S + 1) n] f32 scratch. Returns a cudaError_t.
extern "C" int bp_launch(const float* llr, long long llr_rs, long long llr_cs,
                         const float* prior, float* out, long long out_rs,
                         long long out_cs, int32_t* done, float* lattice,
                         int S, int bs, int num_iter, int check_every,
                         int early_stop, int exact, int negate, float msf,
                         float llr_max, void* stream) {
  using namespace polar_torch;
  BpArgs A{llr, llr_rs, llr_cs, prior, out, out_rs, out_cs, done, lattice,
           S, bs, num_iter, check_every, early_stop, exact, negate, msf,
           llr_max};
  const int n = 1 << S;
  int threads = n / 2;
  if (threads < 32) threads = 32;
  if (threads > kBpMaxThreads) threads = kBpMaxThreads;
  const size_t bits_bytes = (size_t)n;
  const size_t smem = lattice == nullptr
      ? bp_lattice_elems(S) * sizeof(float) + bits_bytes : bits_bytes;
  auto kernel = lattice == nullptr ? bp_kernel<true> : bp_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<bs, threads, smem, static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}
