// The closing polar transform of the SCL sweep for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this butterfly to XLA
// (polar_tpu/models/polar/scan_core.py, polar_transform after the sweep).
// It is added because the port's torch butterfly (ops/butterfly.py: per
// stage an XOR and a torch.stack of two strided halves, each stage copying
// the whole int8 array again) ran at about 30x its bound on the main path:
// 2.83 ms a batch of 8192 at n = 1024, L = 8 on an H100, against 0.100 ms.
//
// What bounds it: bytes. Each element of x is read once and each decision
// written once, 5 bytes an element from int32 input (the SCL kernel's cw),
// 2 from int8; between them a few integer operations for every 32.
// At [1, 1024, 8 * 8192] int32 that is 335 MB, 0.100 ms at 3.35 TB/s.
//
// Design: one thread a slice of 128 rows of one column (butterfly.cuh),
// so a warp's threads read neighbouring elements of a row (128 bytes of
// int32 from 32 columns) and write neighbouring bytes. The slice's bits
// are packed 32 rows to a word in registers and its butterfly runs on the
// 4 words; each thread's loads are independent and unrolled, so many are
// in flight. A column of w > 128 rows takes w / 128 threads of one block
// (threadIdx.y), which trade their words once through shared memory for
// the stages across slices. The slice's rows were chosen on the card
// (H100, [1, 1024, 65536] and [1, 256, 524288] int32): a thread per whole
// column (32 words at w = 1024) kept too few loads in flight (0.33 ms, 31%
// of the bound); slices of 256, 128 and 64 rows took 0.165, 0.139 and
// 0.153 ms, and 0.326, 0.275 and 0.289 ms.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbutterfly.so butterfly.cu
#include <cuda_runtime.h>

#include "butterfly.cuh"

namespace polar_torch {

template <typename T, int K>
__global__ void __launch_bounds__(512)
    butterfly_rows_kernel(const T* __restrict__ x, long long x_block_stride,
                          long long x_row_stride, int8_t* __restrict__ u,
                          long long C, int b) {
  extern __shared__ uint32_t slice_words[];   // [Q][K][columns], Q > 1
  const int R = bfly_slice_rows(b), Q = bfly_slices(b);
  const int cols = blockDim.x, q = threadIdx.y;
  const long long c = (long long)blockIdx.x * cols + threadIdx.x;
  const long long j = blockIdx.y;
  const bool live = c < C;
  uint32_t word[K] = {};
  if (live)
    bfly_slice<T, K>(x + j * x_block_stride + (long long)q * R * x_row_stride
                         + c,
                     x_row_stride, R, word);
  if (Q > 1) {
    uint32_t* column = slice_words + threadIdx.x;
#pragma unroll
    for (int k = 0; k < K; ++k) column[(q * K + k) * cols] = word[k];
    __syncthreads();
    bfly_across<K>(q, Q, column, K * cols, cols, word);
  }
  if (live)
    bfly_store_slice<K>(word, R, u + (j << b) * C + (long long)q * R * C + c,
                        C);
}

}  // namespace polar_torch

// x: [m, 2^b, C] with element size in_bytes (4: int32, 1: int8), block and
// row strides in elements and unit stride along C; u: [m, 2^b, C] int8,
// contiguous. Launches on stream; returns a cudaError_t.
extern "C" int butterfly_rows_launch(const void* x, int in_bytes,
                                     long long x_block_stride,
                                     long long x_row_stride, int8_t* u,
                                     int m, int b, long long C,
                                     void* stream) {
  using namespace polar_torch;
  if (m < 0 || m > 65535 || C < 0) return (int)cudaErrorInvalidValue;
  if (m == 0 || C == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bfly_dispatch(in_bytes, b, [&](auto t, auto k) {
    using T = decltype(t);
    constexpr int K = decltype(k)::value;
    const int Q = bfly_slices(b), cols = bfly_block_columns(Q);
    const dim3 grid((unsigned)((C + cols - 1) / cols), m);
    const size_t smem = Q > 1 ? sizeof(uint32_t) * Q * K * cols : 0;
    butterfly_rows_kernel<T, K><<<grid, dim3(cols, Q), smem, st>>>(
        static_cast<const T*>(x), x_block_stride, x_row_stride, u, C, b);
    return (int)cudaGetLastError();
  });
}
