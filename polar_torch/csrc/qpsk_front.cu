// The plain polar transmitter (info-bit scatter, Arikan transform, Gray
// QPSK map, AWGN, exact demap) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs this front end as one jitted
// XLA program (polar_tpu/models/systems.py), which XLA fuses. It is added
// because the port ran it as some 45 eager torch ops over the batch (a cat,
// a gather, ten XOR-and-stack stages over int8, int64 labels, a complex
// gather, the noise's complex multiply-add, the demapper's stack): 7.4 ms a
// batch of 65536 codewords at n = 1024, k = 512 on an H100, against a bound
// of 0.28 ms.
//
// What bounds it: bytes. After torch's draws it reads the f32 info bits and
// the two noise draws once and writes the f32 codewords and LLRs once:
// 4 k + 12 n bytes a codeword, 939.5 MB at (65536, 1024, 512), 0.2805 ms at
// 3.35 TB/s. The transform is some 40 integer operations a codeword.
//
// Design (qpsk_front.cuh): one warp a tile of 32 words, a codeword of
// n = 1024 in one warp, lane l holding positions 32 l .. 32 l + 31 as one
// word. The block's threads copy the gather table into shared memory once;
// the warp builds each lane's word with one __ballot_sync a word over the
// table-gathered bits (lane i reads position 32 q + i, so a ballot's loads
// are neighbouring elements of the codeword's row of u). The transform runs
// inside the words, across a lane's slots and across lanes by
// __shfl_down_sync; the codeword never leaves the registers. Then each
// lane takes 4 neighbouring bits at a time (its word by __shfl_sync), reads
// the two symbols' draws as float2 and writes 4 codeword floats and 4 LLRs
// as float4, so each access of the warp covers neighbouring bytes; the
// draws are read and the outputs written once, streamed (evict first).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libqpsk_front.so qpsk_front.cu
#include <cuda_runtime.h>

#include "qpsk_front.cuh"

namespace polar_torch {

constexpr int kQfWarps = 8;             // warps a block
constexpr int kQfMaxBlocks = 2048;      // the grid's cap; warps loop tiles
constexpr unsigned kQfFull = 0xffffffffu;

template <int M>
__global__ void __launch_bounds__(32 * kQfWarps)
    qpsk_front_kernel(const float* __restrict__ u,
                      const int16_t* __restrict__ table_g,
                      const float* __restrict__ xr,
                      const float* __restrict__ xi, float* __restrict__ cw,
                      float* __restrict__ llr, long long bs, int k,
                      QfScalars s) {
  constexpr int K = qf_slots(M), V = qf_chunk(M), per = qf_per(M);
  __shared__ int16_t table[1 << M];
  for (int p = threadIdx.x; p < 1 << M; p += blockDim.x) table[p] = table_g[p];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long n_bits = bs << M;
  const long long tiles =
      (bs + qf_tile_codewords(M) - 1) / qf_tile_codewords(M);
  for (long long t = (long long)blockIdx.x * kQfWarps + (threadIdx.x >> 5);
       t < tiles; t += (long long)gridDim.x * kQfWarps) {
    uint32_t word[K];
#pragma unroll
    for (int slot = 0; slot < K; ++slot) {
      uint32_t mine = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const uint32_t got = __ballot_sync(
            kQfFull, qf_info_bit<M>(u, table, bs, k, t, 32 * slot + j, lane));
        if (j == lane) mine = got;
      }
      word[slot] = bfly_word_stages(mine, per);
    }
    bfly_words_stages<K>(word);
#pragma unroll
    for (int d = 1; d < qf_lanes(M); d <<= 1) {
#pragma unroll
      for (int slot = 0; slot < K; ++slot) {
        const uint32_t above = __shfl_down_sync(kQfFull, word[slot], d);
        if (!(lane & d)) word[slot] ^= above;
      }
    }
    const long long base = t * (32LL * K * per);
#pragma unroll
    for (int slot = 0; slot < K; ++slot) {
#pragma unroll
      for (int h = 0; h < per / V; ++h) {
        const int o = qf_chunk_offset(h, lane, V);
        const uint32_t w = __shfl_sync(kQfFull, word[slot], o / per);
        const long long f = base + 32LL * slot * per + o;
        if (f < n_bits)
          qf_emit<V>(w >> (o % per) & ((1u << V) - 1u), f, xr, xi, cw, llr,
                     s);
      }
    }
  }
}

}  // namespace polar_torch

// u [bs, k], xr and xi [bs, 2^(m-1)], cw and llr [bs, 2^m], all f32 and
// contiguous, the draws and outputs 16-byte aligned; table [2^m] int16.
// Launches on stream; returns a cudaError_t.
extern "C" int qpsk_front_launch(const float* u, const int16_t* table,
                                 const float* xr, const float* xi, float* cw,
                                 float* llr, long long bs, int k, int m,
                                 float a, float s2, float sqrt_no,
                                 float scale, void* stream) {
  using namespace polar_torch;
  if (bs < 0 || k < 0) return (int)cudaErrorInvalidValue;
  if (bs == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const QfScalars s{a, s2, sqrt_no, scale};
  return qf_dispatch(m, [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    const long long tiles =
        (bs + qf_tile_codewords(M) - 1) / qf_tile_codewords(M);
    const long long want = (tiles + kQfWarps - 1) / kQfWarps;
    const unsigned blocks =
        (unsigned)(want < kQfMaxBlocks ? want : kQfMaxBlocks);
    qpsk_front_kernel<M><<<blocks, 32 * kQfWarps, 0, st>>>(
        u, table, xr, xi, cw, llr, bs, k, s);
    return (int)cudaGetLastError();
  });
}
