// Host build of the QPSK transmitter's routines (qpsk_front.cuh), compiled
// with g++ and no CUDA or torch headers. One thread runs every tile in
// turn and stands in for the warp: each of the 32 lanes' words is built
// from the bits that lanes would give the ballot, the stages between lanes
// read the partner lane's word as the shuffle does, and each lane emits the
// chunks the card's lane emits. The CPU tests hold it against the composed
// PyTorch chain, which checks the CUDA kernel's logic where no card exists.
// The main path never uses it.
//
// Build: g++ -std=c++17 -O2 -shared -fPIC -o libqpsk_front_host.so
//        qpsk_front_host.cpp
#include "qpsk_front.cuh"

// arguments as qpsk_front_launch's in qpsk_front.cu, without the stream;
// returns 0, or 1 for an input it does not take
extern "C" int qpsk_front_host(const float* u, const int16_t* table,
                               const float* xr, const float* xi, float* cw,
                               float* llr, long long bs, int k, int m,
                               float a, float s2, float sqrt_no,
                               float scale) {
  using namespace polar_torch;
  if (bs < 0 || k < 0) return 1;
  const QfScalars s{a, s2, sqrt_no, scale};
  return qf_dispatch(m, [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    constexpr int K = qf_slots(M), V = qf_chunk(M), per = qf_per(M);
    const long long n_bits = bs << M;
    const long long tiles =
        (bs + qf_tile_codewords(M) - 1) / qf_tile_codewords(M);
    for (long long t = 0; t < tiles; ++t) {
      uint32_t word[32][K];
      for (int slot = 0; slot < K; ++slot)
        for (int j = 0; j < 32; ++j) {
          uint32_t got = 0;
          for (int lane = 0; lane < 32; ++lane)
            got |= qf_info_bit<M>(u, table, bs, k, t, 32 * slot + j, lane)
                   << lane;
          word[j][slot] = bfly_word_stages(got, per);
        }
      for (int lane = 0; lane < 32; ++lane) bfly_words_stages<K>(word[lane]);
      for (int d = 1; d < qf_lanes(M); d <<= 1)
        for (int slot = 0; slot < K; ++slot)
          for (int lane = 0; lane + d < 32; ++lane)
            if (!(lane & d)) word[lane][slot] ^= word[lane + d][slot];
      const long long base = t * (32LL * K * per);
      for (int slot = 0; slot < K; ++slot)
        for (int h = 0; h < per / V; ++h)
          for (int lane = 0; lane < 32; ++lane) {
            const int o = qf_chunk_offset(h, lane, V);
            const uint32_t w = word[o / per][slot];
            const long long f = base + 32LL * slot * per + o;
            if (f < n_bits)
              qf_emit<V>(w >> (o % per) & ((1u << V) - 1u), f, xr, xi, cw,
                         llr, s);
          }
    }
    return 0;
  });
}
