// Host build of the polar transform's per-slice routines (butterfly.cuh),
// compiled with g++ and no CUDA or torch headers. One thread runs every
// column of every block in turn, its slices one after another, then the
// stages across them. The CPU tests hold it against the plain PyTorch
// version, which checks the CUDA kernel's logic where no card exists. The
// main path never uses it.
//
// Build: g++ -std=c++17 -O2 -shared -fPIC -o libbutterfly_host.so
//        butterfly_host.cpp
#include <vector>

#include "butterfly.cuh"

// arguments as butterfly_rows_launch's in butterfly.cu, without the stream;
// returns 0, or 1 for an input it does not take
extern "C" int butterfly_rows_host(const void* x, int in_bytes,
                                   long long x_block_stride,
                                   long long x_row_stride, int8_t* u, int m,
                                   int b, long long C) {
  using namespace polar_torch;
  if (m < 0 || C < 0) return 1;
  return bfly_dispatch(in_bytes, b, [&](auto t, auto k) {
    using T = decltype(t);
    constexpr int K = decltype(k)::value;
    const int R = bfly_slice_rows(b), Q = bfly_slices(b);
    const T* xt = static_cast<const T*>(x);
    std::vector<uint32_t> before((size_t)Q * K);
    for (long long j = 0; j < m; ++j)
      for (long long c = 0; c < C; ++c) {
        for (int q = 0; q < Q; ++q) {
          uint32_t word[K];
          bfly_slice<T, K>(xt + j * x_block_stride
                               + (long long)q * R * x_row_stride + c,
                           x_row_stride, R, word);
          for (int i = 0; i < K; ++i) before[(size_t)q * K + i] = word[i];
        }
        for (int q = 0; q < Q; ++q) {
          uint32_t word[K];
          for (int i = 0; i < K; ++i) word[i] = before[(size_t)q * K + i];
          bfly_across<K>(q, Q, before.data(), K, 1, word);
          bfly_store_slice<K>(word, R,
                              u + (j << b) * C + (long long)q * R * C + c, C);
        }
      }
    return 0;
  });
}
