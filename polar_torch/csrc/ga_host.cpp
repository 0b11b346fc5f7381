// Density-evolution / Gaussian-approximation polar code construction.
//
// Native host-side runtime component (the reference has no construction
// beyond its RM row-weight sort and the 5G table; GA is the standard
// analytic construction for AWGN-matched frozen sets — Trifonov, "Efficient
// design and decoding of polar codes", IEEE Trans. Comm. 2012).
//
// The recursion tracks the mean of the (Gaussian-approximated) LLR of every
// synthetic bit-channel through the log2(n) polarization stages:
//
//     minus (check) branch:  m' = phi_inv(1 - (1 - phi(m))^2)
//     plus (variable) branch: m' = 2 m
//
// with phi(m) ~= E[tanh(L/2)] under L ~ N(m, 2m) via the two-piece
// approximation of Chung et al. (2001). Exported C ABI so Python loads it
// with ctypes: polar_torch/_build.py compiles this file at first use with
// g++ into build/polar_torch/, and polar_torch/models/polar/ga.py loads it
// (it keeps a NumPy twin of the same recursion for the tests).

#include <cmath>
#include <cstdint>

namespace {

// phi(m) = 1 - E[tanh(L/2)], L ~ N(m, 2m)  (Chung et al. approximation)
double phi(double m) {
    if (m <= 0.0) return 1.0;
    if (m < 10.0) return std::exp(0.0218 - 0.4527 * std::pow(m, 0.86));
    // asymptotic tail
    return std::sqrt(M_PI / m) * std::exp(-m / 4.0) * (1.0 - 10.0 / (7.0 * m));
}

// inverse of phi by bisection (phi is strictly decreasing on (0, inf))
double phi_inv(double y) {
    if (y >= 1.0) return 0.0;
    if (y <= 0.0) return 1e9;
    double lo = 0.0, hi = 1.0;
    while (phi(hi) > y && hi < 1e9) hi *= 2.0;
    for (int it = 0; it < 200; ++it) {
        double mid = 0.5 * (lo + hi);
        if (phi(mid) > y) lo = mid; else hi = mid;
        if (hi - lo < 1e-12 * (1.0 + hi)) break;
    }
    return 0.5 * (lo + hi);
}

}  // namespace

extern "C" {

// Per-bit-channel LLR means, u-domain (natural bit order), for an n-length
// polar code over BPSK/QPSK-per-dim AWGN with channel LLR mean m0 = 2/No.
// means must hold n doubles. Returns 0 on success.
int ga_bit_channel_means(int64_t n, double m0, double* means) {
    if (n < 1 || (n & (n - 1)) != 0) return 1;
    means[0] = m0;
    for (int64_t width = 1; width < n; width *= 2) {
        // transform in place, from the back so stage inputs survive
        for (int64_t i = width - 1; i >= 0; --i) {
            double m = means[i];
            double pm = phi(m);
            means[2 * i] = phi_inv(1.0 - (1.0 - pm) * (1.0 - pm));
            means[2 * i + 1] = 2.0 * m;
        }
    }
    return 0;
}

}  // extern "C"
