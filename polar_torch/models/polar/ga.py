"""Gaussian-approximation (GA) LLR means of a polar code's bit-channels.

The recursion runs in ``csrc/ga_host.cpp``, which ``_build`` compiles with
g++ at first use; a failed build raises. ``force_numpy=True`` runs the
NumPy twin of the same recursion, which the tests hold the library
against.
"""

import ctypes

import numpy as np

from polar_torch import _build


def _library():
    lib = _build.load("ga", "host")
    lib.ga_bit_channel_means.restype = ctypes.c_int
    lib.ga_bit_channel_means.argtypes = [
        ctypes.c_int64, ctypes.c_double, ctypes.POINTER(ctypes.c_double)]
    return lib


def _phi(m):
    m = np.asarray(m, dtype=np.float64)
    out = np.ones_like(m)
    small = (m > 0) & (m < 10.0)
    out[small] = np.exp(0.0218 - 0.4527 * np.power(m[small], 0.86))
    big = m >= 10.0
    mb = m[big]
    out[big] = np.sqrt(np.pi / mb) * np.exp(-mb / 4.0) * (1 - 10 / (7 * mb))
    return out


def _phi_inv(y):
    y = float(y)
    if y >= 1.0:
        return 0.0
    if y <= 0.0:
        return 1e9      # a saturated channel: the library's cap
    lo, hi = 0.0, 1.0
    while float(_phi(hi)) > y and hi < 1e9:
        hi *= 2.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if float(_phi(mid)) > y:
            lo = mid
        else:
            hi = mid
        if hi - lo < 1e-12 * (1.0 + hi):
            break
    return 0.5 * (lo + hi)


def _ga_means_numpy(n: int, m0: float) -> np.ndarray:
    means = np.empty(n, dtype=np.float64)
    means[0] = m0
    width = 1
    while width < n:
        for i in range(width - 1, -1, -1):
            m = means[i]
            pm = float(_phi(np.array(m)))
            means[2 * i] = _phi_inv(1.0 - (1.0 - pm) ** 2)
            means[2 * i + 1] = 2.0 * m
        width *= 2
    return means


def ga_bit_channel_means(n: int, m0: float,
                         force_numpy: bool = False) -> np.ndarray:
    """GA LLR means of the ``n`` bit-channels (u-domain order) for a
    channel LLR mean ``m0`` (``2 / No``), as float64."""
    n = int(n)
    if n < 1 or n & (n - 1):
        raise ValueError("n must be a power of 2")
    if force_numpy:
        return _ga_means_numpy(n, float(m0))
    out = np.empty(n, dtype=np.float64)
    rc = _library().ga_bit_channel_means(
        n, float(m0), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise RuntimeError(f"ga_bit_channel_means returned {rc}")
    return out
