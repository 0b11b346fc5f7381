"""The Arikan butterfly (polar transform) as ``log2(n)`` reshape-XOR stages.

Generator ``G = [[1,0],[1,1]]^{(x) s}`` acting as ``c = u G``. Stage ``s``
XORs, inside every block of ``2^(s+1)`` positions, the upper half into the
lower half. The transform is an involution over GF(2), which the decoders
use to recover ``u`` from a decoded codeword.
"""

import numpy as np
import torch


def polar_transform(x, axis=-1):
    """Polar transform of ``x`` along ``axis`` (length a power of 2).

    Integer tensors are XORed; floating tensors go through int8 and back."""
    axis = axis % x.dim()
    n = x.shape[axis]
    stages = n.bit_length() - 1
    if 1 << stages != n:
        raise ValueError(f"transform length {n} is not a power of 2")
    floating = x.is_floating_point()
    v = x.to(torch.int8) if floating else x
    v = v.movedim(axis, -1)
    lead = v.shape[:-1]
    for s in range(stages):
        span = 1 << s
        blk = v.reshape(lead + (n // (2 * span), 2, span))
        v = torch.stack([blk[..., 0, :] ^ blk[..., 1, :], blk[..., 1, :]],
                        dim=-2).reshape(lead + (n,))
    v = v.movedim(-1, axis)
    return v.to(x.dtype) if floating else v


def dense_generator(n: int) -> np.ndarray:
    """The dense generator ``G = [[1,0],[1,1]]^{(x) log2(n)}`` as a host
    int8 matrix (for parity checks and tests)."""
    stages = n.bit_length() - 1
    if n < 2 or 1 << stages != n:
        raise ValueError(f"n={n} is not a power of 2, at least 2")
    g = np.array([[1, 0], [1, 1]], dtype=np.int8)
    m = g
    for _ in range(stages - 1):
        m = np.kron(g, m)
    return m
