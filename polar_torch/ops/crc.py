"""CRC attach and check of 3GPP TS 38.212 Sec. 5.1 (CRC24A/B/C, CRC16, CRC11,
CRC6) through dense generator matrices.

The parity of a word is one GF(2) product: a 0/1 float32 matmul against a
[k, L] generator matrix, then mod 2. Sums stay below 2^24, so the product
is exact in float32 on either device. The matrix is built on the host in
O(k) shift-register steps and kept once per device it is used on.
"""

import numpy as np
import torch

from polar_torch.utils.numerics import int_mod_2

# polynomial coefficients (exponents with coefficient 1), TS 38.212 Sec. 5.1
CRC_POLYNOMIALS = {
    "CRC24A": [24, 23, 18, 17, 14, 11, 10, 7, 6, 5, 4, 3, 1, 0],
    "CRC24B": [24, 23, 6, 5, 1, 0],
    "CRC24C": [24, 23, 21, 20, 17, 15, 13, 12, 8, 4, 2, 1, 0],
    "CRC16": [16, 12, 5, 0],
    "CRC11": [11, 10, 9, 5, 0],
    "CRC6": [6, 5, 0],
}


def crc_polynomial(crc_degree: str):
    """MSB-first binary coefficient vector of length ``L+1``, and ``L``."""
    if crc_degree not in CRC_POLYNOMIALS:
        raise ValueError(f"Invalid CRC polynomial {crc_degree!r}")
    exps = CRC_POLYNOMIALS[crc_degree]
    length = max(exps)
    bits = np.zeros(length + 1, dtype=np.int64)
    for e in exps:
        bits[length - e] = 1  # MSB (x^L) first
    return bits, length


def crc_generator_matrix(k: int, crc_degree: str) -> np.ndarray:
    """``[k, L]`` parity-generator matrix: row i is the CRC parity of unit
    vector i. With ``g(x) = x^L + g_low(x)``: ``r_{k-1} = g_low`` and
    ``r_{i-1} = x * r_i mod g``."""
    poly, L = crc_polynomial(crc_degree)
    g_low = poly[1:]  # coefficients below x^L, MSB first
    gmat = np.zeros((k, L), dtype=np.int64)
    r = g_low.copy()
    for i in range(k - 1, -1, -1):
        gmat[i] = r
        msb = r[0]
        r = np.concatenate([r[1:], [0]])
        if msb:
            r = np.bitwise_xor(r, g_low)
    return gmat


class _Parity:
    """``bits[..., k] -> parity[..., L]`` (float32, 0/1) through a generator
    matrix that is copied to each device once."""

    def __init__(self, gmat: np.ndarray):
        self._np = gmat.astype(np.float32)
        self._on = {}

    def __call__(self, x):
        mat = self._on.get(x.device)
        if mat is None:
            mat = self._on[x.device] = torch.from_numpy(self._np).to(x.device)
        return int_mod_2(torch.matmul(x, mat))


class CRCEncoder:
    """Appends CRC parity bits: ``[..., k] -> [..., k + crc_length]``."""

    def __init__(self, crc_degree: str, k: int, dtype=torch.float32):
        self.crc_degree = crc_degree
        self.dtype = dtype
        _, self.crc_length = crc_polynomial(crc_degree)
        self.k = int(k)
        self.n = self.k + self.crc_length
        self._parity = _Parity(crc_generator_matrix(self.k, crc_degree))

    @property
    def crc_pol(self):
        return crc_polynomial(self.crc_degree)[0]

    def __call__(self, bits):
        if bits.shape[-1] != self.k:
            raise ValueError(f"last dim must equal k={self.k}")
        x = bits.to(torch.float32)
        return torch.cat([x, self._parity(x)], dim=-1).to(self.dtype)


class CRCDecoder:
    """Checks and strips the CRC: ``bits[..., k + L] -> (info[..., k],
    crc_valid[..., 1] bool)``. The check takes the parity of the whole word
    and tests it for zero: ``parity(w) = w(x) x^L mod g(x)`` and ``x^L`` is
    invertible mod ``g`` (every 5G CRC polynomial has a +1 term)."""

    def __init__(self, crc_encoder: CRCEncoder):
        if not isinstance(crc_encoder, CRCEncoder):
            raise TypeError("CRCDecoder takes a CRCEncoder")
        self._encoder = crc_encoder
        self.crc_length = crc_encoder.crc_length
        self._parity = _Parity(crc_generator_matrix(
            crc_encoder.n, crc_encoder.crc_degree))

    def __call__(self, bits):
        if bits.shape[-1] != self._encoder.n:
            raise ValueError(
                "CRCDecoder input length must equal encoder.k + crc_length "
                f"({self._encoder.n}), the whole info+parity word")
        parity = self._parity(bits.to(torch.float32))
        crc_valid = parity.sum(dim=-1, keepdim=True) == 0
        return bits[..., :-self.crc_length], crc_valid
