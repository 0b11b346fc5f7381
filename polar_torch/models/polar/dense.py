"""The dense-G encode and decode chain of a polar code over any kernel.

The encoder puts the info bits at the non-frozen positions and computes
``c = u G mod 2`` with ``G = kern^{(x) s}``, as one f32 matrix product
(exact: 0/1 inputs, sums below 2^24). SC and SCL work on F2 only, so a
code over any other kernel is decoded by ordered-statistics decoding
(``models/osd.py``), which works for any linear code; the info bits then
come back as ``u = c_hat G^-1 mod 2``, with ``G^-1`` the Kronecker power
of the inverted base kernel (``(A (x) B)^-1 = A^-1 (x) B^-1`` over GF(2)).
"""

import numpy as np
import torch

from polar_torch.models.osd import OSDecoder
from polar_torch.models.polar.construction import ARIKAN_F2, gen_arikan
from polar_torch.models.polar.encode import PolarEncoder
from polar_torch.utils.numerics import int_mod_2


def gf2_inv(m) -> np.ndarray:
    """GF(2) inverse of a square 0/1 matrix (host elimination); a singular
    matrix raises ``ValueError``."""
    m = (np.asarray(m, dtype=np.int64) & 1).copy()
    n = m.shape[0]
    if m.shape != (n, n):
        raise ValueError(f"matrix of shape {m.shape} is not square")
    aug = np.concatenate([m, np.eye(n, dtype=np.int64)], axis=1)
    for c in range(n):
        piv = np.nonzero(aug[c:, c])[0]
        if piv.size == 0:
            raise ValueError("kernel matrix is singular over GF(2)")
        p = c + int(piv[0])
        if p != c:
            aug[[c, p]] = aug[[p, c]]
        rows = np.nonzero(aug[:, c])[0]
        rows = rows[rows != c]
        if rows.size:
            aug[rows] ^= aug[c]
    return aug[:, n:]


def _stages(n: int, base: int) -> int:
    stages = int(round(np.log(n) / np.log(base)))
    if base ** stages != n:
        raise ValueError(f"n={n} is not a power of the kernel size {base}")
    return stages


class DenseKernelEncoder(PolarEncoder):
    """``__call__(u[..., k]) -> c[..., n]`` for the code of ``frozen_pos``
    over the kernel ``kern``: info bits at the non-frozen positions (frozen
    positions 0), then ``c = u G mod 2``."""

    def __init__(self, frozen_pos, n: int, kern=ARIKAN_F2,
                 dtype=torch.float32, device=None):
        kern = np.asarray(kern, dtype=np.int64) & 1
        stages = _stages(int(n), kern.shape[0])
        super().__init__(frozen_pos, n, dtype=dtype, device=device)
        self.kern = kern
        self._g = torch.from_numpy(gen_arikan(kern, stages).astype(
            np.float32)).to(self.device)
        # (A (x) B)^-1 = A^-1 (x) B^-1: only the base kernel is inverted
        self._g_inv = torch.from_numpy(gen_arikan(
            gf2_inv(kern), stages).astype(np.float32)).to(self.device)

    def __call__(self, u):
        if u.shape[-1] != self.k:
            raise ValueError(f"last dim must be of length k={self.k}")
        c = self.scatter_info(u).to(torch.float32)
        return int_mod_2(torch.matmul(c, self._g)).to(self.dtype)

    def transmit_table(self):
        """None: the dense generator is no polar transform."""
        return None

    def info_bits(self, c):
        """``u = c G^-1 mod 2`` of codewords ``c[..., n]`` (f32, all n
        positions)."""
        return int_mod_2(torch.matmul(c.to(torch.float32), self._g_inv))

    def parity_check(self, c):
        """True where ``c[..., n]`` is a codeword of this code: ``c G^-1``
        is 0 at every frozen position."""
        frozen = torch.from_numpy(self.frozen_pos).to(c.device)
        return ~self.info_bits(c)[..., frozen].bool().any(dim=-1)


class DenseKernelDecoder:
    """``__call__(llr_logits[..., n]) -> u_hat[..., k]`` for a
    ``DenseKernelEncoder`` code: order-``t`` OSD on the encoder's device,
    then ``u = c_hat G^-1 mod 2`` at the info positions. ``osd_kwargs``
    go to ``OSDecoder`` (``llr_max``, ``pattern_chunk``)."""

    def __init__(self, encoder: DenseKernelEncoder, t: int = 2,
                 **osd_kwargs):
        self._enc = encoder
        self._osd = OSDecoder(t=t, encoder=encoder, **osd_kwargs)
        self.t = int(t)
        self.device = self._osd.device
        self._info_idx = torch.from_numpy(encoder.info_pos).to(self.device)

    @property
    def k(self):
        return self._enc.k

    @property
    def n(self):
        return self._enc.n

    def __call__(self, llr):
        return self._enc.info_bits(self._osd(llr))[..., self._info_idx]
