"""Gray-labelled QAM constellation, mapper and exact (or max-log) LLR
demapper. Constellation tables and the per-bit index sets are built with
NumPy at construction; the run-time path is a gather plus reductions.

LLRs use the logit convention: positive means bit 1.
"""

import numpy as np
import torch

from polar_torch._device import resolve_device
from polar_torch.utils import tracing


def pam_gray(b: np.ndarray):
    """Gray-labelled PAM point in {+-1, +-3, ...} of the bit vector ``b``."""
    if len(b) > 1:
        return (1 - 2 * b[0]) * (2 ** len(b[1:]) - pam_gray(b[1:]))
    return 1 - 2 * b[0]


def qam(n_bits_per_sym: int, normalize: bool = True) -> np.ndarray:
    """Gray-labelled M-QAM points (complex64). Point ``i`` has bit label
    ``binary_repr(i)``; even bits map the real axis, odd bits the
    imaginary axis."""
    if n_bits_per_sym % 2 or n_bits_per_sym <= 0:
        raise ValueError("n_bits_per_sym must be a positive multiple of 2")
    m = 2 ** n_bits_per_sym
    c = np.zeros(m, dtype=np.complex64)
    for i in range(m):
        b = np.array(list(np.binary_repr(i, n_bits_per_sym)), dtype=np.int16)
        c[i] = pam_gray(b[0::2]) + 1j * pam_gray(b[1::2])
    if normalize:
        n = n_bits_per_sym // 2
        qam_var = 1 / (2 ** (n - 2)) * np.sum(
            np.linspace(1, 2 ** n - 1, 2 ** (n - 1)) ** 2)
        c /= np.sqrt(qam_var)
    return c


class Constellation:
    """A (by default unit-power) QAM constellation on ``device``; calling it
    returns its points."""

    def __init__(self, n_bits_per_sym: int, normalize: bool = True,
                 device=None):
        self.n_bits_per_sym = int(n_bits_per_sym)
        self.normalize = normalize
        self.device = resolve_device(device)
        pts = qam(self.n_bits_per_sym, normalize=normalize)
        if normalize:
            pts = pts / np.sqrt(np.mean(np.abs(pts) ** 2))
        self.points_np = pts.astype(np.complex64)
        self.points = torch.from_numpy(self.points_np).to(self.device)

    def __call__(self):
        return self.points

    def show(self, labels: bool = True, figsize=(7, 7)):
        """Scatter plot of the points, each labelled with its bits
        (host-side; needs matplotlib). Returns the figure."""
        import matplotlib.pyplot as plt

        pts = self.points_np
        maxval = np.max(np.abs(pts)) * 1.05
        fig = plt.figure(figsize=figsize)
        ax = fig.add_subplot(111)
        ax.set_xlim(-maxval, maxval)
        ax.set_ylim(-maxval, maxval)
        ax.scatter(np.real(pts), np.imag(pts))
        ax.set_aspect("equal", adjustable="box")
        ax.set_xlabel("Real Part")
        ax.set_ylabel("Imaginary Part")
        ax.grid(True, which="both", axis="both")
        ax.set_title("Constellation Plot")
        if labels:
            for j, p in enumerate(pts):
                ax.annotate(np.binary_repr(j, self.n_bits_per_sym),
                            (np.real(p), np.imag(p)))
        return fig


# the reference-compatible name
QamConstell = Constellation


class Mapper:
    """Bits ``[..., n]`` to symbols ``[..., n / n_bits_per_sym]``; with
    ``return_indices`` also each symbol's point index (int64)."""

    def __init__(self, constell: Constellation,
                 return_indices: bool = False):
        self.constell = constell
        self.return_indices = bool(return_indices)
        m = constell.n_bits_per_sym
        self._binary_base = torch.tensor(
            [2 ** i for i in range(m - 1, -1, -1)], dtype=torch.int64,
            device=constell.device)

    def __call__(self, bits):
        m = self.constell.n_bits_per_sym
        if bits.shape[-1] % m:
            raise ValueError("last dim must be a multiple of n_bits_per_sym")
        groups = bits.reshape(bits.shape[:-1] + (bits.shape[-1] // m, m))
        idx = (groups.to(torch.int64) * self._binary_base).sum(dim=-1)
        x = self.constell.points[idx]
        return (x, idx) if self.return_indices else x


class SymbolLogits2LLRs:
    """Per-bit LLRs from logits on the constellation points:
    ``LLR(i) = logsumexp_{c in C_i1} z_c - logsumexp_{c in C_i0} z_c``."""

    def __init__(self, n_bits_per_sym: int, method: str = "app"):
        if method not in ("app", "maxlog"):
            raise ValueError(f"unknown method {method!r}")
        self.n_bits_per_sym = int(n_bits_per_sym)
        self.method = method
        n_points = 2 ** self.n_bits_per_sym
        labels = np.array([list(np.binary_repr(i, self.n_bits_per_sym))
                           for i in range(n_points)], dtype=np.int64)
        self._c0 = torch.from_numpy(np.stack(
            [np.where(labels[:, i] == 0)[0]
             for i in range(self.n_bits_per_sym)], axis=1))
        self._c1 = torch.from_numpy(np.stack(
            [np.where(labels[:, i] == 1)[0]
             for i in range(self.n_bits_per_sym)], axis=1))

    def __call__(self, logits):
        # logits [..., n_sym, n_points] -> [..., n_sym, n_bits]
        exp0 = logits[..., self._c0.to(logits.device)]
        exp1 = logits[..., self._c1.to(logits.device)]
        if self.method == "app":
            return (torch.logsumexp(exp1, dim=-2)
                    - torch.logsumexp(exp0, dim=-2))
        return exp1.amax(dim=-2) - exp0.amax(dim=-2)


# Gray QPSK's exact LLR is this gain times Re(y) (resp. Im(y)) over No
QPSK_LLR_GAIN = -4.0 * float(np.sqrt(0.5))


class Demapper:
    """``__call__((y, no)) -> llr[..., n_sym * n_bits_per_sym]``."""

    def __init__(self, constell: Constellation, method: str = "app"):
        self.constell = constell
        self._logits2llrs = SymbolLogits2LLRs(constell.n_bits_per_sym, method)

    def __call__(self, inputs):
        y, no = inputs
        no = torch.as_tensor(no, dtype=torch.float32, device=y.device)
        tracing.count("h2d")
        if self.constell.n_bits_per_sym == 2 and self.constell.normalize:
            # Gray QPSK factorises per axis: points (+-a) + j(+-a) with
            # a = 1/sqrt(2), bit 0 on the real axis (label 1 -> -a), so the
            # LLR is -4a Re(y)/No (resp. Im(y)); the cross terms cancel, and
            # max-log gives the same value
            scale = torch.tensor(QPSK_LLR_GAIN, dtype=torch.float32,
                                 device=y.device) / no
            tracing.count("h2d")
            llr = torch.stack([scale * y.real, scale * y.imag], dim=-1)
            return llr.reshape(y.shape[:-1] + (2 * y.shape[-1],))
        points = self.constell.points.reshape((1,) * y.dim() + (-1,))
        exponents = -(y[..., None] - points).abs() ** 2 / no
        llr = self._logits2llrs(exponents)
        return llr.reshape(y.shape[:-1]
                           + (y.shape[-1] * self.constell.n_bits_per_sym,))
