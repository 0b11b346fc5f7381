"""Host-side polar code construction (frozen-set selection), pure NumPy:
the 5G NR reliability table and the lowest-row-weight (RM-style) rule."""

import numpy as np

from polar_torch.models.polar.nr_reliability import NR_RELIABILITY_SEQUENCE


def generate_5g_ranking(k: int, n: int, sort: bool = True,
                        strict: bool = True):
    """Frozen and info positions from the 5G NR reliability table
    (TS 38.212 Tab. 5.3.1.2-1): the ``n - k`` least reliable of the ``n``
    lowest-index channels are frozen. Returns ``[frozen_pos, info_pos]``;
    with ``sort=False`` both are in ascending-reliability order."""
    if strict and not (32 <= n <= 1024 and k <= 1024 and n >= k
                       and n & (n - 1) == 0):
        raise ValueError(f"invalid 5G code k={k}, n={n}: need 32 <= n <= "
                         f"1024 a power of 2 and k <= n")
    seq = NR_RELIABILITY_SEQUENCE
    ranking_n = seq[seq < n][:n]
    frozen_pos = np.array(ranking_n[: n - k], dtype=np.int64)
    info_pos = np.array(ranking_n[n - k:], dtype=np.int64)
    if sort:
        frozen_pos = np.sort(frozen_pos)
        info_pos = np.sort(info_pos)
    return [frozen_pos, info_pos]


def as_host_positions(positions) -> np.ndarray:
    """A frozen set (or any position list) as a host int64 array; a tensor
    is copied to the host, as the JAX package's ``np.asarray`` does."""
    if hasattr(positions, "detach"):
        positions = positions.detach().cpu().numpy()
    return np.asarray(positions, dtype=np.int64)


def info_positions(frozen_pos, n: int) -> np.ndarray:
    """Complement of ``frozen_pos`` in ``range(n)``."""
    return np.setdiff1d(np.arange(n), np.asarray(frozen_pos, dtype=np.int64))


def gen_arikan(base, layers: int) -> np.ndarray:
    """Kronecker power ``base^{(x) layers}``."""
    base = np.asarray(base, dtype=np.int64)
    m = base.copy()
    for _ in range(layers - 1):
        m = np.kron(base, m)
    return m


ARIKAN_F2 = np.array([[1, 0], [1, 1]], dtype=np.int64)


def get_kern_frozen_bits(n: int, f_num: int, kern=ARIKAN_F2):
    """Freeze the ``f_num`` lowest-row-weight rows of ``kern^{(x) s}``
    (the CLI's ``--construction rm``). Ties go to the lower position
    (stable argsort). Returns ``(G, row_weights, frozen_pos)``."""
    kern = np.asarray(kern, dtype=np.int64)
    base = kern.shape[0]
    n_stages = int(round(np.log(n) / np.log(base)))
    if base ** n_stages != n:
        raise ValueError(f"n={n} is not a power of the kernel size {base}")
    g = gen_arikan(kern, n_stages)
    weights = g.sum(axis=1)
    frozen_pos = np.sort(np.argsort(weights, kind="stable")[:f_num])
    return g, weights, frozen_pos
