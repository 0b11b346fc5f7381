"""Host-side polar code construction (frozen-set selection), NumPy: the 5G
NR reliability table, the lowest-row-weight (RM-style) rule with stable
ties or with the reference CLI's own tie order (``rm-ref``), the
Reed-Muller code and the Gaussian-approximation (GA) construction."""

import os

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


def get_ref_rm_frozen_bits(n: int, f_num: int, kern_name: str = "F2"):
    """The reference CLI's exact lowest-row-weight frozen set
    (``--construction rm-ref``).

    The reference breaks ties between equal row weights in the order of
    its (unstable) ``torch.argsort``, which no stable rule reproduces. Its
    reliability order for each named kernel and n up to 1024 was captured
    by running it, and ships as ``ref_rm_orders.npz``; the frozen set is
    the sorted first ``f_num`` entries."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "ref_rm_orders.npz")
    key = f"{kern_name}_n{n}"
    with np.load(path) as z:
        if key not in z:
            raise ValueError(
                f"no captured reference order for kernel={kern_name!r} "
                f"n={n} (available: powers of the kernel base up to 1024)")
        order = z[key]
    if not 0 <= f_num <= n:
        raise ValueError(f"f_num={f_num} outside [0, n={n}]")
    return np.sort(order[:f_num]).astype(np.int64)


def generate_rm_code(r: int, m: int):
    """The Reed-Muller ``(r, m)`` code: positions whose index has Hamming
    weight below ``m - r`` are frozen. Returns ``(frozen_pos, info_pos, n,
    k, d_min)``."""
    if r > m:
        raise ValueError("order r cannot be larger than m")
    n = 2 ** m
    d_min = 2 ** (m - r)
    idx = np.arange(n)
    w = np.array([bin(i).count("1") for i in range(n)], dtype=np.int64)
    frozen_mask = w < (m - r)
    frozen_pos = idx[frozen_mask]
    info_pos = idx[~frozen_mask]
    return frozen_pos, info_pos, n, int(info_pos.shape[0]), d_min


def generate_ga_code(k: int, n: int, design_ebno_db: float = 2.0):
    """AWGN-matched frozen set by the Gaussian approximation of density
    evolution (Trifonov 2012), at Eb/N0 ``design_ebno_db``: the channel
    LLR mean is ``m0 = 4 R Eb/N0`` (QPSK with exact demapping), and the
    ``n - k`` bit-channels of the smallest means are frozen, ties to the
    lower index. Returns ``[frozen_pos, info_pos]``."""
    from polar_torch.models.polar.ga import ga_bit_channel_means
    k, n = int(k), int(n)
    if not (0 < k < n and n & (n - 1) == 0):
        raise ValueError(f"invalid GA code k={k}, n={n}: need 0 < k < n, "
                         "n a power of 2")
    m0 = 4.0 * (k / n) * 10.0 ** (float(design_ebno_db) / 10.0)
    order = np.argsort(ga_bit_channel_means(n, m0), kind="stable")
    return [np.sort(order[: n - k]), np.sort(order[n - k:])]
