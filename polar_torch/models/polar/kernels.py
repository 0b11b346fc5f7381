"""The polar kernel zoo: kernel matrices by name, as host NumPy.

* ``F2`` and its Kronecker powers ``F4``..``F32`` (``arikan_power``);
* ``B4``..``B32``, the powers with bit-reversed row order, and
  ``W4``..``W32``, the powers with rows sorted by weight (stable);
* the reference zoo's hand-written research kernels (``G2``, ``R4``,
  ``G8``, ``R8``, ``K8``, ``G16``, ``R16``, ``K16``, ``K162``..``K165``,
  ``G162``, ``G32``), some with rows no Arikan power has.

``get_kernel`` looks one up; the lowest-row-weight construction
(``construction.get_kern_frozen_bits``) and the dense-G chain
(``dense.py``) take any of them.
"""

import numpy as np

from polar_torch.models.polar.construction import ARIKAN_F2, gen_arikan


def _bit_reverse_perm(n: int) -> np.ndarray:
    bits = int(np.log2(n))
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def arikan_power(n: int) -> np.ndarray:
    """``F2^{(x) log2(n)}``: the F4/F8/F16/F32 family."""
    stages = n.bit_length() - 1
    if n < 2 or 1 << stages != n:
        raise ValueError(f"n={n} is not a power of 2, at least 2")
    return gen_arikan(ARIKAN_F2, stages)


def bit_reversed_kernel(n: int) -> np.ndarray:
    """The Arikan power with its rows in bit-reversed order."""
    g = arikan_power(n)
    return g[_bit_reverse_perm(n)]


def weight_sorted_kernel(n: int) -> np.ndarray:
    """The Arikan power with its rows sorted by increasing weight
    (stable)."""
    g = arikan_power(n)
    order = np.argsort(g.sum(axis=1), kind="stable")
    return g[order]


def row_weights(kern: np.ndarray) -> np.ndarray:
    """The weight of each row."""
    return np.asarray(kern).sum(axis=1)


def get_kernel(name: str) -> np.ndarray:
    """A copy of the kernel named ``name`` (case-insensitive); an unknown
    name raises ``KeyError``."""
    name = name.upper()
    if name in KERNELS:
        return KERNELS[name].copy()
    raise KeyError(f"unknown kernel {name!r}; available: {sorted(KERNELS)}")


def _unpack_rows(ncols: int, rows) -> np.ndarray:
    """Decode a kernel stored as per-row column bitmasks (bit ncols-1-j =
    column j) into a dense float32 0/1 matrix."""
    out = np.zeros((len(rows), ncols), dtype=np.float32)
    for i, r in enumerate(rows):
        for j in range(ncols):
            out[i, j] = (r >> (ncols - 1 - j)) & 1
    return out


# The reference zoo's research kernels, stored as row bitmasks. R4/R8/K8
# are row permutations of the Arikan powers; the G*/K16x matrices have rows
# of their own (G16's weight-6 rows, which no F16 row has). The reference
# defines K164 twice; as in Python, the later definition wins, and it is
# the one kept here.
_ZOO = {
    "G2": (2, (0x2, 0x1)),  # the 2x2 identity ("giveup" kernel)
    "R4": (4, (0x8, 0xa, 0xc, 0xf)),
    "G8": (8, (0x80, 0xc0, 0xa0, 0x90, 0xe8, 0xd4, 0xb2, 0xff)),
    "R8": (8, (0x80, 0x88, 0xa0, 0xc0, 0xaa, 0xcc, 0xf0, 0xff)),
    "K8": (8, (0x80, 0x88, 0xa0, 0xaa, 0xc0, 0xcc, 0xf0, 0xff)),
    "G16": (16, (0x8000, 0xc000, 0xa000, 0xf000, 0x8800, 0x8080, 0xc0c0,
                 0xa0a0, 0x6ca0, 0xca60, 0xff00, 0xf0f0, 0x8888, 0xcccc,
                 0xaaaa, 0xffff)),
    "R16": (16, (0x8000, 0x8080, 0x8800, 0xa000, 0xc000, 0xc0c0, 0xa0a0,
                 0x8888, 0xf000, 0xca60, 0x6ca0, 0xaaaa, 0xcccc, 0xf0f0,
                 0xff00, 0xffff)),
    "K16": (16, (0x8000, 0x8080, 0x8800, 0xa000, 0xc0c0, 0xa0a0, 0x8888,
                 0xf000, 0xc000, 0xca60, 0x6ca0, 0xaaaa, 0xcccc, 0xf0f0,
                 0xff00, 0xffff)),
    "K162": (16, (0x8000, 0x8080, 0x8800, 0xc0c0, 0xa0a0, 0x8888, 0xf000,
                  0xc000, 0xca60, 0x6ca0, 0xa000, 0xaaaa, 0xcccc, 0xf0f0,
                  0xff00, 0xffff)),
    "K163": (16, (0x8000, 0x8080, 0x8800, 0xc0c0, 0x8888, 0xf000, 0xc000,
                  0xca60, 0x6ca0, 0xa000, 0xa0a0, 0xaaaa, 0xcccc, 0xf0f0,
                  0xff00, 0xffff)),
    "K164": (16, (0x8000, 0x8080, 0x8800, 0xa0a0, 0xc0c0, 0x8888, 0xc000,
                  0xf000, 0xca60, 0x6ca0, 0xa000, 0xaaaa, 0xcccc, 0xf0f0,
                  0xff00, 0xffff)),
    "K165": (16, (0x8000, 0x8080, 0x8800, 0x8888, 0xa0a0, 0xc0c0, 0xc000,
                  0xf000, 0xca60, 0x6ca0, 0xa000, 0xaaaa, 0xcccc, 0xf0f0,
                  0xff00, 0xffff)),
    "G162": (16, (0x8000, 0xc000, 0xa000, 0x8800, 0x8080, 0xc0c0, 0xa0a0,
                  0xf000, 0x8888, 0x6ca0, 0xca60, 0xff00, 0xf0f0, 0xcccc,
                  0xaaaa, 0xffff)),
    "G32": (32, (0x80000000, 0xc0000000, 0xa0000000, 0xf0000000, 0x88000000,
                 0x80800000, 0xc0c00000, 0xa0a00000, 0xac600000, 0x6ac00000,
                 0xff000000, 0xf0f00000, 0x80008000, 0xc000c000, 0x4888c000,
                 0xcccc0000, 0xa000a000, 0xf000f000, 0x5aaaf000, 0xffff0000,
                 0x88008800, 0x80808080, 0xc0c0c0c0, 0xa0a0a0a0, 0xac60ac60,
                 0x6ac06ac0, 0xff00ff00, 0xf0f0f0f0, 0x88888888, 0xcccccccc,
                 0xaaaaaaaa, 0xffffffff)),
}

KERNELS = {"F2": ARIKAN_F2.copy()}
for _n in (4, 8, 16, 32):
    KERNELS[f"F{_n}"] = arikan_power(_n)
    KERNELS[f"B{_n}"] = bit_reversed_kernel(_n)
    KERNELS[f"W{_n}"] = weight_sorted_kernel(_n)
for _name, (_nc, _rows) in _ZOO.items():
    KERNELS[_name] = _unpack_rows(_nc, _rows)
