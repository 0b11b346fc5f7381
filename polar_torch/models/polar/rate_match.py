"""5G NR polar rate-matching interleavers (3GPP TS 38.212 Sec. 5.4.1).

Host NumPy, run once when a code is built: on the device, rate matching is
one gather (encode) and a gather, pad or fold (LLR de-matching).
"""

import numpy as np

# Permutation of Tab. 5.4.1.1.1-1 in TS 38.212 (sub-block interleaver).
SUBBLOCK_PERM = np.array([
    0, 1, 2, 4, 3, 5, 6, 7, 8, 16, 9, 17, 10, 18, 11, 19,
    12, 20, 13, 21, 14, 22, 15, 23, 24, 25, 26, 28, 27, 29, 30, 31,
], dtype=np.int64)

# Tab. 5.3.1.1-1 in TS 38.212 (input bit interleaver pattern, k_il_max=164).
INPUT_INTERLEAVER_PATTERN = np.array([
    0, 2, 4, 7, 9, 14, 19, 20, 24, 25, 26, 28, 31, 34,
    42, 45, 49, 50, 51, 53, 54, 56, 58, 59, 61, 62, 65, 66, 67, 69,
    70, 71, 72, 76, 77, 81, 82, 83, 87, 88, 89, 91, 93, 95, 98, 101,
    104, 106, 108, 110, 111, 113, 115, 118, 119, 120, 122, 123, 126,
    127, 129, 132, 134, 138, 139, 140, 1, 3, 5, 8, 10, 15, 21, 27, 29,
    32, 35, 43, 46, 52, 55, 57, 60, 63, 68, 73, 78, 84, 90, 92, 94, 96,
    99, 102, 105, 107, 109, 112, 114, 116, 121, 124, 128, 130, 133,
    135, 141, 6, 11, 16, 22, 30, 33, 36, 44, 47, 64, 74, 79, 85, 97,
    100, 103, 117, 125, 131, 136, 142, 12, 17, 23, 37, 48, 75, 80, 86,
    137, 143, 13, 18, 38, 144, 39, 145, 40, 146, 41, 147, 148, 149,
    150, 151, 152, 153, 154, 155, 156, 157, 158, 159, 160, 161, 162, 163,
], dtype=np.int64)

K_IL_MAX = 164


def subblock_interleaving(u: np.ndarray) -> np.ndarray:
    """Sub-block interleaver, Sec. 5.4.1.1: 32 sub-blocks permuted by
    ``SUBBLOCK_PERM``. ``len(u)`` must be a multiple of 32."""
    u = np.asarray(u)
    k = u.shape[-1]
    if k % 32:
        raise ValueError("length for sub-block interleaving must be a "
                         "multiple of 32")
    blk = k // 32
    n = np.arange(k)
    j = SUBBLOCK_PERM[n // blk] * blk + (n % blk)
    return u[..., j]


def channel_interleaver(c: np.ndarray) -> np.ndarray:
    """Triangular channel interleaver, Sec. 5.4.1.3 (uplink ``I_BIL``).

    Writes ``c`` row-wise into an upper-left triangle of side ``T`` (smallest
    T with T(T+1)/2 >= E), reads column-wise, skipping NULL entries.
    """
    c = np.asarray(c)
    e = c.shape[-1]
    t = int(np.ceil((np.sqrt(8 * e + 1) - 1) / 2))
    assert t * (t + 1) // 2 >= e
    # index grid: entry (i, j) of the triangle holds input index i-th row
    # offset; NULL where the running index exceeds e.
    out = []
    # running input index of triangle slot (i, j): rows shrink by one
    # row i starts at sum_{r<i} (t - r)
    row_start = np.concatenate([[0], np.cumsum(t - np.arange(t))])
    for j in range(t):
        for i in range(t - j):
            ind_k = row_start[i] + j
            if ind_k < e:
                out.append(ind_k)
    perm = np.array(out, dtype=np.int64)
    assert perm.shape[0] == e
    return c[..., perm]


def input_interleaver(c: np.ndarray) -> np.ndarray:
    """Input bit interleaver, Sec. 5.4.1.1 (downlink ``I_IL``)."""
    c = np.asarray(c)
    k = c.shape[-1]
    if k > K_IL_MAX:
        raise ValueError("input interleaver defined only for k <= 164")
    sel = INPUT_INTERLEAVER_PATTERN[INPUT_INTERLEAVER_PATTERN >= (K_IL_MAX - k)]
    return c[..., sel - (K_IL_MAX - k)]
