"""Parity-check (PC) bits of 5G uplink polar codes (TS 38.212 5.3.1.2).

For uplink payloads 12 <= A <= 19 (K = A + 6 after CRC6) the standard puts
``n_PC = 3`` parity-check bits among the most reliable positions:

* placement: of Q, the ``K + n_PC`` most reliable positions that are not
  pre-frozen, the ``n_PC - n_pc_wm`` PC bits take the least reliable; when
  ``E - K + 3 > 192`` one more (``n_pc_wm = 1``) takes the remaining
  position of least generator row weight ``2^popcount(i)`` (ties to the
  most reliable);
* values: a length-5 cyclic shift register runs over every mother-code
  position in order. It rotates left at each position; a data bit is XORed
  into ``y[0]``; a PC position emits ``u_i = y[0]``; frozen positions only
  rotate.

The register is linear in the data bits, so each PC bit is the parity of a
fixed set of data positions: ``pc_expand`` is one GF(2) product.
"""

import numpy as np
import torch

from polar_torch.utils.numerics import int_mod_2


def n_pc_wm(e_target: int, k_with_crc: int) -> int:
    """Number of row-weight-placed PC bits (0 or 1), TS 38.212 5.3.1.2."""
    return 1 if (e_target - k_with_crc + 3) > 192 else 0


def select_pc_positions(info_cand, k_with_crc: int, n_pc: int,
                        wm_count: int):
    """Pick PC positions from ``info_cand`` (non-pre-frozen positions in
    ascending reliability). Returns ``(info_pos_incl_pc, pc_pos)``, both
    sorted ascending."""
    if not n_pc >= wm_count >= 0:
        raise ValueError(f"need n_pc >= wm_count >= 0, got {n_pc}, "
                         f"{wm_count}")
    q = np.asarray(info_cand[-(k_with_crc + n_pc):])  # ascending reliability
    pc = list(q[: n_pc - wm_count])  # least reliable of the selected set
    if wm_count:
        rest = q[n_pc - wm_count:]
        weights = np.array([1 << bin(int(i)).count("1") for i in rest])
        wmin = weights.min()
        # ties break toward the most reliable (later in ascending order)
        pc.append(int(rest[np.nonzero(weights == wmin)[0][-1]]))
    pc_pos = np.sort(np.asarray(pc, dtype=np.int64))
    info_incl = np.sort(q.astype(np.int64))
    return info_incl, pc_pos


def pc_flags(n: int, info_pos_incl_pc, pc_pos):
    """``(is_data[n], is_pc[n])`` masks: data = info excluding PC."""
    is_pc = np.zeros(n, dtype=bool)
    is_pc[np.asarray(pc_pos, dtype=np.int64)] = True
    is_info = np.zeros(n, dtype=bool)
    is_info[np.asarray(info_pos_incl_pc, dtype=np.int64)] = True
    return is_info & ~is_pc, is_pc


def pc_parity_matrix(is_data, is_pc) -> np.ndarray:
    """``[n, n_pc]`` 0/1 matrix: column j marks the data positions whose
    XOR the register emits at the j-th PC position. Each register cell
    holds a set of data positions (a Python int used as a bit set)."""
    y = [0] * 5
    cols = []
    for i, (d, p) in enumerate(zip(np.asarray(is_data, bool),
                                   np.asarray(is_pc, bool))):
        y = y[1:] + y[:1]  # left cyclic: new y0 = old y1
        if p:
            cols.append(y[0])
        elif d:
            y[0] ^= 1 << i
    n = len(is_data)
    mat = np.zeros((n, len(cols)), dtype=np.float32)
    for j, c in enumerate(cols):
        for i in range(n):
            mat[i, j] = (c >> i) & 1
    return mat


def fill_pc(u_scattered, mat, pc_idx):
    """``u_scattered`` [..., n] with its PC slots ``pc_idx`` set from the
    GF(2) product with ``pc_parity_matrix`` ``mat`` (both on its device)."""
    pc_vals = int_mod_2(torch.matmul(u_scattered.to(torch.float32), mat))
    out = u_scattered.clone()
    out[..., pc_idx] = pc_vals.to(out.dtype)
    return out


def pc_expand(u_scattered, is_data, is_pc):
    """Fill the PC values into a scattered u-vector ``u_scattered``
    [..., n] (data bits placed, PC slots zero), in its dtype."""
    dev = u_scattered.device
    return fill_pc(u_scattered,
                   torch.from_numpy(pc_parity_matrix(is_data, is_pc)).to(dev),
                   torch.from_numpy(np.flatnonzero(is_pc)).to(dev))
