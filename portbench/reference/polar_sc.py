"""The plain reference of the ``polar_sc`` system: the 5G-ranked polar code
over QPSK and AWGN with an exact demapper (``polar_awgn.Link``'s draws,
encoder and demapper) and a successive-cancellation decoder, written here
from Arikan's description (IEEE Trans. Inf. Theory 2009):

* a node of width w = 2^s takes the LLRs ``a`` [w, bs] of its codeword
  (positive means 0); with halves ``x = a[:w/2]``, ``y = a[w/2:]`` it
  decodes its left child on ``f(x, y)``, then its right child on
  ``g(x, y, v) = (1 - 2v) x + y``, v the left child's partial sums, and
  returns its decisions and its partial sums ``[v ^ v', v']`` (v' the
  right child's), the codeword of its decisions;
* f is min-sum, ``sign(x) sign(y) min(|x|, |y|)`` (``scl.F``);
* a leaf decides 0 where it is frozen, else 0 where its LLR is positive
  and 1 otherwise.

The recursion walks the whole tree, frozen subtrees too: no pruning, no
kernels, no schedule, every row of the batch through every node.

Where it departs from the published description, as the configuration
runs it:

* f clips both inputs to +-``llr_max`` first; g does not clip;
* a leaf LLR of exactly 0 decides bit 1;
* frozen leaves are 0.

It computes in float32 (the control: bfloat16), one rounding an
operation; min-sum f is exact and g rounds once, so the decisions are a
function of the LLRs alone. It runs no matrix product or convolution, so
TF32 never enters it. ``decode_work`` counts the decode's least work
itself, from the code's sizes and frozen set.
"""

import numpy as np
import torch

from portbench import work
from portbench.reference import nr, polar_awgn
from portbench.reference.scl import F


class SuccessiveCancellation:
    """``decode(llr)`` of channel LLRs [n, bs] (positive means 0) -> the
    decisions u [n, bs] int8 (0 at frozen positions)."""

    def __init__(self, frozen, mode, llr_max):
        self.frozen = np.asarray(frozen, dtype=bool)
        self.n = len(self.frozen)
        self.f, self.llr_max = F[mode], float(llr_max)

    def decode(self, llr):
        return self._node(llr, 0, self.n)[0]

    def _node(self, a, lo, w):
        """(decisions, partial sums) [w, bs] int8 of the node covering
        leaves [lo, lo + w) on its LLRs ``a`` [w, bs]."""
        if w == 1:
            u = (torch.zeros_like(a, dtype=torch.int8) if self.frozen[lo]
                 else (a <= 0).to(torch.int8))
            return u, u
        h = w // 2
        x, y = a[:h], a[h:]
        u0, v0 = self._node(self.f(x, y, self.llr_max), lo, h)
        u1, v1 = self._node((1 - 2 * v0.to(a.dtype)) * x + y, lo + h, h)
        return torch.cat([u0, u1]), torch.cat([v0 ^ v1, v1])


def pruned_work(frozen, mode):
    """f32 operations of one SC decode of one block on the rate-0-pruned
    tree: a node whose leaves are all frozen has zero partial sums whatever
    its LLRs, so no f or g computes its LLRs and nothing below it runs.
    Otherwise a node of width w computes f into its left child and g into
    its right child (w/2 rows each, where that child is not all frozen),
    and, where a g reads its partial sums (it is a left child, or its
    parent's sums are read in turn), w/2 XORs combine its children's sums
    unless one child is all frozen. Leaf decisions are not counted, as
    ``work.decode_work`` counts none."""
    frozen = np.asarray(frozen, dtype=bool)

    def dead(lo, w):
        return bool(frozen[lo:lo + w].all())

    def node(lo, w, sums_read):
        if w == 1 or dead(lo, w):
            return 0, 0, 0
        h = w // 2
        live0, live1 = not dead(lo, h), not dead(lo + h, h)
        f0, g0, x0 = node(lo, h, sums_read or live1)
        f1, g1, x1 = node(lo + h, h, sums_read)
        return (f0 + f1 + h * live0, g0 + g1 + h * live1,
                x0 + x1 + h * (sums_read and live0 and live1))

    n_f, n_g, n_xor = node(0, len(frozen), False)
    return work.OPS_F[mode] * n_f + work.OPS_G * n_g + work.OPS_XOR * n_xor


class Link(polar_awgn.Link):
    """The ``polar_awgn`` link's front end (``code: 5g_ranked`` only) with
    the successive-cancellation decoder in ``dtype``."""

    def __init__(self, cfg, device, dtype=torch.float32):
        if cfg["code"] != "5g_ranked" or cfg["decoder"] != "sc":
            raise ValueError("polar_sc decodes the 5g_ranked code with sc")
        self.cfg, self.device, self.dtype = cfg, device, dtype
        self.k, self.n_tx = int(cfg["k"]), int(cfg["n"])
        self.n = self.n_tx
        self.uci = None
        self.llr_max = float(cfg["llr_max"])
        info, frozen = nr.ranked_code(self.k, self.n)
        self.info = torch.from_numpy(info).to(device)
        self.dec = SuccessiveCancellation(frozen, cfg["mode"], self.llr_max)

    def _decode(self, llr):
        """LLRs [bs, n] (positive means 1) -> decisions [bs, k] int8."""
        u = self.dec.decode((-llr.to(self.dtype)).t().contiguous())
        return u[self.info].t()

    def decode_work(self, batch_size):
        """(bytes, f32 operations) that one SC decode of ``batch_size``
        blocks must at least move and do: the n LLRs in and the k
        decisions out, f32 each (as ``work.decode_work`` counts them), and
        ``pruned_work``'s operations a block."""
        n_bytes = 4 * self.n * batch_size + 4 * self.k * batch_size
        return n_bytes, batch_size * pruned_work(self.dec.frozen,
                                                 self.cfg["mode"])
