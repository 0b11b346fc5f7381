"""A plain successive-cancellation list decoder, written from the
algorithm's description: a recursion over the nodes of the code tree that
carries L paths, each with its own copy of its state.

* f: min-sum ``sign(x) sign(y) min(|x|, |y|)`` or the exact box-plus
  ``log(1 + e^(x+y)) - log(e^x + e^y)``, both on LLRs clipped to
  +-``llr_max``; g: ``(1 - 2u) x + y`` (x the upper half, y the lower).
* Path metrics (Balatsoukas-Stimming et al., Eq. 10): a decision u on a
  clipped LLR a (positive means 0) costs ``softplus(-(1 - 2u) a)``. They
  start at ``[0, llr_max, ..., llr_max]``; a node's costs are summed row
  by row in row order, then added to the metric.
* A fork keeps the L best of the 2L candidates, the L that keep their bit
  (or take 0) first, then the L that flip (or take 1); equal metrics keep
  that order, and survivor l takes the place of rank l.
* Node kinds (Hashemi et al., fast SSCL) when ``fast``: a node whose leaves
  are all frozen is rate-0 (no fork); all frozen but the last, a
  repetition (one fork for the repeated bit); with ``rate1``, none frozen
  is rate-1: hard decisions, then min(L - 1, w) forks, each flipping one
  more of the least reliable rows (ties in row order; with w <= L - 1 the
  rows in row order) at a cost of |a|. Without ``fast`` every leaf is its
  own node.
* PC bits (TS 38.212 5.3.1.2): each path runs the spec's 5-bit cyclic
  register over the leaves; a PC leaf takes y0 with no fork, and an info
  leaf's bit goes into y0.

The decoder returns every path's u and its metric; the caller selects.
"""

import torch

def _clip(x, m):
    return torch.clamp(x, -m, m)


def softplus(x):
    return torch.logaddexp(torch.zeros_like(x), x)


def f_minsum(x, y, m):
    x, y = _clip(x, m), _clip(y, m)
    return torch.sign(x) * torch.sign(y) * torch.minimum(x.abs(), y.abs())


def f_exact(x, y, m):
    x, y = _clip(x, m), _clip(y, m)
    return softplus(x + y) - torch.logaddexp(x, y)


F = {"minsum": f_minsum, "exact": f_exact}


def row_sum(x):
    """Sum over dim 0 in row order."""
    acc = x[0]
    for r in range(1, x.shape[0]):
        acc = acc + x[r]
    return acc


def take(x, parent):
    """Paths (dim -2) of ``x`` re-indexed by ``parent`` [L, bs]."""
    return torch.gather(x, -2, parent.expand(x.shape[:-2] + parent.shape))


def polar_transform(x):
    """u G over GF(2) along dim 0 (an involution): at each level, the
    upper half of every block takes the XOR of both halves."""
    n = x.shape[0]
    s = 1
    while s < n:
        v = x.reshape((n // (2 * s), 2, s) + x.shape[1:])
        x = torch.stack([v[:, 0] ^ v[:, 1], v[:, 1]], dim=1).reshape(x.shape)
        s *= 2
    return x


class ListDecoder:
    """``decode(llr)`` of channel LLRs [n, bs] (positive means 0) ->
    ``(u [n, L, bs] int8, pm [L, bs])`` over the surviving paths."""

    def __init__(self, frozen, L, mode, llr_max=30.0, fast=False,
                 rate1=False, pc_mask=None):
        self.frozen = [bool(v) for v in frozen]
        self.n = len(self.frozen)
        self.L, self.f, self.m = L, F[mode], float(llr_max)
        self.fast, self.rate1 = fast, rate1
        self.pc = None if pc_mask is None else [bool(v) for v in pc_mask]

    def kind(self, s, lo):
        seg = self.frozen[lo:lo + (1 << s)]
        if s == 0:
            if seg[0]:
                return "frozen"
            return "pc" if self.pc is not None and self.pc[lo] else "info"
        if not self.fast:
            return "split"
        if all(seg):
            return "rate0"
        if not seg[-1] and all(seg[:-1]):
            return "rep"
        if self.rate1 and not any(seg):
            return "rate1"
        return "split"

    def decode(self, llr):
        n, bs = llr.shape
        L = self.L
        dev, dt = llr.device, llr.dtype
        self.pm = torch.full((L, bs), self.m, dtype=dt, device=dev)
        self.pm[0] = 0
        self.reg = (None if self.pc is None else
                    torch.zeros((5, L, bs), dtype=torch.int8, device=dev))
        a = llr[:, None, :].expand(n, L, bs).contiguous()
        beta, _ = self.node(n.bit_length() - 1, 0, a)
        return polar_transform(beta), self.pm

    # ---- forks ----
    def fork(self, cand0, cand1):
        """Keep the best L of [cand0; cand1]: (parent, took_1)."""
        vals, idx = torch.sort(torch.cat([cand0, cand1], dim=0), dim=0,
                               stable=True)
        self.pm = vals[:self.L]
        idx = idx[:self.L]
        parent = idx % self.L
        if self.reg is not None:
            self.reg = take(self.reg, parent)
        return parent, (idx // self.L).to(torch.int8)

    # ---- nodes ----
    def node(self, s, lo, a):
        """Decode the node of 2^s leaves from ``lo`` on its LLRs ``a``
        [2^s, L, bs]. Returns its partial sums and the map from its final
        paths to the paths it started with (None: unchanged)."""
        kind = self.kind(s, lo)
        m = self.m
        if kind in ("frozen", "info", "pc"):
            return self.leaf_node(kind, a)
        if kind == "rate0":
            self.pm = self.pm + row_sum(softplus(-_clip(a, m)))
            return torch.zeros(a.shape, dtype=torch.int8,
                               device=a.device), None
        if kind == "rep":
            ac = _clip(a, m)
            parent, bit = self.fork(self.pm + row_sum(softplus(-ac)),
                                    self.pm + row_sum(softplus(ac)))
            return bit[None].expand(a.shape).contiguous(), parent
        if kind == "rate1":
            return self.rate1_node(a)
        h = 1 << (s - 1)
        b_l, p1 = self.node(s - 1, lo, self.f(a[:h], a[h:], m))
        if p1 is not None:
            a = take(a, p1)
        a_r = (1.0 - 2.0 * b_l.to(a.dtype)) * a[:h] + a[h:]
        b_r, p2 = self.node(s - 1, lo + h, a_r)
        if p2 is not None:
            b_l = take(b_l, p2)
            p1 = p2 if p1 is None else torch.gather(p1, 0, p2)
        return torch.cat([b_l ^ b_r, b_r], dim=0), p1

    def leaf_node(self, kind, a):
        ac = _clip(a[0], self.m)
        parent = None
        if self.reg is not None:
            self.reg = torch.roll(self.reg, -1, dims=0)
        if kind == "frozen":
            self.pm = self.pm + softplus(-ac)
            bit = torch.zeros(ac.shape, dtype=torch.int8, device=a.device)
        elif kind == "pc":
            bit = self.reg[0].clone()
            self.pm = self.pm + softplus(torch.where(bit == 1, ac, -ac))
        else:
            parent, bit = self.fork(self.pm + softplus(-ac),
                                    self.pm + softplus(ac))
            if self.reg is not None:
                self.reg[0] ^= bit
        return bit[None], parent

    def rate1_node(self, a):
        L = self.L
        w = a.shape[0]
        ac = _clip(a, self.m)
        mag = ac.abs()
        bits = (ac < 0).to(torch.int8)
        self.pm = self.pm + row_sum(softplus(-mag))
        forks = min(L - 1, w)
        in_order = w <= L - 1
        if not in_order:
            rows = torch.sort(mag, dim=0, stable=True)[1][:forks]
        comp = None
        for t in range(forks):
            # fork t flips the path's t-th least reliable row (row t)
            r = (torch.full(self.pm.shape, t, dtype=torch.int64,
                            device=a.device) if in_order else rows[t])
            cost = torch.gather(mag, 0, r[None])[0]
            parent, flip = self.fork(self.pm, self.pm + cost)
            mag, bits, r = take(mag, parent), take(bits, parent), \
                take(r, parent)
            if not in_order:
                rows = take(rows, parent)
            bits.scatter_(0, r[None], torch.gather(bits, 0, r[None]) ^
                          flip[None])
            comp = parent if comp is None else torch.gather(comp, 0, parent)
        return bits, comp

    def schedule(self):
        """The decode's nodes in leaf order: (kind, stage, first leaf)."""
        ops = []

        def walk(s, lo):
            kind = self.kind(s, lo)
            if kind == "split":
                walk(s - 1, lo)
                walk(s - 1, lo + (1 << (s - 1)))
            else:
                ops.append((kind, s, lo))

        walk(self.n.bit_length() - 1, 0)
        return ops
