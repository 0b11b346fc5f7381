"""The plain reference of the ``polar_bp`` system: the 5G-ranked polar code
over QPSK and AWGN with an exact demapper (``polar_awgn.Link``'s draws,
encoder and demapper) and a belief-propagation decoder, written here from
the published algorithm:

* the lattice of Arikan (IEEE Commun. Lett. 2008): left messages ``L[s]``
  and right messages ``R[s]``, s = 0..S (n = 2^S), [n] each; ``L[S]``
  holds the channel LLRs (positive means 0), ``R[0]`` the frozen prior
  (+``llr_max`` at frozen positions, 0 elsewhere), everything else starts
  at 0. The stage-s element couples rows i and j = i + 2^s (bit s of i
  clear)::

      L[s][i]   = f(L[s+1][i], L[s+1][j] + R[s][j])
      L[s][j]   = f(L[s+1][i], R[s][i]) + L[s+1][j]
      R[s+1][i] = f(R[s][i],   L[s+1][j] + R[s][j])
      R[s+1][j] = f(R[s][i],   L[s+1][i]) + R[s][j]

  with scaled min-sum ``f(x, y) = msf sign(x) sign(y) min(|x|, |y|)``. A
  sweep updates L at stages S-1 down to 0, then R at stages 0 up to S-1,
  each stage reading what the sweep has already updated;
* the G-matrix early stop of Yuan & Parhi (IEEE Trans. Signal Process.
  2014): every ``check_every`` sweeps, u-hat (0 at frozen positions) from
  ``L[0] + R[0]`` and x-hat from ``L[S] + R[S]``; a codeword whose u-hat G
  equals its x-hat stops, and keeps its messages as they stand;
* the decisions: the info positions of ``L[0] + R[0]``.

Where it departs from the published description, as the configuration
runs it:

* ``f`` clips both inputs to +-``llr_max`` first;
* a hard decision takes a sum of exactly 0 as bit 1;
* in float32, ``msf * f_minsum + v`` (the lower outputs) rounds once, as a
  fused multiply-add does (``msf`` taken as float32); the upper outputs
  round the product ``msf * f_minsum`` once. In a lower precision (the
  control) every operation rounds on its own.

It runs no matrix product or convolution, so TF32 never enters it.
Converged codewords leave the batch, so each check sweeps only the
codewords still running. ``decode_sweeps`` also gives the sweeps each
codeword ran. ``decode_work`` is the decode's least work at the mean
sweeps this decoder's own early stop needs at the cell's Eb/N0.
"""

import math

import numpy as np
import torch

from portbench.reference import nr, polar_awgn
from portbench.reference.scl import polar_transform

# f32 operations, as ``polar_torch/utils/kernel_work.py`` ``bp_work``
# counts them (a frozen copy: the reference never reads the program):
# per f the clips, |.|, min and the sign product; per element and stage
# two f, the partner sum and the add, and in scaled min-sum the two
# products; per check the two hard decisions (an add and a compare a row
# each) and the comparison, and the re-encode's xors
OPS_F_MINSUM = 8
OPS_PE_EXTRA = 2
OPS_PE_SCALED = 2
OPS_CHECK_ROW = 5
OPS_XOR = 1

WORK_SEED = 2 ** 31 + 2025     # the fixed batch the work's sweeps come from
WORK_BLOCKS = 1024


def _round_once(msf, m, c):
    """``msf * m + c`` for float32 ``m``, ``c``, rounded once to float32.

    The product is exact in float64 (``msf`` and ``m`` have 24 significant
    bits each). TwoSum gives the float64 sum ``s`` and its error exactly;
    where the error is not 0, ``s`` is moved to its odd neighbour on the
    error's side (rounding to odd), so the cast to float32 rounds as the
    exact sum would."""
    p = m.double() * msf
    c = c.double()
    s = p + c
    b = s - p
    err = (p - (s - b)) + (c - b)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


class BeliefPropagation:
    """``decode(llr)`` of channel LLRs [n, bs] (positive means 0) -> (the
    info-side total LLR [n, bs], the sweeps each codeword ran [bs] int64,
    the convergence flag [bs] bool)."""

    def __init__(self, frozen, num_iter, check_every, early_stop, msf,
                 llr_max, dtype=torch.float32):
        self.frozen = torch.as_tensor(np.asarray(frozen, dtype=bool))
        self.n = self.frozen.numel()
        self.S = self.n.bit_length() - 1
        self.num_iter, self.check_every = int(num_iter), int(check_every)
        self.early_stop = bool(early_stop)
        self.msf = float(np.float32(msf))
        self.llr_max, self.dtype = float(llr_max), dtype

    # ---- the processing element ----
    def _minsum(self, x, y):
        m = self.llr_max
        x, y = torch.clamp(x, -m, m), torch.clamp(y, -m, m)
        return torch.sign(x) * torch.sign(y) * torch.minimum(x.abs(),
                                                             y.abs())

    def _upper(self, x, y):
        return self.msf * self._minsum(x, y)

    def _lower(self, x, y, v):
        if self.dtype == torch.float32:
            return _round_once(self.msf, self._minsum(x, y), v)
        return self.msf * self._minsum(x, y) + v

    def _rows(self, device):
        """For each stage s, the upper rows i of its elements and their
        partners j."""
        i = torch.arange(self.n, device=device)
        return [(i[(i >> s) & 1 == 0], i[(i >> s) & 1 == 0] + (1 << s))
                for s in range(self.S)]

    def _sweep(self, L, R, rows):
        for s in range(self.S - 1, -1, -1):
            i, j = rows[s]
            a, b = L[s + 1][i], L[s + 1][j]
            L[s][i] = self._upper(a, b + R[s][j])
            L[s][j] = self._lower(a, R[s][i], b)
        for s in range(self.S):
            i, j = rows[s]
            a, b = R[s][i], L[s + 1][j]
            R[s + 1][i] = self._upper(a, b + R[s][j])
            R[s + 1][j] = self._lower(a, L[s + 1][i], R[s][j])

    def _converged(self, L, R, frozen):
        u = ((L[0] + R[0]) <= 0).to(torch.int8)
        u[frozen] = 0
        x = ((L[self.S] + R[self.S]) <= 0).to(torch.int8)
        return (polar_transform(u) == x).all(dim=0)

    def decode(self, llr):
        n, bs = llr.shape
        dev = llr.device
        frozen = self.frozen.to(dev)
        L = torch.zeros((self.S + 1, n, bs), dtype=self.dtype, device=dev)
        R = torch.zeros_like(L)
        L[self.S] = llr.to(self.dtype)
        R[0] = torch.where(frozen, self.llr_max, 0.0).to(self.dtype)[:, None]
        out = torch.empty((n, bs), dtype=self.dtype, device=dev)
        sweeps = torch.full((bs,), self.num_iter, dtype=torch.int64,
                            device=dev)
        done = torch.zeros(bs, dtype=torch.bool, device=dev)
        live = torch.arange(bs, device=dev)     # the codewords still running
        rows = self._rows(dev)
        ran = 0
        if self.early_stop:
            while ran + self.check_every <= self.num_iter and live.numel():
                for _ in range(self.check_every):
                    self._sweep(L, R, rows)
                ran += self.check_every
                ok = self._converged(L, R, frozen)
                hit = live[ok]
                out[:, hit] = L[0][:, ok] + R[0][:, ok]
                sweeps[hit] = ran
                done[hit] = True
                live, L, R = live[~ok], L[:, :, ~ok], R[:, :, ~ok]
        if live.numel():
            for _ in range(self.num_iter - ran):
                self._sweep(L, R, rows)
            out[:, live] = L[0] + R[0]
        return out, sweeps, done


class Link(polar_awgn.Link):
    """The ``polar_awgn`` link's front end (``code: 5g_ranked`` only) with
    the belief-propagation decoder in ``dtype``."""

    def __init__(self, cfg, device, dtype=torch.float32):
        if cfg["code"] != "5g_ranked" or cfg["decoder"] != "bp":
            raise ValueError("polar_bp decodes the 5g_ranked code with bp")
        if cfg["mode"] != "minsum":
            raise ValueError("the reference runs scaled min-sum only")
        self.cfg, self.device, self.dtype = cfg, device, dtype
        self.k, self.n_tx = int(cfg["k"]), int(cfg["n"])
        self.n = self.n_tx
        self.uci = None
        self.llr_max = float(cfg["llr_max"])
        info, frozen = nr.ranked_code(self.k, self.n)
        self.info = torch.from_numpy(info).to(device)
        self.dec = BeliefPropagation(
            frozen, cfg["num_iter"], cfg["check_every"], cfg["early_stop"],
            cfg["msf"], self.llr_max, dtype)

    def decode_sweeps(self, llr):
        """LLRs [bs, n] (positive means 1) -> (decisions [bs, k] int8, the
        sweeps each codeword ran [bs], the convergence flag [bs])."""
        total, sweeps, done = self.dec.decode(
            (-llr.to(self.dtype)).t().contiguous())
        bits = (total[self.info] <= 0).t().to(torch.int8)
        return bits, sweeps, done

    def _decode(self, llr):
        return self.decode_sweeps(llr)[0]

    def mean_sweeps(self, ebno_db, blocks=WORK_BLOCKS, seed=WORK_SEED):
        """(sweeps, checks) a codeword, the means over a fixed seeded batch
        of ``blocks`` blocks at ``ebno_db`` that this decoder runs."""
        _, _, llr = self.front(seed, blocks, ebno_db, torch.float64)
        _, sweeps, done = self.decode_sweeps(llr)
        d = self.dec
        full = d.num_iter // d.check_every if d.early_stop else 0
        checks = torch.where(done, sweeps // d.check_every, full)
        return (sweeps.double().mean().item(),
                checks.double().mean().item())

    def decode_work(self, batch_size, ebno_db):
        """(bytes, f32 operations) that one decode of ``batch_size`` blocks
        at ``ebno_db`` must at least move and do: the n f32 LLRs in and the
        k decisions out (f32), and the per-element and per-check
        operations at the mean sweeps and checks of ``mean_sweeps``."""
        n, S = self.n, self.dec.S
        sweeps, checks = self.mean_sweeps(ebno_db)
        per_sweep = 2 * S * (n // 2) * (2 * OPS_F_MINSUM + OPS_PE_EXTRA
                                        + OPS_PE_SCALED)
        per_check = OPS_CHECK_ROW * n + OPS_XOR * S * (n // 2)
        n_bytes = 4 * n * batch_size + 4 * self.k * batch_size
        return n_bytes, batch_size * (sweeps * per_sweep
                                      + checks * per_check)

