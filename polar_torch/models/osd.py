"""Ordered-statistics decoding (OSD) of any binary linear block code.

Order-``t`` OSD with the LLR distance metric: the generator ``G`` comes
from encoding the identity; each block sorts its |LLR|s, brings the
permuted ``G`` into systematic form over its most reliable basis (MRB) by
GF(2) elimination, hard-decides the ``k`` most reliable bits, re-encodes
them, then tries every error pattern of weight 1..t on those bits and
keeps the codeword of least distance.

Everything runs in torch ops on the decoder's device; the 0/1 matrices are
uint8, so the elimination's rank-1 updates and the candidates are XORs:

* the elimination is ``k`` full-batch steps; the pivot of step ``i`` is
  the first 1 of row ``i`` (``argmax`` returns the first maximum);
* the patterns are one ``[chunks, chunk, t]`` array over the orders 1..t,
  width-padded with the sentinel index ``k`` (an appended all-zero row of
  the systematic ``G``) and length-padded with all-sentinel rows;
* the distance is the mean softplus of ``llr * (1 - 2c)``, in f32;
* every sort whose keys can tie is stable: a tie put in another order
  changes the basis, and so the output.
"""

import itertools

import numpy as np
import torch
from scipy.special import comb

from polar_torch._device import resolve_device

# bytes of candidate workspace a sweep step may hold: the candidates
# (uint8) and their signed LLRs and softplus terms (f32), 9 bytes an
# element of [bs, patterns, n]
SWEEP_BYTES = 1 << 31


def _dist(llr, c):
    """LLR distance: mean softplus(``llr * (1 - 2c)``) over the last axis.
    ``llr [bs, n]`` f32, ``c [bs, p, n]`` 0/1 -> ``[bs, p]``."""
    llr = llr[:, None, :]
    sgn = torch.where(c.bool(), -llr, llr)
    return torch.logaddexp(sgn.new_zeros(()), sgn).mean(dim=-1)


def _gf2_rows_product(u, g):
    """``u @ g mod 2`` per block: ``u [bs, k]``, ``g [bs, k, n]`` 0/1 ->
    uint8 ``[bs, n]``. The f32 product is exact: its sums stay below
    2^24, and 0/1 inputs are exact in TF32 too."""
    prod = torch.bmm(u[:, None, :].to(torch.float32), g.to(torch.float32))
    return (prod[:, 0].to(torch.int32) & 1).to(torch.uint8)


class OSDecoder:
    """``__call__(llr_logits[..., n]) -> c_hat[..., n]`` (codeword bits;
    ``llr > 0`` means 1).

    ``encoder`` has ``k`` and maps ``[k, k]`` identity rows to the rows of
    ``G``; the decoder runs on ``device``, by default the encoder's."""

    def __init__(self, t: int = 0, encoder=None, llr_max: float = 100.0,
                 pattern_chunk: int = 4096, dtype=torch.float32,
                 device=None):
        if int(t) != t or t < 0:
            raise ValueError("t must be a nonnegative int")
        if encoder is None or getattr(encoder, "k", None) is None:
            raise AttributeError("encoder is not initialized or has no k.")
        self._t = int(t)
        self._llr_max = float(llr_max)
        self._pattern_chunk = int(pattern_chunk)
        self.dtype = dtype
        enc_device = getattr(encoder, "device", None)
        self.device = resolve_device(enc_device if device is None
                                     else device)
        eye = torch.eye(encoder.k, dtype=torch.float32, device=enc_device)
        gm = encoder(eye).detach().cpu().numpy().astype(np.uint8)  # [k, n]
        self._k, self._n = int(gm.shape[0]), int(gm.shape[1])
        self._gm = torch.from_numpy(gm).to(self.device)
        num_patterns = sum(comb(self._n, ti, exact=True)
                           for ti in range(1, self._t + 1))
        num_symbols = num_patterns * self._n
        if num_symbols > 1e9:
            print(f"Note: OSD complexity is large for these code params and "
                  f"t={t}. Consider small batch sizes.")
        if num_symbols > 1e11:
            raise ResourceWarning("OSD complexity too high; use a smaller t.")
        self._pattern_chunks = None
        self._patterns = None
        if self._t > 0:
            pats = []
            for ti in range(1, self._t + 1):
                p = np.array(list(itertools.combinations(range(self._k),
                                                         ti)),
                             dtype=np.int64).reshape(-1, ti)
                pats.append(np.pad(p, ((0, 0), (0, self._t - ti)),
                                   constant_values=self._k))
            allp = np.concatenate(pats, axis=0)
            chunk = min(self._pattern_chunk, len(allp))
            pad = (-len(allp)) % chunk
            self._pattern_chunks = np.pad(
                allp, ((0, pad), (0, 0)),
                constant_values=self._k).reshape(-1, chunk, self._t)
            # the sweep's list: the chunks' rows without the all-sentinel
            # rows that pad the last chunk (``sweep`` says why)
            self._patterns = torch.from_numpy(self._pattern_chunks.reshape(
                -1, self._t)[:len(allp)]).to(self.device)

    @property
    def k(self):
        return self._k

    @property
    def n(self):
        return self._n

    def _find_mrb(self, g):
        """GF(2) elimination to systematic form over the most reliable
        basis, per block. ``g [bs, k, n]`` uint8 (columns in reliability
        order; overwritten) -> ``(g_mrb [bs, k, n], idx_mrb [bs, n])``."""
        bs, k, n = g.shape
        pivots = []
        for i in range(k):
            row = g[:, i, :]                                      # [bs, n]
            pivot = torch.argmax(row, dim=-1)                     # first 1
            col = torch.gather(g, 2, pivot.view(bs, 1, 1).expand(
                bs, k, 1))[..., 0]                                # [bs, k]
            col[:, i] = 0                         # the pivot row stays
            g ^= col[:, :, None] & row[:, None, :]
            pivots.append(pivot)
        idx_pivot = torch.stack(pivots, dim=1)                    # [bs, k]
        # the non-pivot columns in their order, after the pivots
        counts = torch.zeros((bs, n), dtype=torch.int64, device=g.device)
        counts.scatter_add_(1, idx_pivot, torch.full_like(idx_pivot, n))
        keyed = torch.arange(n, device=g.device)[None, :] + counts
        idx_parity = torch.argsort(keyed, dim=-1, stable=True)[:, : n - k]
        idx_mrb = torch.cat([idx_pivot, idx_parity], dim=1)
        g = torch.gather(g, 2, idx_mrb[:, None, :].expand(bs, k, n))
        return g, idx_mrb

    def sweep(self, llr_sort, c, gm_mrb):
        """Step 4 of a decode, order 1..t: the best of ``c`` and every
        ``c ^ rows(pattern)`` by distance (uint8 ``[bs, n]``, basis order).

        The candidates are taken in the patterns' order, a piece of at most
        ``pattern_chunk`` (and ``SWEEP_BYTES``) at a time; the first
        minimum of a piece wins inside it, and a piece's best replaces the
        running best only when strictly smaller. That picks the first
        minimum over all candidates with ``c`` winning ties, however the
        list is cut, as chunks of ``pattern_chunk`` give it: so the pieces
        may be smaller, and the padding rows, which reproduce ``c``, are
        left out."""
        bs, k, n = gm_mrb.shape
        gm_aug = torch.cat([gm_mrb, gm_mrb.new_zeros((bs, 1, n))], dim=1)
        c_best = c
        d_best = _dist(llr_sort, c[:, None, :])[:, 0]
        piece = max(1, min(self._pattern_chunk,
                           SWEEP_BYTES // (9 * bs * n)))
        for start in range(0, self._patterns.shape[0], piece):
            pats = self._patterns[start:start + piece]            # [p, t]
            c_cand = c[:, None, :].expand(bs, pats.shape[0], n)
            for j in range(self._t):
                c_cand = c_cand ^ gm_aug[:, pats[:, j], :]        # [bs, p, n]
            d = _dist(llr_sort, c_cand)                           # [bs, p]
            arg = torch.argmin(d, dim=1)                          # first min
            d_min = torch.gather(d, 1, arg[:, None])[:, 0]
            better = d_min < d_best
            c_min = torch.gather(c_cand, 1, arg.view(bs, 1, 1).expand(
                bs, 1, n))[:, 0]
            c_best = torch.where(better[:, None], c_min, c_best)
            d_best = torch.where(better, d_min, d_best)
        return c_best

    def basis(self, llr_in):
        """Steps 1-3 of a decode, ``llr_in [bs, n]`` logits ->
        ``(idx_sort, llr_sort, c, gm_mrb)``: the positions in basis order,
        the clipped LLRs in that order, the re-encoded hard decisions on
        the most reliable basis (uint8) and the systematic ``G``."""
        llr_ch = llr_in.to(torch.float32).clamp(-self._llr_max,
                                                 self._llr_max)
        # 1) reliability order
        idx_sort = torch.argsort(-llr_ch.abs(), dim=-1, stable=True)
        gm_sort = self._gm[:, idx_sort].transpose(0, 1).contiguous()
        # 2) most reliable basis
        gm_mrb, idx_mrb = self._find_mrb(gm_sort)
        idx_sort = torch.gather(idx_sort, 1, idx_mrb)
        llr_sort = torch.gather(llr_ch, 1, idx_sort)
        # 3) hard decisions on the k most reliable bits, re-encoded
        u_hd = (llr_sort[:, : self._k] > 0).to(torch.uint8)
        return idx_sort, llr_sort, _gf2_rows_product(u_hd, gm_mrb), gm_mrb

    def decode(self, llr_in):
        """``[bs, n]`` logits on the decoder's device -> ``[bs, n]``
        codeword bits in ``dtype``."""
        idx_sort, llr_sort, c, gm_mrb = self.basis(llr_in)
        # 4) error patterns of weight 1..t
        if self._patterns is not None:
            c = self.sweep(llr_sort, c, gm_mrb)
        # 5) back to channel order
        c_hat = torch.empty_like(c).scatter_(1, idx_sort, c)
        return c_hat.to(self.dtype)

    def __call__(self, inputs):
        if inputs.shape[-1] != self._n:
            raise ValueError(f"last dim must be of length n={self._n}")
        if inputs.device != self.device:
            raise ValueError(f"inputs on {inputs.device}, decoder on "
                             f"{self.device}")
        lead = inputs.shape[:-1]
        return self.decode(inputs.reshape(-1, self._n)).reshape(
            lead + (self._n,))
