"""The plain reference of the ``polar_awgn`` system: a polar code over
QPSK and AWGN with an exact demapper and a list decoder.

``Link(cfg, device, dtype)`` reads a configuration file's keys:

* ``code``: ``"5g_ranked"`` (the k most reliable of n channels, info bits
  in ascending position order, no CRC) or ``"5g_uci"`` (``UciCode`` of k
  payload bits in n coded bits: CRC6, PC bits, rate matching);
* ``decoder``: ``"scl"`` (the best path's info bits) or ``"5g_cascl"``
  (CA-SCL: a path whose CRC fails pays ``llr_max`` times the length of
  payload and CRC, the least metric wins, the payload is returned);
* ``list_size``, ``mode`` (``"minsum"`` or ``"exact"``), ``fast_scl``,
  ``fast_rate1``, ``llr_max``.

``front`` draws a batch from its seed and sends it (``channel``), ``encode``
and ``decode`` work in ``dtype`` (float32 for the reference, bfloat16 for
the control); codewords and decisions are int8.
"""

import torch

from portbench import work
from portbench.reference import channel, nr
from portbench.reference.scl import ListDecoder, polar_transform


def crc_ok(w, a, crc):
    """[..., a + L] words whose last L bits are the CRC of the first a:
    True where they are (int8 0/1 tensors, any device)."""
    par = torch.from_numpy(nr.crc_parity(w[..., :a].cpu().numpy(), crc))
    return (par.to(w.device, torch.int8) == w[..., a:]).all(dim=-1)


class Link:
    def __init__(self, cfg, device, dtype=torch.float32):
        self.cfg, self.device, self.dtype = cfg, device, dtype
        self.k, self.n_tx = int(cfg["k"]), int(cfg["n"])
        self.llr_max = float(cfg["llr_max"])
        pc_mask = None
        if cfg["code"] == "5g_ranked":
            info, frozen = nr.ranked_code(self.k, self.n_tx)
            self.uci = None
            self.n = self.n_tx
        elif cfg["code"] == "5g_uci":
            self.uci = nr.UciCode(self.k, self.n_tx)
            info, frozen, pc_mask = (self.uci.info, self.uci.frozen,
                                     self.uci.pc_mask)
            self.n = self.uci.n
            self.rm = torch.from_numpy(self.uci.rm).to(device)
        else:
            raise ValueError(f"unknown code {cfg['code']!r}")
        self.info = torch.from_numpy(info).to(device)
        # the decoder's output positions: info less the PC ones
        data = [int(i) for i in info if pc_mask is None or not pc_mask[i]]
        self.data = torch.tensor(data, dtype=torch.int64, device=device)
        self.dec = ListDecoder(frozen, int(cfg["list_size"]), cfg["mode"],
                               self.llr_max, fast=bool(cfg["fast_scl"]),
                               rate1=bool(cfg["fast_rate1"]),
                               pc_mask=pc_mask)
        if (cfg["decoder"] == "5g_cascl") != (self.uci is not None):
            raise ValueError("5g_cascl decodes the 5g_uci code, scl the "
                             "5g_ranked one")

    # ---- transmitter ----
    def front(self, seed, batch_size, ebno_db, dtype):
        """The batch that a Monte-Carlo step seeded with ``seed`` sends at
        Eb/N0 ``ebno_db``: (payload bits [bs, k], sent bits [bs, n_tx],
        exact LLRs [bs, n_tx] computed in ``dtype``)."""
        bits, nr_, ni = channel.draws(seed, batch_size, self.k,
                                      self.n_tx // 2, self.device)
        cw = self.encode(bits)
        no = channel.noise_variance(ebno_db, self.k, self.n_tx)
        return bits, cw, channel.qpsk_awgn_llr(cw, nr_, ni, no, dtype)

    def encode(self, bits):
        """Payload bits [bs, k] (0/1 integers) -> sent bits [bs, n_tx]."""
        bits = bits.to(torch.int8)
        if self.uci is None:
            u = torch.zeros((bits.shape[0], self.n), dtype=torch.int8,
                            device=bits.device)
            u[:, self.info] = bits
            return polar_transform(u.t().contiguous()).t()
        par = torch.from_numpy(nr.crc_parity(bits.cpu().numpy(),
                                             self.uci.crc))
        c = torch.cat([bits, par.to(bits.device, torch.int8)], dim=1)
        u = torch.from_numpy(self.uci.u_vector(c.cpu().numpy()))
        d = polar_transform(u.to(bits.device, torch.int8).t().contiguous())
        return d.t()[:, self.rm]

    # ---- receiver ----
    def rate_recover(self, llr):
        """[bs, n_tx] LLRs -> [bs, n] at the mother code's positions.

        Each sent bit t carries d bit ``rm[t]``. Like the program's
        receiver, it adds the first two copies of each bit only: after the
        channel de-interleave the circular buffer's position j and j + n
        (j < n_tx - n) are added and the copies from 2n on are left out.
        With n_tx = 864 onto n = 256 that leaves 352 of 864 LLRs unused."""
        bs = llr.shape[0]
        n, e = self.n, self.n_tx
        order = torch.from_numpy(nr.channel_interleaver_index(e)).to(
            llr.device)
        buf = torch.empty_like(llr)
        buf[:, order] = llr                       # circular-buffer order
        head = buf[:, :n].clone()
        rep = min(e - n, n)
        head[:, :rep] = head[:, :rep] + buf[:, n:n + rep]
        out = torch.empty((bs, n), dtype=llr.dtype, device=llr.device)
        j = torch.from_numpy(nr.subblock_index(n)).to(llr.device)
        out[:, j] = head
        return out

    def decode(self, llr, rows=None):
        """LLRs [bs, n_tx] (positive means 1) -> payload decisions
        [bs, k] int8, ``rows`` blocks at a time."""
        rows = rows or llr.shape[0]
        return torch.cat([self._decode(llr[i:i + rows])
                          for i in range(0, llr.shape[0], rows)])

    def _decode(self, llr):
        llr = llr.to(self.dtype)
        if self.uci is not None:
            llr = self.rate_recover(llr)
        u, pm = self.dec.decode((-llr).t().contiguous())
        w = u[self.data].permute(2, 1, 0)          # [bs, L, k (+ CRC)]
        if self.uci is not None:
            ok = crc_ok(w, self.k, self.uci.crc)
            pm = pm + ((~ok).t().to(pm.dtype)
                       * (self.llr_max * w.shape[-1]))
        sel = torch.argmin(pm, dim=0)
        out = w[torch.arange(w.shape[0], device=w.device), sel]
        return out[:, :self.k]

    def decode_work(self, batch_size):
        """(bytes, f32 operations) that one list decode of ``batch_size``
        blocks must at least move and do: the mother code's n LLRs in, the
        decisions out, the node schedule at L paths (``portbench.work``)."""
        return work.decode_work(self.dec.schedule(), self.n, len(self.data),
                                self.dec.L, batch_size, self.cfg["mode"])
