"""Hybrid SC -> CA-SCL decoding.

SC-decode every block, check the CRC of the SC output, and re-decode with
CA-SCL only the blocks whose CRC failed. At working SNRs most blocks pass
after SC, so the chain runs near SC's speed. A block whose SC output passes
the CRC keeps it.

The decode costs one host sync: the [bs] mask of SC failures crosses to the
host to size the CA-SCL re-decode. The failing rows are gathered into a
capacity bucket (a power of two, at least ``min_capacity``, held at its
high-water mark), padded with copies of the first failing row, decoded,
and scattered back. Every decoder of the chain treats each codeword (each
batch column) on its own: the CUDA kernels give one thread per codeword,
and the sweeps' tensor ops work column by column. So a re-decoded row gets
exactly the bits a full-batch CA-SCL decode gives it, and padding rows
decode to the same bits as the row they copy.
"""

import numpy as np
import torch

from polar_torch._device import resolve_device
from polar_torch.models.polar.construction import as_host_positions
from polar_torch.models.polar.sc import PolarSCDecoder
from polar_torch.models.polar.scl import PolarSCLDecoder
from polar_torch.ops.crc import CRCDecoder, CRCEncoder, crc_polynomial


class HybridSCLDecoder:
    """SC-first CA-SCL decoder. ``__call__(llr_logits[..., n]) ->
    u_hat[..., k]`` (and ``crc_status[...]`` with ``return_crc_status``);
    ``k`` is the length of payload and CRC.

    ``schedule`` goes to both decoders (it resolves the SCL decoder's
    ``use_fast_scl=None``; the port's SC has one schedule);
    ``lower_stages`` is the SCL decoder's subtree depth. ``pc_pos`` goes
    to both decoders (PC-aided SC and CA-SCL)."""

    def __init__(self, frozen_pos, n: int, list_size: int = 8,
                 crc_degree=None, mode: str = "minsum",
                 llr_max: float = 30.0, ind_iil_inv=None,
                 schedule: str = "auto", return_crc_status: bool = False,
                 min_capacity: int = 128, pc_pos=None, use_fast_scl=None,
                 lower_stages=None, output_dtype=torch.float32,
                 device=None):
        if crc_degree is None:
            raise ValueError("hybrid SC/SCL decoding needs crc_degree (the "
                             "SC accept test is the CRC)")
        self.device = resolve_device(device)
        self._sc = PolarSCDecoder(frozen_pos, n, mode=mode, llr_max=llr_max,
                                  schedule=schedule, pc_pos=pc_pos,
                                  device=self.device)
        self._scl = PolarSCLDecoder(
            frozen_pos, n, list_size=list_size, crc_degree=crc_degree,
            mode=mode, llr_max=llr_max, ind_iil_inv=ind_iil_inv,
            schedule=schedule, return_crc_status=True, pc_pos=pc_pos,
            use_fast_scl=use_fast_scl,
            lower_stages=lower_stages, device=self.device)
        self.n = self._sc.n
        self.k = self._sc.k
        self.frozen_pos = self._sc.frozen_pos
        self.info_pos = self._sc.info_pos
        self.list_size = int(list_size)
        self.lower_stages = self._scl.lower_stages
        self.schedule = self._scl.schedule
        self.mode = mode
        self.return_crc_status = bool(return_crc_status)
        self.min_capacity = int(min_capacity)
        self.output_dtype = output_dtype
        _, crc_len = crc_polynomial(crc_degree)
        self._crc_decoder = CRCDecoder(CRCEncoder(crc_degree,
                                                  k=self.k - crc_len))
        self._iil_inv = (None if ind_iil_inv is None else torch.from_numpy(
            as_host_positions(ind_iil_inv)).to(self.device))
        # the capacity's high-water mark: later batches reuse the largest
        # bucket seen, as the JAX package does to keep one compiled shape
        self._cap_hwm = self.min_capacity

    def _sc_crc(self, llr2d):
        """Full-batch SC decode and CRC accept test: [bs, n] -> (u_sc
        [bs, k], ok [bs] bool)."""
        u_sc = self._sc.decode(llr2d)
        w = u_sc if self._iil_inv is None else u_sc[:, self._iil_inv]
        _, valid = self._crc_decoder(w)
        return u_sc, valid[:, 0]

    def _capacity(self, n_fail: int, bs: int) -> int:
        cap = self.min_capacity
        while cap < n_fail:
            cap *= 2
        cap = min(max(cap, self._cap_hwm), bs)
        self._cap_hwm = max(self._cap_hwm, cap)
        return cap

    def _rows(self, fail, bs):
        """The failing rows padded to their capacity bucket (copies of the
        first failing row), as an index tensor on the device."""
        cap = self._capacity(int(fail.size), bs)
        idx = np.full(cap, fail[0], dtype=np.int64)
        idx[:fail.size] = fail
        return torch.from_numpy(idx).to(self.device)

    def decode(self, llr2d):
        """[bs, n] logits -> [bs, k] decisions (and the [bs] CRC status
        with ``return_crc_status``)."""
        u_sc, ok = self._sc_crc(llr2d)
        fail = np.flatnonzero(~ok.cpu().numpy())   # the one host sync
        out, status = u_sc, ok
        if fail.size:
            idx = self._rows(fail, llr2d.shape[0])
            u_scl, ok_scl = self._scl.decode(llr2d[idx])
            out, status = u_sc.clone(), ok.clone()
            out[idx] = u_scl.to(out.dtype)
            status[idx] = ok_scl
        out = out.to(self.output_dtype)
        return (out, status) if self.return_crc_status else out

    def __call__(self, inputs):
        if inputs.shape[-1] != self.n or inputs.dim() < 2:
            raise ValueError(f"inputs must be [..., n={self.n}]")
        lead = inputs.shape[:-1]
        res = self.decode(inputs.reshape(-1, self.n))
        if self.return_crc_status:
            out, status = res
            return out.reshape(lead + (self.k,)), status.reshape(lead)
        return res.reshape(lead + (self.k,))

    def prewarm(self, bs: int, scl_capacity: int = None):
        """Build and load the kernels with one SC decode of ``bs`` blocks
        and one CA-SCL decode at the capacity bucket, and raise the bucket's
        high-water mark to ``scl_capacity``."""
        if scl_capacity:
            self._cap_hwm = max(self._cap_hwm, int(scl_capacity))
        zeros = torch.zeros((max(bs, self._cap_hwm), self.n),
                            device=self.device)
        self._sc_crc(zeros[:bs])
        self._scl.decode(zeros[:self._cap_hwm])

    def decode_pipelined(self, llr_batches, scl_batch: int = 8192):
        """Decode many ``[bs_i, n]`` batches with one host sync: SC and the
        CRC test run on every batch, all accept masks cross to the host
        together, and the failing rows of all batches go through CA-SCL in
        calls of at most ``scl_batch`` rows (the last padded to its bucket).
        Returns a list of ``[bs_i, k]`` tensors (or ``(out, status)`` pairs
        with ``return_crc_status``)."""
        llr_batches = [x.reshape(-1, self.n) for x in llr_batches]
        sizes = [x.shape[0] for x in llr_batches]
        scs = [self._sc_crc(x) for x in llr_batches]
        u_all = torch.cat([u for u, _ in scs])
        status = torch.cat([ok for _, ok in scs])
        fail = np.flatnonzero(~status.cpu().numpy())   # the one host sync
        if fail.size:
            llr_all = torch.cat(llr_batches)
            for lo in range(0, int(fail.size), scl_batch):
                chunk = fail[lo:lo + scl_batch]
                idx = self._rows(chunk, scl_batch)
                u_scl, ok_scl = self._scl.decode(llr_all[idx])
                real = idx[:chunk.size]
                u_all[real] = u_scl[:chunk.size].to(u_all.dtype)
                status[real] = ok_scl[:chunk.size]
        outs = [u.to(self.output_dtype) for u in u_all.split(sizes)]
        if self.return_crc_status:
            return list(zip(outs, status.split(sizes)))
        return outs
