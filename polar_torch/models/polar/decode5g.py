"""5G NR polar decoding: rate recovery, then SC, CA-SCL or hybrid SC/CA-SCL,
then the CRC check and strip.

Rate recovery undoes the encoder's gather with host-built inverse indices:
the channel de-interleave (uplink), then repetition folded back onto the
head, punctured positions at LLR 0, or shortened positions at the known
value (logit ``-llr_max`` = -100), then the sub-block de-interleave. After
the decoder, ``_post`` undoes the downlink input interleave and checks and
strips the CRC.
"""

import numpy as np
import torch

from polar_torch.models.polar import rate_match as rm
from polar_torch.models.polar.encode import Polar5GEncoder
from polar_torch.models.polar.hybrid import HybridSCLDecoder
from polar_torch.models.polar.sc import PolarSCDecoder
from polar_torch.models.polar.scl import PolarSCLDecoder
from polar_torch.ops.crc import CRCDecoder

DEC_TYPES = ("SC", "SCL", "hybSCL")


class Polar5GDecoder:
    """``__call__(llr_logits[..., n]) -> u_hat[..., k]`` (and
    ``crc_status[...]`` with ``return_crc_status``), ``k`` and ``n`` the
    encoder's targets. ``dec_type`` is ``"SC"``, ``"SCL"`` (CA-SCL) or
    ``"hybSCL"`` (SC first, CA-SCL on the blocks whose CRC fails). It runs
    on the encoder's device; ``lower_stages`` is the SCL subtree depth."""

    def __init__(self, enc_polar: Polar5GEncoder, dec_type: str = "SC",
                 list_size: int = 8, return_crc_status: bool = False,
                 mode: str = "minsum", use_fast_scl=None, lower_stages=None,
                 output_dtype=torch.float32):
        if not isinstance(enc_polar, Polar5GEncoder):
            raise TypeError("Polar5GDecoder takes a Polar5GEncoder")
        if dec_type not in DEC_TYPES:
            raise ValueError(f"dec_type must be one of {DEC_TYPES}")
        self.device = enc_polar.device
        self.output_dtype = output_dtype
        self.n_target, self.k_target = enc_polar.n_target, enc_polar.k_target
        self.n_polar, self.k_polar = enc_polar.n_polar, enc_polar.k_polar
        self.k, self.n = self.k_target, self.n_target
        self.dec_type = dec_type
        self.return_crc_status = bool(return_crc_status)
        self._bil = enc_polar.channel_type == "uplink"
        self._llr_max = 100.0  # logit of a shortened (known-zero) position

        def on_device(idx):
            return torch.from_numpy(np.asarray(idx)).to(self.device)

        self._ch_inv = on_device(np.argsort(
            rm.channel_interleaver(np.arange(self.n_target))))
        self._sub_inv = on_device(np.argsort(
            rm.subblock_interleaving(np.arange(self.n_polar))))
        iil_inv = None
        self._iil_inv = None
        if enc_polar.channel_type == "downlink":
            iil_inv = np.argsort(rm.input_interleaver(
                np.arange(self.k_polar)))
            self._iil_inv = on_device(iil_inv)

        frozen = enc_polar.frozen_pos
        crc_degree = enc_polar.enc_crc.crc_degree
        pc_pos = enc_polar.pc_pos        # the uplink's 12 <= k <= 19 codes
        if dec_type == "SC":
            self._polar_dec = PolarSCDecoder(frozen, self.n_polar, mode=mode,
                                             pc_pos=pc_pos,
                                             device=self.device)
        else:
            cls = PolarSCLDecoder if dec_type == "SCL" else HybridSCLDecoder
            self._polar_dec = cls(
                frozen, self.n_polar, list_size=list_size,
                crc_degree=crc_degree, mode=mode, ind_iil_inv=iil_inv,
                pc_pos=pc_pos, use_fast_scl=use_fast_scl,
                lower_stages=lower_stages, device=self.device)
        self._dec_crc = CRCDecoder(enc_polar.enc_crc)

    def rate_recover(self, llr_ch):
        """[bs, n_target] logits -> [bs, n_polar] de-matched logits."""
        llr_ch = llr_ch.to(torch.float32)
        if self._bil:
            llr_ch = llr_ch[:, self._ch_inv]
        bs, n_polar = llr_ch.shape[0], self.n_polar
        if self.n_target >= n_polar:
            # repetition: fold the tail back onto the head
            n_rep = self.n_target - n_polar
            llr_dm = torch.cat([llr_ch[:, :n_rep] + llr_ch[:, n_polar:],
                                llr_ch[:, n_rep:n_polar]], dim=1)
        elif self.k_polar / self.n_target <= 7 / 16:
            # puncturing: the unsent head positions get LLR 0
            llr_dm = torch.cat([llr_ch.new_zeros(
                (bs, n_polar - self.n_target)), llr_ch], dim=1)
        else:
            # shortening: the tail positions are known zeros
            llr_dm = torch.cat([llr_ch, llr_ch.new_full(
                (bs, n_polar - self.n_target), -self._llr_max)], dim=1)
        return llr_dm[:, self._sub_inv]

    def _post(self, u_hat_crc):
        """Undo the input interleave, check and strip the CRC: (u_hat
        [bs, k], crc_status [bs])."""
        if self._iil_inv is not None:
            u_hat_crc = u_hat_crc[:, self._iil_inv]
        u_hat, crc_status = self._dec_crc(u_hat_crc)
        return u_hat.to(self.output_dtype), crc_status[..., 0]

    def decode(self, llr_logits):
        """[bs, n] logits -> [bs, k] (and the [bs] CRC status with
        ``return_crc_status``)."""
        u_hat_crc = self._polar_dec.decode(self.rate_recover(llr_logits))
        u_hat, crc_status = self._post(u_hat_crc)
        return (u_hat, crc_status) if self.return_crc_status else u_hat

    def __call__(self, inputs):
        if inputs.shape[-1] != self.n_target or inputs.dim() < 2:
            raise ValueError(f"inputs must be [..., n={self.n_target}]")
        lead = inputs.shape[:-1]
        res = self.decode(inputs.reshape(-1, self.n_target))
        if self.return_crc_status:
            u, status = res
            return u.reshape(lead + (self.k,)), status.reshape(lead)
        return res.reshape(lead + (self.k,))

    def decode_pipelined(self, llr_batches, scl_batch: int = 8192):
        """hybSCL over many batches with one host sync
        (``HybridSCLDecoder.decode_pipelined``); a list of ``[bs_i, k]``
        tensors, or ``(u, status)`` pairs with ``return_crc_status``."""
        if self.dec_type != "hybSCL":
            raise ValueError("decode_pipelined is the hybSCL path")
        fronts = [self.rate_recover(x.reshape(-1, self.n_target))
                  for x in llr_batches]
        outs = []
        for mid in self._polar_dec.decode_pipelined(fronts,
                                                    scl_batch=scl_batch):
            u, status = self._post(mid)
            outs.append((u, status) if self.return_crc_status else u)
        return outs

    def prewarm(self, bs: int, scl_capacity: int = None):
        """Build and load the decoder's kernels (hybSCL: at the SCL
        capacity bucket ``scl_capacity`` too)."""
        if self.dec_type == "hybSCL":
            self._polar_dec.prewarm(bs, scl_capacity)
        else:
            self.decode(torch.zeros((bs, self.n_target), device=self.device))
