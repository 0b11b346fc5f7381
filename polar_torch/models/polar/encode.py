"""Polar encoders: for a given frozen set, and the 5G rate-matched one."""

import numpy as np
import torch

from polar_torch._device import resolve_device
from polar_torch.models.polar import pc, rate_match as rm
from polar_torch.models.polar.construction import (as_host_positions,
                                                    generate_5g_ranking,
                                                    info_positions)
from polar_torch.ops.butterfly import polar_transform
from polar_torch.ops.crc import CRCEncoder
from polar_torch.utils import tracing


class PolarEncoder:
    """``__call__(u[..., k]) -> c[..., n]``: info bits go to the non-frozen
    positions (frozen positions are 0), then the polar transform."""

    def __init__(self, frozen_pos, n: int, dtype=torch.float32, device=None):
        n = int(n)
        if n & (n - 1):
            raise ValueError("n must be a power of 2")
        self.n = n
        self.dtype = dtype
        self.device = resolve_device(device)
        self.frozen_pos = as_host_positions(frozen_pos)
        self.info_pos = info_positions(self.frozen_pos, n)
        self.k = n - len(self.frozen_pos)
        # scatter as a gather from u padded with one zero (index k)
        gather = np.full(n, self.k, dtype=np.int64)
        gather[self.info_pos] = np.arange(self.k)
        self._scatter_idx = torch.from_numpy(gather).to(self.device)

    def scatter_info(self, u):
        """Info bits at ``info_pos``, zeros at the frozen positions."""
        u_pad = torch.cat([u, u.new_zeros(u.shape[:-1] + (1,))], dim=-1)
        return u_pad[..., self._scatter_idx]

    def __call__(self, u):
        if u.shape[-1] != self.k:
            raise ValueError(f"last dim must be of length k={self.k}")
        return polar_transform(self.scatter_info(u)).to(self.dtype)

    def parity_check(self, c):
        """True where ``c[..., n]`` is a codeword of this code (a test
        aid). ``G`` is an involution over GF(2), so ``u = c G``, and ``c``
        is valid when ``u`` is 0 at every frozen position."""
        if c.shape[-1] != len(self._scatter_idx):
            raise ValueError("c must be [..., n] of the polar code")
        u = polar_transform(c.to(torch.int8))
        frozen = torch.from_numpy(self.frozen_pos).to(c.device)
        return ~u[..., frozen].bool().any(dim=-1)


class Polar5GEncoder(PolarEncoder):
    """5G NR polar encoder with rate matching (TS 38.212):
    ``__call__(u[..., k]) -> c[..., n]`` with ``k``, ``n`` the targets.

    Chain: CRC attach, (downlink) input interleave, sub-channel allocation
    (PC bits for uplink 12 <= k <= 19 with ``enable_pc``), polar transform,
    then one gather that does sub-block interleave, circular-buffer rate
    matching (repetition, puncturing or shortening) and (uplink) channel
    interleave. All index math runs on the host when the code is built, as
    in the JAX package; ``n_polar``, ``k_polar``, ``frozen_pos``,
    ``pc_pos`` and the gather indices equal its own. The call runs in the
    spans ``encode.crc``, ``encode.polar`` (PC bits included) and
    ``encode.rate_match``."""

    def __init__(self, k: int, n: int, channel_type: str = "uplink",
                 verbose: bool = False, enable_pc: bool = True,
                 dtype=torch.float32, device=None):
        k, n = int(k), int(n)
        if n < k:
            raise ValueError("invalid code rate (> 1)")
        if channel_type not in ("uplink", "downlink"):
            raise ValueError(f"unsupported channel_type {channel_type!r}")
        self.channel_type = channel_type
        self.enable_pc = bool(enable_pc)
        self.verbose = verbose
        crc_degree, n_polar, frozen_pos, idx_rm, idx_input = \
            self._init_rate_match(k, n)
        super().__init__(frozen_pos, n_polar, dtype=dtype, device=device)
        self.k_polar, self.n_polar = self.k, self.n
        self.k_target, self.n_target = k, n
        self.k, self.n = k, n
        self.enc_crc = CRCEncoder(crc_degree, k=k, dtype=dtype)
        self._ind_rate_matching = np.asarray(idx_rm)
        self._ind_input_int = (None if idx_input is None
                               else np.asarray(idx_input))
        dev = self.device
        self._rm_idx = torch.from_numpy(self._ind_rate_matching).to(dev)
        self._iil_idx = (None if idx_input is None
                         else torch.from_numpy(self._ind_input_int).to(dev))
        if self.pc_pos is not None:
            is_data, is_pc = pc.pc_flags(n_polar, self.info_pos,
                                         self.pc_pos)
            data_pos = np.nonzero(is_data)[0]
            k_data = len(data_pos)  # payload + CRC
            gather = np.full(n_polar, k_data, dtype=np.int64)
            gather[data_pos] = np.arange(k_data)
            self._pc_scatter_idx = torch.from_numpy(gather).to(dev)
            self._pc_mat = torch.from_numpy(
                pc.pc_parity_matrix(is_data, is_pc)).to(dev)
            self._pc_idx = torch.from_numpy(self.pc_pos).to(dev)

    def _init_rate_match(self, k_target: int, n_target: int):
        """CRC choice, mother-code size, frozen set and the combined
        rate-matching gather (TS 38.212 Sec. 5.3.1, 5.4.1)."""
        if not 18 <= n_target <= 1088 or k_target > 1013:
            raise ValueError("need 18 <= n <= 1088 and k <= 1013 (no code "
                             "block segmentation)")
        if self.channel_type == "uplink":
            if 12 <= k_target <= 19:
                crc_degree, k_crc = "CRC6", 6
            elif k_target >= 20:
                crc_degree, k_crc = "CRC11", 11
            else:
                raise ValueError(
                    "k_target < 12 is not supported in 5G NR uplink; use the "
                    "'channel coding of small block lengths' scheme "
                    "(Sec. 5.3.3 of TS 38.212) instead.")
            # the 3 PC bits of Sec. 5.3.1.2, unless they cannot fit the
            # target length
            n_pc = 3 if (k_target <= 19 and self.enable_pc
                         and k_target + k_crc + 3 <= n_target) else 0
        else:
            if k_target > 140 or not 25 <= n_target <= 576:
                raise ValueError("downlink needs k <= 140 and "
                                 "25 <= n <= 576")
            crc_degree, k_crc = "CRC24C", 24
            n_pc = 0

        k_polar = k_target + k_crc + n_pc
        if k_polar > n_target:
            raise ValueError("k_polar + k_crc + n_pc > n_target")

        # mother code size (Sec. 5.3.1)
        n_min, n_max = 5, (10 if self.channel_type == "uplink" else 9)
        if (n_target <= (9 / 8) * 2 ** (np.ceil(np.log2(n_target)) - 1)
                and k_polar / n_target < 9 / 16):
            n1 = np.ceil(np.log2(n_target)) - 1
        else:
            n1 = np.ceil(np.log2(n_target))
        n2 = np.ceil(np.log2(8 * k_polar))  # rate >= 1/8
        n_polar = int(2 ** max(min(n1, n2, n_max), n_min))

        # puncturing / shortening pre-frozen positions (Sec. 5.4.1.1)
        prefrozen = []
        if n_target < n_polar:
            if k_polar / n_target <= 7 / 16:  # puncturing
                n_int = int(32 * np.ceil((n_polar - n_target) / 32))
                pattern = rm.subblock_interleaving(np.arange(n_int))
                prefrozen.extend(int(pattern[i])
                                 for i in range(n_polar - n_target))
                if n_target >= 3 * n_polar / 4:
                    t = int(np.ceil(3 / 4 * n_polar - n_target / 2) - 1)
                else:
                    t = int(np.ceil(9 / 16 * n_polar - n_target / 4) - 1)
                prefrozen.extend(range(t))
            else:  # shortening
                n_int = int(32 * np.ceil(n_polar / 32))
                pattern = rm.subblock_interleaving(np.arange(n_int))
                prefrozen.extend(int(pattern[i])
                                 for i in range(n_target, n_polar))
        prefrozen = np.unique(np.asarray(prefrozen, dtype=np.int64))

        # reliability-ranked info set minus the pre-frozen positions
        # (setdiff1d with assume_unique keeps the reliability order)
        ch_ranking, _ = generate_5g_ranking(0, n_polar, sort=False,
                                            strict=False)
        info_cand = np.setdiff1d(ch_ranking, prefrozen, assume_unique=True)
        if n_pc:
            k_with_crc = k_target + k_crc
            wm = pc.n_pc_wm(n_target, k_with_crc)
            info_pos, self.pc_pos = pc.select_pc_positions(
                info_cand, k_with_crc, n_pc, wm)
        else:
            info_pos = np.sort(info_cand[-k_polar:]).astype(np.int64)
            self.pc_pos = None
        frozen_pos = np.setdiff1d(np.arange(n_polar), info_pos,
                                  assume_unique=True)

        # downlink input bit interleaver
        ind_input_int = (rm.input_interleaver(np.arange(k_polar))
                         if self.channel_type == "downlink" else None)

        # one gather: sub-block interleave -> circular buffer -> (uplink)
        # channel interleave
        ind_sub_int = rm.subblock_interleaving(np.arange(n_polar))
        if n_target >= n_polar:  # repetition
            idx_c_matched = np.mod(np.arange(n_target), n_polar)
        elif k_polar / n_target <= 7 / 16:  # puncturing: keep the tail
            idx_c_matched = np.arange(n_target) + (n_polar - n_target)
        else:  # shortening: keep the head
            idx_c_matched = np.arange(n_target)
        if self.channel_type == "uplink":
            ind_channel_int = rm.channel_interleaver(np.arange(n_target))
            idx_rate_matched = ind_sub_int[idx_c_matched[ind_channel_int]]
        else:
            idx_rate_matched = ind_sub_int[idx_c_matched]

        if self.verbose:
            print(f"Code params after rate-matching: k = {k_target}, "
                  f"n = {n_target}")
            print(f"Polar mother code: k_polar = {k_polar}, "
                  f"n_polar = {n_polar}")
            print(f"Using {crc_degree}")
            print(f"Frozen positions: {frozen_pos}")
            print(f"Channel type: {self.channel_type}")
        return crc_degree, n_polar, frozen_pos, idx_rate_matched, \
            ind_input_int

    def __call__(self, u):
        if u.shape[-1] != self.k_target:
            raise ValueError(f"last dim must be of length k={self.k_target}")
        with tracing.span("encode.crc"):
            u_crc = self.enc_crc(u)
        with tracing.span("encode.polar"):
            if self._iil_idx is not None:
                u_crc = u_crc[..., self._iil_idx]
            if self.pc_pos is not None:
                u_pad = torch.cat([u_crc, u_crc.new_zeros(u_crc.shape[:-1]
                                                          + (1,))], dim=-1)
                u_full = pc.fill_pc(u_pad[..., self._pc_scatter_idx],
                                    self._pc_mat, self._pc_idx)
            else:
                u_full = self.scatter_info(u_crc)
            c = polar_transform(u_full).to(self.dtype)
        with tracing.span("encode.rate_match"):
            return c[..., self._rm_idx]
