"""Successive-cancellation list (SCL) polar decoder.

Path metrics follow Balatsoukas-Stimming et al. (Eq. 10) with clipped
softplus updates and the initial metrics ``[0, llr_max, ...]``; the best L
of 2L candidates survive each fork. The decode runs one of two two-level
sweeps, with their 2^b-leaf subtrees on the CUDA kernel (``cuda_scl``) when
the input is on the card:

* ``use_fast_scl=True``: the fast-SCL sweep
  (``scan_core.scl_sweep_hybrid_fast``), Hashemi's rate-0/repetition
  pruning plus, with ``fast_rate1``, rate-1 and SPC nodes;
* ``use_fast_scl=False``: the plain sweep (``scan_core.scl_sweep_hybrid``),
  one fork per info leaf, no pruning.

``use_fast_scl=None`` resolves as the JAX package does, from ``schedule``:
``"unrolled"`` takes the fast sweep, ``"scan"`` the plain one, and
``"auto"`` is ``"unrolled"`` below n = 256 and ``"scan"`` from n = 256 up.
Under min-sum the two sweeps decide differently, so each schedule keeps
the JAX engine's bit contract. (The port has no unrolled tree or scan
engine: ``schedule`` picks the sweep, nothing else.)

With ``pc_pos`` (5G's parity-check bits, TS 38.212 5.3.1.2) every path
carries a 5-bit PC register that its info bits fill, and a PC position
decodes as the register's bit with no fork, as the JAX package's unrolled
tree does. PC decoding runs the plain sweep at b = log2(n), the whole tree
in one kernel call, where the register lives (``sc.pc_setup``).

With ``crc_degree`` the decoder is CA-SCL: every surviving path's info word
(payload and CRC, after the downlink input de-interleave ``ind_iil_inv``)
goes through the CRC check, a failing path's metric pays
``llr_max * k``, and the best metric wins. ``use_hybrid_sc`` hands the
decode to ``hybrid.HybridSCLDecoder`` (SC first, CA-SCL on the blocks
whose CRC fails).
"""

import numpy as np
import torch

from polar_torch._device import resolve_device
from polar_torch.models.polar.construction import (as_host_positions,
                                                    info_positions)
from polar_torch.models.polar.cuda_scl import LIST_SIZES
from polar_torch.models.polar.scan_core import (
    default_lower_stages, plan_fast_sweep, plan_plain_sweep,
    resolve_lower_stages, scl_sweep_hybrid, scl_sweep_hybrid_fast)
from polar_torch.models.polar.sc import SCHEDULES, pc_setup
from polar_torch.ops.crc import CRCDecoder, CRCEncoder, crc_polynomial
from polar_torch.ops.fg import F_FUNCTIONS

# from this blocklength up, use_fast_scl=None means the plain sweep (the
# JAX package's scan engine); below it, the fast sweep
PLAIN_SWEEP_MIN_N = 256


class PolarSCLDecoder:
    """SCL decoder. ``__call__(llr_logits[..., n]) -> u_hat[..., k]`` (and
    ``crc_status[...]`` with ``return_crc_status``); logits are positive
    for bit 1.

    ``use_fast_scl`` picks the sweep (module docstring; None resolves from
    ``schedule``, ``"auto"``, ``"unrolled"`` or ``"scan"``). ``fast_rate1``
    adds rate-1 node shortcuts to the rate-0/repetition pruning, and
    ``spc_min_stage`` SPC nodes from that stage up (off when None); both
    need the fast sweep. ``lower_stages`` is the subtree depth b
    (``scan_core.resolve_lower_stages``; by default
    ``scan_core.default_lower_stages(list_size)``): one kernel call per
    2^b-leaf subtree. ``crc_degree``, ``ind_iil_inv``,
    ``return_crc_status``, ``use_hybrid_sc`` and ``pc_pos`` as in the
    module docstring; ``k`` is then the length of payload and CRC (PC
    positions left out)."""

    def __init__(self, frozen_pos, n: int, list_size: int = 8,
                 crc_degree=None, use_hybrid_sc: bool = False,
                 use_fast_scl=None, return_crc_status: bool = False,
                 mode: str = "minsum", llr_max: float = 30.0,
                 ind_iil_inv=None, schedule: str = "auto", pc_pos=None,
                 fast_rate1: bool = False, spc_min_stage=None,
                 lower_stages=None, output_dtype=torch.float32,
                 device=None):
        n = int(n)
        if n < 2 or n & (n - 1):
            raise ValueError("n must be a power of 2, at least 2")
        if list_size not in LIST_SIZES:
            raise ValueError(f"list_size must be one of {LIST_SIZES}")
        if mode not in F_FUNCTIONS:
            raise ValueError(f"unknown mode {mode!r}")
        if crc_degree is None and return_crc_status:
            raise ValueError("returning the CRC status needs crc_degree")
        if schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}")
        if schedule == "auto":
            schedule = "scan" if n >= PLAIN_SWEEP_MIN_N else "unrolled"
        if pc_pos is not None:
            # the register walks every leaf: no pruned nodes (as JAX, which
            # runs its unrolled tree without fast-SCL pruning)
            schedule, use_fast_scl = "unrolled", False
        elif use_fast_scl is None:
            use_fast_scl = schedule == "unrolled"
        if (fast_rate1 or spc_min_stage is not None) and not use_fast_scl:
            raise ValueError("fast_rate1 and spc_min_stage need the fast "
                             "sweep (use_fast_scl=True), which PC-aided "
                             "decoding does not run")
        self.n = n
        self.device = resolve_device(device)
        self.frozen_pos = as_host_positions(frozen_pos)
        self.info_pos = info_positions(self.frozen_pos, n)
        self._pc_mask, info_idx, pc_b = pc_setup(pc_pos, self.info_pos, n,
                                                 lower_stages)
        self.pc_pos = (None if pc_pos is None
                       else np.flatnonzero(self._pc_mask))
        self.k = len(info_idx)
        self.list_size = int(list_size)
        self.use_fast_scl = bool(use_fast_scl)
        self.schedule = schedule
        self.mode = mode
        self.llr_max = float(llr_max)
        self.fast_rate1 = bool(fast_rate1)
        self.spc_min_stage = spc_min_stage
        self.output_dtype = output_dtype
        self.return_crc_status = bool(return_crc_status)
        self._hybrid = None
        if use_hybrid_sc:
            from polar_torch.models.polar.hybrid import HybridSCLDecoder
            self._hybrid = HybridSCLDecoder(
                self.frozen_pos, n, list_size=list_size,
                crc_degree=crc_degree, mode=mode, llr_max=llr_max,
                ind_iil_inv=ind_iil_inv, schedule=schedule,
                return_crc_status=return_crc_status,
                pc_pos=self.pc_pos, use_fast_scl=use_fast_scl,
                lower_stages=lower_stages, output_dtype=output_dtype,
                device=self.device)
            self.lower_stages = self._hybrid.lower_stages
            return
        self._crc_decoder = None
        if crc_degree is not None:
            # the decoder's info word (length k) is payload + CRC parity
            _, crc_len = crc_polynomial(crc_degree)
            if self.k < crc_len:
                raise ValueError("k too small for the given crc_degree")
            self._crc_decoder = CRCDecoder(CRCEncoder(crc_degree,
                                                      k=self.k - crc_len))
        # downlink: undo the input-bit interleaver before the CRC check (the
        # output itself stays in interleaved order, as SC's does)
        self._iil_inv = (None if ind_iil_inv is None else torch.from_numpy(
            as_host_positions(ind_iil_inv)).to(self.device))
        self.lower_stages = resolve_lower_stages(
            n.bit_length() - 1, pc_b or lower_stages,
            default_lower_stages(self.list_size))
        self._frozen_mask = np.zeros(n, dtype=bool)
        self._frozen_mask[self.frozen_pos] = True
        if self.use_fast_scl:
            self._plan = plan_fast_sweep(
                self._frozen_mask, self.lower_stages, self.device,
                rate1=self.fast_rate1, spc_min_stage=spc_min_stage)
        else:
            self._plan = plan_plain_sweep(self._frozen_mask,
                                          self.lower_stages, self.device,
                                          pc_mask=self._pc_mask)
        self._info_idx = torch.from_numpy(info_idx).to(self.device)

    def decode(self, llr_logits):
        """[bs, n] logits -> [bs, k] decisions of the best path (and the
        [bs] CRC status of that path with ``return_crc_status``)."""
        if self._hybrid is not None:
            return self._hybrid.decode(llr_logits)
        llr_ch = (-llr_logits.to(torch.float32)).t().contiguous()  # [n, bs]
        if self.use_fast_scl:
            u_all, pm = scl_sweep_hybrid_fast(
                llr_ch, self._frozen_mask, self.list_size, mode=self.mode,
                llr_max=self.llr_max, lower_stages=self.lower_stages,
                rate1=self.fast_rate1, spc_min_stage=self.spc_min_stage,
                plan=self._plan)
        else:
            u_all, pm = scl_sweep_hybrid(
                llr_ch, self._frozen_mask, self.list_size, mode=self.mode,
                llr_max=self.llr_max, lower_stages=self.lower_stages,
                plan=self._plan)
        u_info = u_all[self._info_idx]                      # [k, L, bs]
        crc_valid = None
        if self._crc_decoder is not None:
            w = u_info.permute(1, 2, 0)                     # [L, bs, k]
            if self._iil_inv is not None:
                w = w[..., self._iil_inv]
            _, crc_valid = self._crc_decoder(w)             # [L, bs, 1]
            crc_valid = crc_valid[..., 0]
            pm = pm + (1.0 - crc_valid.to(torch.float32)) * self.llr_max \
                * self.k
        sel = torch.argmin(pm, dim=0)                       # [bs]
        u_sel = torch.gather(u_info, 1, sel[None, None, :].expand(
            u_info.shape[0], 1, -1))[:, 0]
        out = u_sel.t().to(self.output_dtype)
        if self.return_crc_status:
            return out, torch.gather(crc_valid, 0, sel[None])[0]
        return out

    def __call__(self, inputs):
        if inputs.shape[-1] != self.n or inputs.dim() < 2:
            raise ValueError(f"inputs must be [..., n={self.n}]")
        if inputs.device != self.device:
            raise ValueError(f"inputs on {inputs.device}, decoder on "
                             f"{self.device}")
        lead = inputs.shape[:-1]
        res = self.decode(inputs.reshape(-1, self.n))
        if self.return_crc_status:
            out, status = res
            return out.reshape(lead + (self.k,)), status.reshape(lead)
        return res.reshape(lead + (self.k,))
