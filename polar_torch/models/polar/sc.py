"""Successive-cancellation (SC) polar decoder.

Inputs are logits (``llr > 0`` means bit 1) and are negated on entry; an
exact-zero LLR decides bit 1. The decode is the two-level SC sweep of
``scan_core.sc_sweep_hybrid`` on the rate-0-pruned schedule
(``fast_schedule(mask, rep=False)``), which gives the same bits as the
plain sweep: an all-frozen span's partial sums are zero whatever its LLRs.
Its 2^b-leaf subtrees run on the CUDA kernel (``cuda_sc``) when the input
is on the card; with b = log2(n) the whole tree is one kernel call.
"""

import numpy as np
import torch

from polar_torch._device import resolve_device
from polar_torch.models.polar.construction import (as_host_positions,
                                                    info_positions)
from polar_torch.models.polar.cuda_scl import MAX_B
from polar_torch.models.polar.scan_core import (
    DEFAULT_SC_LOWER_STAGES, plan_sc_sweep, resolve_lower_stages,
    sc_sweep_hybrid)
from polar_torch.ops.fg import F_FUNCTIONS

SCHEDULES = ("auto", "unrolled", "scan")
# PC-aided decoding runs in the JAX package only on its unrolled trees,
# which the port does not have
PC_NOT_PORTED = ("pc_pos (PC-aided decoding) is not ported yet (ROADMAP "
                 "Queue 1, \"PC-aided SC/SCL decoding\")")


class PolarSCDecoder:
    """SC decoder. ``__call__(llr_logits[..., n]) -> u_hat[..., k]``.

    ``schedule`` is taken for the JAX package's signature: every schedule
    gives the same bits, and the port has one. ``lower_stages`` is the
    subtree depth b (default ``scan_core.DEFAULT_SC_LOWER_STAGES``, clamped
    to [1, log2(n)]): one kernel call per 2^b-leaf subtree."""

    def __init__(self, frozen_pos, n: int, mode: str = "minsum",
                 llr_max: float = 30.0, schedule: str = "auto",
                 pc_pos=None, output_dtype=torch.float32,
                 lower_stages=None, device=None):
        if pc_pos is not None:
            raise NotImplementedError(f"PolarSCDecoder: {PC_NOT_PORTED}")
        n = int(n)
        if n < 2 or n & (n - 1):
            raise ValueError("n must be a power of 2, at least 2")
        if mode not in F_FUNCTIONS:
            raise ValueError(f"unknown mode {mode!r}")
        if schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}")
        self.n = n
        self.device = resolve_device(device)
        self.frozen_pos = as_host_positions(frozen_pos)
        self.info_pos = info_positions(self.frozen_pos, n)
        self.k = n - len(self.frozen_pos)
        self.mode = mode
        self.llr_max = float(llr_max)
        self.schedule = schedule
        self.output_dtype = output_dtype
        self.lower_stages = resolve_lower_stages(
            n.bit_length() - 1, lower_stages, DEFAULT_SC_LOWER_STAGES)
        if self.lower_stages > MAX_B:
            raise ValueError(f"subtree depth {self.lower_stages} > {MAX_B}")
        self._frozen_mask = np.zeros(n, dtype=bool)
        self._frozen_mask[self.frozen_pos] = True
        self._plan = plan_sc_sweep(self._frozen_mask, self.lower_stages,
                                   self.device)
        self._info_idx = torch.from_numpy(self.info_pos).to(self.device)

    def decode(self, llr_logits):
        """[bs, n] logits -> [bs, k] hard decisions."""
        llr_ch = (-llr_logits.to(torch.float32)).t().contiguous()  # [n, bs]
        u = sc_sweep_hybrid(llr_ch, self._frozen_mask, mode=self.mode,
                            llr_max=self.llr_max,
                            lower_stages=self.lower_stages, plan=self._plan)
        return u[self._info_idx].t().to(self.output_dtype)

    def __call__(self, inputs):
        if inputs.shape[-1] != self.n or inputs.dim() < 2:
            raise ValueError(f"inputs must be [..., n={self.n}]")
        if inputs.device != self.device:
            raise ValueError(f"inputs on {inputs.device}, decoder on "
                             f"{self.device}")
        lead = inputs.shape[:-1]
        return self.decode(inputs.reshape(-1, self.n)).reshape(
            lead + (self.k,))
