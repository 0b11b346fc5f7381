"""Successive-cancellation (SC) polar decoder.

Inputs are logits (``llr > 0`` means bit 1) and are negated on entry; an
exact-zero LLR decides bit 1. The decode is the two-level SC sweep of
``scan_core.sc_sweep_hybrid`` on the rate-0-pruned schedule
(``fast_schedule(mask, rep=False)``), which gives the same bits as the
plain sweep: an all-frozen span's partial sums are zero whatever its LLRs.
Its 2^b-leaf subtrees run on the CUDA kernel (``cuda_sc``) when the input
is on the card; with b = log2(n) the whole tree is one kernel call.

With ``pc_pos`` (5G's parity-check bits, TS 38.212 5.3.1.2) a PC position
decodes as the bit of a 5-bit shift register that the info bits before it
fill, as the JAX package's unrolled tree does. The register lives in the
kernel's call, so a PC decode is always the whole tree in one call.

``decode`` runs in the spans ``sc.prep``, ``sc.sweep`` and ``sc.select``,
as the SCL decoder's.
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
from polar_torch.utils import tracing

SCHEDULES = ("auto", "unrolled", "scan")


def pc_setup(pc_pos, info_pos, n: int, lower_stages):
    """``(pc_mask, info_idx, b)`` of a decoder with PC positions ``pc_pos``
    (``(None, info_pos, None)`` without): the [n] bool PC mask, the info
    positions less the PC ones (the decoder's output), and the subtree
    depth, log2(n), the whole tree in one kernel call. A position outside
    [0, n), a depth below log2(n) and n > 2^MAX_B raise; the schedules
    (``scan_core.leaf_schedule``, ``fast_schedule``) reject a frozen PC
    position."""
    if pc_pos is None:
        return None, info_pos, None
    S = n.bit_length() - 1
    if S > MAX_B:
        raise ValueError(f"PC-aided decoding runs the whole tree in one "
                         f"kernel call: n={n} > 2^{MAX_B}")
    if lower_stages is not None and int(lower_stages) != S:
        raise ValueError(f"PC-aided decoding runs the whole tree in one "
                         f"kernel call: lower_stages must be log2(n)={S}, "
                         f"not {lower_stages}")
    pc_pos = as_host_positions(pc_pos)
    if len(pc_pos) and (pc_pos.min() < 0 or pc_pos.max() >= n):
        raise ValueError(f"PC positions outside [0, {n})")
    pc_mask = np.zeros(n, dtype=bool)
    pc_mask[pc_pos] = True
    return pc_mask, np.setdiff1d(info_pos, pc_pos), S


class PolarSCDecoder:
    """SC decoder. ``__call__(llr_logits[..., n]) -> u_hat[..., k]``.

    ``schedule`` is taken for the JAX package's signature: every schedule
    gives the same bits, and the port has one. ``lower_stages`` is the
    subtree depth b (default ``scan_core.DEFAULT_SC_LOWER_STAGES``, clamped
    to [1, log2(n)]): one kernel call per 2^b-leaf subtree. ``pc_pos``
    (``pc_setup``) takes the PC positions out of ``k`` and the output and
    decodes at b = log2(n)."""

    def __init__(self, frozen_pos, n: int, mode: str = "minsum",
                 llr_max: float = 30.0, schedule: str = "auto",
                 pc_pos=None, output_dtype=torch.float32,
                 lower_stages=None, device=None):
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
        self._pc_mask, info_idx, pc_b = pc_setup(pc_pos, self.info_pos, n,
                                                 lower_stages)
        self.pc_pos = (None if pc_pos is None
                       else np.flatnonzero(self._pc_mask))
        self.k = len(info_idx)
        self.mode = mode
        self.llr_max = float(llr_max)
        self.schedule = schedule
        self.output_dtype = output_dtype
        self.lower_stages = resolve_lower_stages(
            n.bit_length() - 1, pc_b or lower_stages,
            DEFAULT_SC_LOWER_STAGES)
        if self.lower_stages > MAX_B:
            raise ValueError(f"subtree depth {self.lower_stages} > {MAX_B}")
        self._frozen_mask = np.zeros(n, dtype=bool)
        self._frozen_mask[self.frozen_pos] = True
        self._plan = plan_sc_sweep(self._frozen_mask, self.lower_stages,
                                   self.device, pc_mask=self._pc_mask)
        self._info_idx = torch.from_numpy(info_idx).to(self.device)

    def decode(self, llr_logits):
        """[bs, n] logits -> [bs, k] hard decisions."""
        with tracing.span("sc.prep"):
            llr_ch = (-llr_logits.to(torch.float32)).t().contiguous()
        with tracing.span("sc.sweep"):
            u = sc_sweep_hybrid(llr_ch, self._frozen_mask, mode=self.mode,
                                llr_max=self.llr_max,
                                lower_stages=self.lower_stages,
                                plan=self._plan)
        with tracing.span("sc.select"):
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
