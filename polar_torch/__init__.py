"""polar_torch: the PyTorch and CUDA port of polar_tpu.

This slice carries the SCL-8 fast-SCL chain: binary source -> polar encoder
on a 5G-ranked code -> QPSK mapper -> AWGN -> exact demapper -> fast-SCL
list decoder (rate-0, repetition, rate-1 and optional SPC nodes) -> error
counters. The decoder's subtree runs in a hand-written CUDA kernel on the
card (``models/polar/cuda_scl.py``, ``csrc/scl_subtree.cu``).

Entry points run on ``device="cuda"`` by default and raise when no card is
present; pass ``device="cpu"`` to run the plain PyTorch versions.
"""

from polar_torch.ops.ebno import ebnodb2no
from polar_torch.ops.source import binary_source
from polar_torch.ops.mapping import (Constellation, Demapper, Mapper,
                                     SymbolLogits2LLRs)
from polar_torch.ops.channels import AWGN, complex_normal
from polar_torch.models.polar.construction import (generate_5g_ranking,
                                                   info_positions)
from polar_torch.models.polar.encode import PolarEncoder
from polar_torch.models.polar.scl import PolarSCLDecoder
from polar_torch.models.systems import SystemAWGNModel
from polar_torch.sim import count_block_errors, count_errors
from polar_torch.convert import from_numpy_state

__all__ = [
    "ebnodb2no", "binary_source", "Constellation", "Demapper", "Mapper",
    "SymbolLogits2LLRs", "AWGN", "complex_normal", "generate_5g_ranking",
    "info_positions", "PolarEncoder", "PolarSCLDecoder", "SystemAWGNModel",
    "count_block_errors", "count_errors", "from_numpy_state",
]
