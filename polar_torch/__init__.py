"""polar_torch: the PyTorch and CUDA port of polar_tpu.

It carries four paths:

* the SCL-8 fast-SCL chain: binary source -> polar encoder on a 5G-ranked
  code -> QPSK mapper -> AWGN -> exact demapper -> fast-SCL list decoder
  (rate-0, repetition, rate-1 and optional SPC nodes) -> error counters;
* the CLI sweep (``python -m polar_torch.main``): BER/BLER curves of the SC
  decoder against the SCL decoder (the plain sweep from n = 256 up) through
  the Monte-Carlo harness ``sim_ber`` and ``PlotBER``;
* the 5G NR CA-SCL chain: ``Polar5GEncoder`` (CRC, rate matching, PC bits)
  -> QPSK -> AWGN -> demapper -> ``Polar5GDecoder`` (SC, CA-SCL or hybrid
  SC/CA-SCL, lists of up to 32) -> CRC check;
* the BP decoder (``--algos [scl,bp]`` in the CLI): scaled min-sum belief
  propagation with G-matrix early stop and a two-pass serving path, its
  message lattice in f32 or bf16;
* codes over any kernel of the zoo (``--kern`` in the CLI): the dense-G
  encoder with ordered-statistics decoding (``models/osd.py``), and OSD
  on its own for any polar code;
* the binary erasure and symmetric channels and the BEC link
  (``SystemBECModel``), with the ``rm-ref`` and GA constructions.

The decoders' subtrees run in hand-written CUDA kernels on the card
(``models/polar/cuda_scl.py`` with ``csrc/scl_subtree.cu`` for SCL, static
and traced forms, L up to 32; ``models/polar/cuda_sc.py`` with
``csrc/sc_subtree.cu`` for SC); the whole BP decode is one kernel
(``models/polar/cuda_bp.py`` with ``csrc/bp.cu``). OSD and the dense-G
chain run in torch ops.

Entry points run on ``device="cuda"`` by default and raise when no card is
present; pass ``device="cpu"`` to run the plain PyTorch versions.

The public names are the JAX package's (``polar_tpu.__all__``), its
reference-compatible aliases (``SC_Dec``, ``System_AWGN_model``, ...)
included, plus the port's own.
"""

from polar_torch.ops.ebno import ebnodb2no
from polar_torch.ops.source import BinarySource, binary_source
from polar_torch.ops.mapping import (Constellation, Demapper, Mapper,
                                     QamConstell, SymbolLogits2LLRs)
from polar_torch.ops.channels import (AWGN, BinaryErasureChannel,
                                      BinaryMemorylessChannel,
                                      BinarySymmetricChannel, complex_normal)
from polar_torch.models.polar.construction import (
    ARIKAN_F2, gen_arikan, generate_5g_ranking, generate_ga_code,
    generate_rm_code, get_kern_frozen_bits, get_ref_rm_frozen_bits,
    info_positions)
from polar_torch.models.polar.kernels import KERNELS, get_kernel
from polar_torch.models.polar.encode import Polar5GEncoder, PolarEncoder
from polar_torch.models.polar.sc import PolarSCDecoder
from polar_torch.models.polar.scl import PolarSCLDecoder
from polar_torch.models.polar.hybrid import HybridSCLDecoder
from polar_torch.models.polar.decode5g import Polar5GDecoder
from polar_torch.models.polar.bp import PolarBPDecoder
from polar_torch.models.polar.dense import (DenseKernelDecoder,
                                            DenseKernelEncoder, gf2_inv)
from polar_torch.models.osd import OSDecoder
from polar_torch.models.no_code import NoDecoder, NoEncoder
from polar_torch.ops.crc import CRCDecoder, CRCEncoder
from polar_torch.models.systems import SystemAWGNModel, SystemBECModel
from polar_torch.sim import (count_block_errors, count_errors,
                             hard_decisions, sim_ber)
from polar_torch.plotting import PlotBER
from polar_torch.config import PolarConfig
from polar_torch.convert import from_numpy_state

# reference-compatible aliases, as the JAX package exports them
SC_Dec = PolarSCDecoder
SCL_Dec = PolarSCLDecoder
System_AWGN_model = SystemAWGNModel
System_BEC_model = SystemBECModel
no_encoder = NoEncoder
no_decoder = NoDecoder

__version__ = "0.1.0"

__all__ = [
    "ebnodb2no", "binary_source", "BinarySource", "Constellation",
    "QamConstell", "Demapper", "Mapper", "SymbolLogits2LLRs", "AWGN",
    "complex_normal", "BinaryMemorylessChannel", "BinaryErasureChannel",
    "BinarySymmetricChannel", "ARIKAN_F2", "gen_arikan",
    "generate_5g_ranking", "generate_ga_code", "generate_rm_code",
    "get_kern_frozen_bits", "get_ref_rm_frozen_bits", "info_positions",
    "KERNELS", "get_kernel", "PolarEncoder", "Polar5GEncoder",
    "PolarSCDecoder", "PolarSCLDecoder", "HybridSCLDecoder",
    "Polar5GDecoder", "PolarBPDecoder", "DenseKernelEncoder",
    "DenseKernelDecoder", "gf2_inv", "OSDecoder", "NoEncoder", "NoDecoder",
    "CRCEncoder", "CRCDecoder", "SystemAWGNModel", "SystemBECModel",
    "count_block_errors", "count_errors", "hard_decisions", "sim_ber",
    "PlotBER", "PolarConfig", "from_numpy_state",
    "SC_Dec", "SCL_Dec", "System_AWGN_model", "System_BEC_model",
    "no_encoder", "no_decoder",
]
