"""Build the port's objects from state carried across from the JAX package.

The system has no weights: a code's frozen set and the decoder's options
are its whole state. ``from_numpy_state`` takes them as plain NumPy arrays
and scalars, so both packages decode the same code.
"""

import numpy as np

from polar_torch.models.polar.encode import PolarEncoder
from polar_torch.models.polar.sc import PolarSCDecoder
from polar_torch.models.polar.scl import PolarSCLDecoder
from polar_torch.models.systems import SystemAWGNModel


def from_numpy_state(state: dict, device=None) -> SystemAWGNModel:
    """``SystemAWGNModel`` (with its ``encoder`` and ``decoder``) from
    ``state`` keys ``frozen_pos``, ``n``, ``k``, ``mode``, ``llr_max`` and
    ``decoder`` (``"scl"``, the default, or ``"sc"``). An SCL decoder also
    reads ``list_size``, ``use_fast_scl`` (None or absent: the decoder's
    default by n), ``fast_rate1`` and ``spc_min_stage`` (None: no SPC)."""
    frozen = np.asarray(state["frozen_pos"], dtype=np.int64)
    n, k = int(state["n"]), int(state["k"])
    if n - len(frozen) != k:
        raise ValueError(f"frozen set of {len(frozen)} positions does not "
                         f"give k={k} at n={n}")
    kind = state.get("decoder", "scl")
    encoder = PolarEncoder(frozen, n, device=device)
    common = dict(mode=state["mode"], llr_max=float(state["llr_max"]),
                  device=device)
    if kind == "sc":
        decoder = PolarSCDecoder(frozen, n, **common)
    elif kind == "scl":
        spc = state.get("spc_min_stage")
        fast = state.get("use_fast_scl")
        decoder = PolarSCLDecoder(
            frozen, n, list_size=int(state["list_size"]),
            use_fast_scl=None if fast is None else bool(fast),
            fast_rate1=bool(state["fast_rate1"]),
            spc_min_stage=None if spc is None else int(spc), **common)
    else:
        raise ValueError(f"unknown decoder {kind!r}: 'sc' or 'scl'")
    return SystemAWGNModel(n, k, encoder, decoder)
