"""Build the port's objects from state carried across from the JAX package.

The system has no weights: a code's frozen set and the decoder's options
are its whole state. ``from_numpy_state`` takes them as plain NumPy arrays
and scalars, so both packages decode the same code.
"""

import numpy as np

from polar_torch.models.polar.encode import PolarEncoder
from polar_torch.models.polar.scl import PolarSCLDecoder
from polar_torch.models.systems import SystemAWGNModel


def from_numpy_state(state: dict, device=None) -> SystemAWGNModel:
    """``SystemAWGNModel`` (with its ``encoder`` and ``decoder``) from
    ``state`` keys ``frozen_pos``, ``n``, ``k``, ``list_size``, ``mode``,
    ``llr_max``, ``fast_rate1`` and ``spc_min_stage`` (None: no SPC)."""
    frozen = np.asarray(state["frozen_pos"], dtype=np.int64)
    n, k = int(state["n"]), int(state["k"])
    if n - len(frozen) != k:
        raise ValueError(f"frozen set of {len(frozen)} positions does not "
                         f"give k={k} at n={n}")
    spc = state.get("spc_min_stage")
    encoder = PolarEncoder(frozen, n, device=device)
    decoder = PolarSCLDecoder(
        frozen, n, list_size=int(state["list_size"]), mode=state["mode"],
        llr_max=float(state["llr_max"]),
        fast_rate1=bool(state["fast_rate1"]),
        spc_min_stage=None if spc is None else int(spc), device=device)
    return SystemAWGNModel(n, k, encoder, decoder)
