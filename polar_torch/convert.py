"""Build the port's objects from state carried across from the JAX package.

The system has no weights: a code's frozen set and the decoder's options
are its whole state. ``from_numpy_state`` takes them as plain NumPy arrays
and scalars, so both packages decode the same code.
"""

import numpy as np
import torch

from polar_torch.models.osd import OSDecoder
from polar_torch.models.polar.bp import PolarBPDecoder
from polar_torch.models.polar.decode5g import Polar5GDecoder
from polar_torch.models.polar.dense import (DenseKernelDecoder,
                                            DenseKernelEncoder)
from polar_torch.models.polar.encode import Polar5GEncoder, PolarEncoder
from polar_torch.models.polar.sc import PolarSCDecoder
from polar_torch.models.polar.scl import PolarSCLDecoder
from polar_torch.models.systems import SystemAWGNModel, SystemBECModel

_CHANNELS = {"awgn": SystemAWGNModel, "bec": SystemBECModel}
_MSG_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _system(state: dict, n: int, k: int, encoder, decoder):
    """The link model of ``state["channel"]`` (``"awgn"``, the default, or
    ``"bec"``) around the code, with ``cw_estimates`` when given."""
    kind = state.get("channel", "awgn")
    if kind not in _CHANNELS:
        raise ValueError(f"unknown channel {kind!r}: 'awgn' or 'bec'")
    return _CHANNELS[kind](n, k, encoder, decoder,
                          cw_estimates=bool(state.get("cw_estimates",
                                                      False)))


def _osd_kwargs(state: dict) -> dict:
    return dict(t=int(state["osd_t"]),
                pattern_chunk=int(state.get("pattern_chunk", 4096)),
                llr_max=float(state.get("llr_max", 100.0)))


def from_numpy_state(state: dict, device=None):
    """The link model (with its ``encoder`` and ``decoder``) of ``state``:
    a ``SystemAWGNModel``, or with ``channel="bec"`` a ``SystemBECModel``;
    ``cw_estimates`` (default False) goes to either.

    A code given by its frozen set (``code`` absent or ``"polar"``) reads
    ``frozen_pos``, ``n``, ``k``, ``llr_max`` and ``decoder`` (``"scl"``,
    the default, ``"sc"``, ``"bp"`` or ``"osd"``), and ``mode`` for all
    but OSD. An OSD decoder reads ``osd_t`` and ``pattern_chunk`` (default
    4096) and returns codewords. An SCL decoder also
    reads ``list_size``, ``use_fast_scl`` (None or absent: the decoder's
    default by n), ``fast_rate1`` and ``spc_min_stage`` (None: no SPC). A
    BP decoder reads ``num_iter``, ``msf``, ``early_stop``,
    ``check_every`` and ``hard_out``, and ``two_pass``,
    ``first_pass_iters`` and ``msg_dtype`` (``"float32"``, the default, or
    ``"bfloat16"``) when given.

    A 5G NR code (``code="5g"``) reads ``k`` and ``n`` (the rate-matched
    targets), ``channel_type``, ``enable_pc``, ``dec_type`` (``"SC"``,
    ``"SCL"`` or ``"hybSCL"``), ``list_size``, ``mode`` and
    ``use_fast_scl``. The port builds the code itself; a ``frozen_pos``
    given beside them must equal the port's mother-code frozen set.

    A code over any kernel (``code="dense"``) reads ``kern`` (the kernel
    matrix), ``frozen_pos``, ``n``, ``k``, ``osd_t``, ``pattern_chunk``
    and ``llr_max``: the dense-G encoder and its OSD decoder."""
    code = state.get("code", "polar")
    if code == "5g":
        return _from_5g_state(state, device)
    if code not in ("polar", "dense"):
        raise ValueError(f"unknown code {code!r}: 'polar', '5g' or 'dense'")
    frozen = np.asarray(state["frozen_pos"], dtype=np.int64)
    n, k = int(state["n"]), int(state["k"])
    if n - len(frozen) != k:
        raise ValueError(f"frozen set of {len(frozen)} positions does not "
                         f"give k={k} at n={n}")
    if code == "dense":
        encoder = DenseKernelEncoder(frozen, n, np.asarray(state["kern"]),
                                     device=device)
        decoder = DenseKernelDecoder(encoder, **_osd_kwargs(state))
        return _system(state, n, k, encoder, decoder)
    kind = state.get("decoder", "scl")
    encoder = PolarEncoder(frozen, n, device=device)
    if kind == "osd":
        decoder = OSDecoder(encoder=encoder, **_osd_kwargs(state))
        return _system(state, n, k, encoder, decoder)
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
    elif kind == "bp":
        two_pass = bool(state.get("two_pass", False))
        msg = str(state.get("msg_dtype", "float32"))
        if msg not in _MSG_DTYPES:
            raise ValueError(f"unknown msg_dtype {msg!r}: 'float32' or "
                             "'bfloat16'")
        decoder = PolarBPDecoder(
            frozen, n, num_iter=int(state["num_iter"]),
            msf=float(state["msf"]), early_stop=bool(state["early_stop"]),
            check_every=int(state["check_every"]),
            hard_out=bool(state["hard_out"]), two_pass=two_pass,
            first_pass_iters=int(state.get("first_pass_iters", 8)),
            msg_dtype=_MSG_DTYPES[msg], **common)
    else:
        raise ValueError(f"unknown decoder {kind!r}: 'sc', 'scl', 'bp' or "
                         "'osd'")
    return _system(state, n, k, encoder, decoder)


def _from_5g_state(state: dict, device) -> SystemAWGNModel:
    k, n = int(state["k"]), int(state["n"])
    encoder = Polar5GEncoder(
        k, n, channel_type=state.get("channel_type", "uplink"),
        enable_pc=bool(state.get("enable_pc", True)), device=device)
    if state.get("frozen_pos") is not None:
        want = np.asarray(state["frozen_pos"], dtype=np.int64)
        if not np.array_equal(np.sort(want), encoder.frozen_pos):
            raise ValueError(f"frozen_pos differs from the port's 5G "
                             f"construction of k={k}, n={n}")
    fast = state.get("use_fast_scl")
    decoder = Polar5GDecoder(
        encoder, dec_type=state.get("dec_type", "SCL"),
        list_size=int(state.get("list_size", 8)),
        mode=state.get("mode", "minsum"),
        use_fast_scl=None if fast is None else bool(fast))
    return _system(state, n, k, encoder, decoder)
