"""The plain polar transmitter over QPSK and AWGN as one hand-written CUDA
kernel: the scatter of the info bits, the polar transform, the Gray QPSK
map, the noise and the exact demapper after torch's draws; the same
routine's host build; its plain PyTorch version; and the rule that says
where a chain takes it.

``qpsk_front(bits, xr, xi, table, a, no)`` takes the info bits ``bits``
[bs, k] f32 (0 or 1), the real and imaginary noise draws ``xr``, ``xi``
[bs, n / 2] f32 (``channels.normal_parts``), the encoder's gather table
``table`` [n] int16 (``PolarEncoder.transmit_table``), the QPSK amplitude
``a`` (``qpsk_amplitude``) and the noise variance ``no`` (a host scalar),
and returns ``(codewords, llr)`` [bs, n] f32, bit for bit what the
composed chain (``PolarEncoder``, ``Mapper``, ``AWGN``, ``Demapper``) gives
on the same draws: ``x = (1 - 2 c) a``, ``y = x + (sqrt(0.5) r) sqrt(no)``,
``llr = (-4 sqrt(0.5) / no) y``, each product and sum rounded to f32 on its
own, bit 2j of a codeword on the real axis of symbol j. The scalars are
computed on the host as the composed chain computes them
(``transmit_scalars``).

* ``qpsk_front`` is the wrapper the chain calls. A CUDA tensor goes
  through the kernel (``csrc/qpsk_front.cu``), a CPU tensor through the
  plain version; nothing falls back from one to the other. It runs in the
  span ``kernel.qpsk_front``, counts its launches in the tracing counter
  ``launch.qpsk_front`` (one device operation each), and reports each
  launch's work to a running ``profiling.flop_estimate``.
* The kernel keeps a codeword in registers from the scatter to the LLRs,
  32 positions a word, a warp a codeword at n = 1024, and reads the bits
  and draws and writes the codewords and LLRs once each: bytes bound it
  (``csrc/qpsk_front.cuh`` and ``qpsk_front.cu`` give the details).
* ``qpsk_front_host`` runs the kernel's routines built for the CPU with
  g++, so the tests can check the CUDA source's logic.
* ``transmit_plan(encoder, constell, device)`` is the rule: the kernel
  computes a chain's front end where the encoder is a plain scatter then
  the transform (its ``transmit_table`` is not None: a ``PolarEncoder``,
  not a ``Polar5GEncoder`` or a dense-G encoder), its dtype is f32, the
  constellation is the normalised Gray QPSK, the device is a card and
  2 <= n <= ``MAX_N``. ``SystemAWGNModel`` applies it once, when it is
  built.
"""

import ctypes

import numpy as np
import torch

from polar_torch import _build
from polar_torch.ops.butterfly import polar_transform
from polar_torch.ops.channels import normal_std
from polar_torch.ops.mapping import QPSK_LLR_GAIN
from polar_torch.utils import kernel_work, tracing

MAX_N = 4096        # 2^kQfMaxM in csrc/qpsk_front.cuh

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int] + [ctypes.c_float] * 4


def qpsk_amplitude(constell):
    """``a`` where ``constell`` is the Gray QPSK whose point of label
    ``2 b0 + b1`` is ``(1 - 2 b0) a + j (1 - 2 b1) a``, as ``Mapper`` reads
    it, else None."""
    if constell.n_bits_per_sym != 2:
        return None
    pts = constell.points_np
    a = pts[0].real
    if not (np.array_equal(pts.real, a * np.array([1, 1, -1, -1], np.float32))
            and np.array_equal(pts.imag,
                               a * np.array([1, -1, 1, -1], np.float32))):
        return None
    return float(a)


def transmit_plan(encoder, constell, device):
    """``(table, a)`` where the QPSK transmitter kernel computes the front
    end of a chain of ``encoder`` and ``constell`` on ``device``, else None;
    see the module docstring."""
    table_of = getattr(encoder, "transmit_table", None)
    if (torch.device(device).type != "cuda" or table_of is None
            or encoder.dtype != torch.float32
            or not 2 <= encoder.n <= MAX_N):
        return None
    a = qpsk_amplitude(constell)
    table = table_of()
    if a is None or table is None:
        return None
    return table, a


def transmit_scalars(no):
    """``(sqrt(0.5), sqrt(no), -4 sqrt(0.5) / no)`` as f32 host tensors,
    each computed as ``AWGN`` and ``Demapper`` compute it."""
    no = torch.as_tensor(no, dtype=torch.float32, device="cpu")
    if no.numel() != 1:
        raise ValueError("qpsk_front takes one noise variance")
    no = no.reshape(())
    return (normal_std(), no.sqrt(),
            torch.tensor(QPSK_LLR_GAIN, dtype=torch.float32) / no)


def _check(bits, xr, xi, table):
    """n of valid inputs; raises on any other."""
    for name, x in (("bits", bits), ("xr", xr), ("xi", xi)):
        if x.dtype != torch.float32:
            raise TypeError(f"qpsk_front: {name} must be float32, not "
                            f"{x.dtype}")
    if table.dtype != torch.int16 or table.dim() != 1:
        raise TypeError("qpsk_front: table must be int16 [n]")
    n = table.shape[0]
    if n & (n - 1) or not 2 <= n <= MAX_N:
        raise ValueError(f"qpsk_front: n={n}; need a power of 2 in "
                         f"[2, {MAX_N}]")
    if bits.dim() != 2 or xr.shape != (bits.shape[0], n // 2) \
            or xi.shape != xr.shape:
        raise ValueError(f"qpsk_front: bits [bs, k] and draws [bs, {n // 2}],"
                         f" not {tuple(bits.shape)}, {tuple(xr.shape)}, "
                         f"{tuple(xi.shape)}")
    if len({x.device for x in (bits, xr, xi, table)}) != 1:
        raise ValueError("qpsk_front: inputs on different devices")
    if not all(x.is_contiguous() for x in (bits, xr, xi, table)):
        raise ValueError("qpsk_front: inputs must be contiguous")
    if any(x.data_ptr() % 16 for x in (xr, xi)):
        raise ValueError("qpsk_front: the draws must be 16-byte aligned")
    return n


def qpsk_front(bits, xr, xi, table, a, no):
    """``(codewords, llr)`` of the plain polar transmitter; see the module
    docstring. CUDA tensors launch the kernel, CPU tensors run
    ``qpsk_front_plain``."""
    with tracing.span("kernel.qpsk_front"):
        n = _check(bits, xr, xi, table)
        if bits.device.type == "cpu":
            return qpsk_front_plain(bits, xr, xi, table, a, no)
        if bits.device.type != "cuda":
            raise ValueError(f"qpsk_front: unsupported device {bits.device}")
        lib = _build.load("qpsk_front", "cuda")
        with torch.cuda.device(bits.device):
            stream = torch.cuda.current_stream(bits.device).cuda_stream
            out = _native_call(lib.qpsk_front_launch, bits, xr, xi, table, a,
                               no, n, stream)
            tracing.count("launch.qpsk_front", ops=1)
        kernel_work.report(kernel_work.qpsk_front_work, bits.shape[0],
                           bits.shape[1], n)
        return out


def qpsk_front_plain(bits, xr, xi, table, a, no):
    """The plain version, on any device: the composed chain's ops on these
    draws (``PolarEncoder``'s scatter and transform, ``Mapper``'s point,
    ``AWGN``'s noise, ``Demapper``'s QPSK LLR), in its roundings."""
    n = table.shape[0]
    s2, sqrt_no, scale = (v.to(bits.device) for v in transmit_scalars(no))
    u = torch.cat([bits, bits.new_zeros(bits.shape[:-1] + (1,))], dim=-1)
    cw = polar_transform(u[..., table.long()]).to(torch.float32)
    sign = 1.0 - 2.0 * cw.reshape(-1, n // 2, 2)
    x = torch.complex(sign[..., 0] * a, sign[..., 1] * a)
    y = x + torch.complex(s2 * xr, s2 * xi) * sqrt_no
    llr = torch.stack([scale * y.real, scale * y.imag], dim=-1)
    return cw, llr.reshape(cw.shape)


def qpsk_front_host(bits, xr, xi, table, a, no):
    """The kernel's routines built for the CPU (g++); CPU tensors only. For
    tests: the main path never calls it."""
    n = _check(bits, xr, xi, table)
    if bits.device.type != "cpu":
        raise ValueError("qpsk_front_host takes CPU tensors")
    lib = _build.load("qpsk_front", "host")
    return _native_call(lib.qpsk_front_host, bits, xr, xi, table, a, no, n,
                        None)


def _native_call(fn, bits, xr, xi, table, a, no, n, stream):
    bs, k = bits.shape
    s2, sqrt_no, scale = (float(v) for v in transmit_scalars(no))
    cw = torch.empty((bs, n), dtype=torch.float32, device=bits.device)
    llr = torch.empty_like(cw)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES + ([] if stream is None
                                   else [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    args = [bits.data_ptr(), table.data_ptr(), xr.data_ptr(), xi.data_ptr(),
            cw.data_ptr(), llr.data_ptr(), bs, k, n.bit_length() - 1,
            a, s2, sqrt_no, scale]
    rc = fn(*args) if stream is None else fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"qpsk_front: native call failed with code {rc}")
    return cw, llr
