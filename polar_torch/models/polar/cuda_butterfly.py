"""The SCL sweep's closing polar transform: its hand-written CUDA kernel,
the same routine's host build, and its plain PyTorch version.

``butterfly_rows(x)`` takes ``x`` [m, w, C] int32 or int8 (w = 2^b,
1 <= b <= ``MAX_B``, unit stride along C) and returns ``u`` [m, w, C] int8,
the polar transform along w of bit 0 of ``x``: bit for bit
``polar_transform(x.to(torch.int8) & 1, axis=1)``. The sweep
(``scan_core.scl_sweep_hybrid_fast``) gives it the survivor codewords,
[1, 2^b, L * bs] int32 as the subtree kernel wrote them when one subtree is
the whole tree, else the m subtrees' int8 codewords stacked.

* ``butterfly_rows`` is the wrapper the sweep calls. A CUDA tensor goes
  through the kernel (``csrc/butterfly.cu``), a CPU tensor through the
  plain version; nothing falls back from one to the other. It runs in the
  span ``kernel.butterfly_rows`` and counts its launches in the tracing
  counter ``launch.butterfly_rows`` (one device operation each), and
  reports each launch's work to a running ``profiling.flop_estimate``.
* The kernel cuts each column into slices of up to 128 rows and runs one
  thread a slice: it reads the slice's elements once, packs their bits 32
  rows to a word, runs the slice's butterfly on the words in registers,
  and the slices of one column, threads of one block, trade their words
  once through shared memory for the stages across slices; then each
  decision is written once (``csrc/butterfly.cuh`` and ``butterfly.cu``
  give the details). It moves 5 bytes an element from int32 input, 2 from
  int8, and does little else, so bytes bound it.
* ``butterfly_rows_host`` runs the kernel's per-slice routines built for
  the CPU with g++, so the tests can check the CUDA source's logic.
"""

import ctypes

import torch

from polar_torch import _build
from polar_torch.ops.butterfly import polar_transform
from polar_torch.utils import kernel_work, tracing

MAX_B = 12          # kBflyMaxB in csrc/butterfly.cuh
ELEMENT_BYTES = {torch.int32: 4, torch.int8: 1}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong]


def _check(x) -> int:
    """b of a valid input; raises on any other."""
    if x.dtype not in ELEMENT_BYTES:
        raise TypeError(f"butterfly_rows takes int32 or int8, not {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"butterfly_rows takes [m, w, C], not a tensor of "
                         f"shape {tuple(x.shape)}")
    m, w, C = x.shape
    b = w.bit_length() - 1
    if w != 1 << b or not 1 <= b <= MAX_B:
        raise ValueError(f"w={w} rows; need 2^b with 1 <= b <= {MAX_B}")
    if C > 1 and x.stride(2) != 1:
        raise ValueError("x must have unit stride along C")
    return b


def butterfly_rows(x):
    """The polar transform along dim 1 of bit 0 of ``x`` [m, w, C]; see the
    module docstring. CUDA tensors launch the kernel, CPU tensors run
    ``butterfly_rows_plain``."""
    with tracing.span("kernel.butterfly_rows"):
        b = _check(x)
        if x.device.type == "cpu":
            return butterfly_rows_plain(x)
        if x.device.type != "cuda":
            raise ValueError(f"butterfly_rows: unsupported device {x.device}")
        lib = _build.load("butterfly", "cuda")
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            u = _native_call(lib.butterfly_rows_launch, x, b, stream)
            tracing.count("launch.butterfly_rows", ops=1)
        kernel_work.report(kernel_work.butterfly_work, x)
        return u


def butterfly_rows_plain(x):
    """The plain version, on any device."""
    return polar_transform(x.to(torch.int8) & 1, axis=1)


def butterfly_rows_host(x):
    """The kernel's per-slice routines built for the CPU (g++); CPU tensors
    only. For tests: the main path never calls it."""
    b = _check(x)
    if x.device.type != "cpu":
        raise ValueError("butterfly_rows_host takes CPU tensors")
    lib = _build.load("butterfly", "host")
    return _native_call(lib.butterfly_rows_host, x, b, None)


def _native_call(fn, x, b, stream):
    m, w, C = x.shape
    if m > 65535:
        raise ValueError(f"m={m} blocks; the kernel takes at most 65535")
    u = torch.empty((m, w, C), dtype=torch.int8, device=x.device)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES + ([] if stream is None
                                   else [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    args = [x.data_ptr(), ELEMENT_BYTES[x.dtype], x.stride(0), x.stride(1),
            u.data_ptr(), m, b, C]
    rc = fn(*args) if stream is None else fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"butterfly_rows: native call failed with code "
                           f"{rc}")
    return u
