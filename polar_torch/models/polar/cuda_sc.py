"""The SC subtree: its hand-written CUDA kernel, the same routine's host
build, and its plain PyTorch version.

One call decodes one 2^b-leaf subtree of the SC sweep
(``scan_core.sc_sweep_hybrid``; with b = log2(n), the whole tree) for every
codeword of the batch: given the stage-b LLRs ``a`` [2^b, bs] f32 and the
subtree's op schedule, it returns the subtree codeword ``cw`` [2^b, bs]
int32. There is no list: no path metrics and no forks.

The schedule holds ``'z'`` rate-0 nodes (zero partial sums, no descent to
their root), ``'f'``/``'i'`` frozen/info leaves, and ``'t'`` leaves whose
frozen-ness is read at run time from ``frz`` [2^b] int32 (the traced form).
``scan_core.fast_schedule(mask, rep=False)`` gives the rate-0-pruned static
schedule, bit-identical to the plain sweep: an all-frozen span's partial
sums are zero whatever its LLRs.

* ``sc_subtree`` is the wrapper the sweep calls. A CUDA tensor goes through
  the kernel (``csrc/sc_subtree.cu``), a CPU tensor through the plain
  version; nothing falls back from one to the other.
* ``sc_subtree_plain`` repeats the computation with tensor ops.
* ``sc_subtree_host`` runs the kernel's per-codeword routine built for the
  CPU with g++, so the tests can check the CUDA source's logic.

Hard decisions take ``llr <= 0`` as bit 1. Min-sum f/g are exact in f32,
so kernel, host build and plain version agree bit for bit; the exact
boxplus rounds differently in ``log1pf``/``expf`` and ``torch.logaddexp``
and may flip a leaf whose LLR lies within rounding of 0.
"""

import ctypes

import torch

from polar_torch import _build
# traced_schedule is shared with the SCL kernel and re-exported here
from polar_torch.models.polar.cuda_scl import (MAX_B, SubtreeSchedule, _ctz,
                                               _cto, traced_schedule)
from polar_torch.ops.fg import F_FUNCTIONS, f_exact, g as g_op

# op codes of csrc/sc_subtree.cuh (z/f/i as in the SCL kernel's table)
SC_KIND_CODES = {"z": 0, "f": 4, "i": 5, "t": 6}


def sc_schedule(ops, device) -> SubtreeSchedule:
    """An SC subtree's ops (kinds z/f/i/t) as a ``SubtreeSchedule``."""
    return SubtreeSchedule(ops, device, codes=SC_KIND_CODES)


# ----------------------------------------------------------------------
# the wrapper
# ----------------------------------------------------------------------
def sc_subtree(a, frz, sched: SubtreeSchedule, *, b: int, llr_max: float,
               mode: str):
    """Decode one subtree; see the module docstring. ``frz`` is None
    unless the schedule has ``'t'`` ops. CUDA tensors launch the kernel,
    CPU tensors run ``sc_subtree_plain``."""
    if a.device.type == "cpu":
        return sc_subtree_plain(a, frz, sched.ops, b=b, llr_max=llr_max,
                                mode=mode)
    if a.device.type != "cuda":
        raise ValueError(f"sc_subtree: unsupported device {a.device}")
    lib = _build.load("sc_subtree", "cuda")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        out = _native_call(lib.sc_subtree_launch, a, frz, sched, b, llr_max,
                           mode, stream)
        sc_subtree.launches += 1
    return out


sc_subtree.launches = 0


def sc_subtree_host(a, frz, sched: SubtreeSchedule, *, b: int,
                    llr_max: float, mode: str):
    """The kernel's per-codeword routine built for the CPU (g++); CPU
    tensors only. For tests: the main path never calls it."""
    if a.device.type != "cpu":
        raise ValueError("sc_subtree_host takes CPU tensors")
    lib = _build.load("sc_subtree", "host")
    return _native_call(lib.sc_subtree_host, a, frz, sched, b, llr_max,
                        mode, None)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_int]


def _native_call(fn, a, frz, sched, b, llr_max, mode, stream):
    if a.dim() != 2 or a.dtype != torch.float32:
        raise TypeError("sc_subtree takes f32 LLRs of shape [2^b, bs]")
    w, bs = a.shape
    if w != 1 << b or not 1 <= b <= MAX_B or sched.span != w:
        raise ValueError(f"a has {w} rows and the schedule {sched.span} "
                         f"leaves; need 2^b of both with 1 <= b <= {MAX_B} "
                         f"(b={b})")
    if a.stride(1) != 1 and bs > 1:
        raise ValueError("a must have unit stride along the batch")
    if mode not in F_FUNCTIONS:
        raise ValueError(f"unknown mode {mode!r}")
    if sched.table.device != a.device:
        raise ValueError("a and the schedule table must share a device")
    frz_ptr = None
    if sched.traced:
        if (frz is None or frz.dtype != torch.int32
                or tuple(frz.shape) != (w,) or frz.device != a.device):
            raise ValueError(f"'t' ops need frz, an int32 [{w}] tensor on "
                             f"{a.device}")
        frz = frz.contiguous()
        frz_ptr = frz.data_ptr()
    dev = a.device
    cw = torch.empty((w, bs), dtype=torch.int32, device=dev)
    lloc = torch.empty((w - 1, bs), dtype=torch.float32, device=dev)
    uloc = torch.empty((w - 1, bs), dtype=torch.int8, device=dev)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES + ([] if stream is None
                                   else [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    args = [a.data_ptr(), a.stride(0), frz_ptr, sched.table.data_ptr(),
            sched.table.shape[0], cw.data_ptr(), lloc.data_ptr(),
            uloc.data_ptr(), b, bs, float(llr_max),
            int(F_FUNCTIONS[mode] is f_exact)]
    rc = fn(*args) if stream is None else fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"sc_subtree: native call failed with code {rc}")
    return cw


# ----------------------------------------------------------------------
# the plain version
# ----------------------------------------------------------------------
def sc_subtree_plain(a, frz, ops, *, b: int, llr_max: float, mode: str):
    """Plain PyTorch SC subtree decode on any device; ``ops`` is the op
    list of a ``SubtreeSchedule``. Stage values are kept per stage:
    ``lloc[s]`` [2^s, bs] (stage b is the input), ``uloc[s]`` the partial
    sums waiting for their right sibling."""
    f = F_FUNCTIONS[mode]
    bs = a.shape[1]
    lloc = [None] * b + [a.to(torch.float32)]
    uloc = [None] * b
    cw = None
    for kind, s_nd, lo in ops:
        w_nd = 1 << s_nd
        # ---- descent: to the root, or for 'z' to one stage above it ----
        stop = s_nd + 1 if kind == "z" else s_nd
        d, cur = b, lloc[b]
        if lo:
            d = _ctz(lo)
            if d >= stop:
                seg, h = lloc[d + 1], 1 << d
                cur = lloc[d] = g_op(seg[:h], seg[h:], uloc[d])
        for s in range(d, stop, -1):
            h = 1 << (s - 1)
            cur = lloc[s - 1] = f(cur[:h], cur[h:], llr_max)
        # ---- node ----
        if kind in ("z", "f"):
            ubit = torch.zeros((w_nd, bs), dtype=torch.int8, device=a.device)
        elif kind == "i":
            ubit = (cur <= 0).to(torch.int8)
        elif kind == "t":
            ubit = ((cur <= 0) & (frz[lo] == 0)).to(torch.int8)
        else:
            raise ValueError(f"unknown op kind {kind!r}")
        # ---- rise ----
        r = _cto(lo + w_nd - 1)
        for s in range(s_nd, min(r, b)):
            ubit = torch.cat([uloc[s] ^ ubit, ubit], dim=0)
        if r >= b:
            cw = ubit
        else:
            uloc[r] = ubit
    return cw.to(torch.int32)
