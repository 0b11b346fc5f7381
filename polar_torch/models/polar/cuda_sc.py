"""The SC subtree: its hand-written CUDA kernel, the same routine's host
build, and its plain PyTorch version.

One call decodes one 2^b-leaf subtree of the SC sweep
(``scan_core.sc_sweep_hybrid``; with b = log2(n), the whole tree) for every
codeword of the batch: given the stage-b LLRs ``a`` [2^b, bs] f32 and the
subtree's op schedule, it returns the subtree codeword ``cw`` [2^b, bs]
int32. There is no list: no path metrics and no forks.

The schedule holds ``'z'`` rate-0 nodes (zero partial sums, no descent to
their root), ``'f'``/``'i'`` frozen/info leaves, ``'t'`` leaves whose
frozen-ness is read at run time from ``frz`` [2^b] int32 (the traced form),
and ``'p'`` parity-check leaves of PC-aided decoding. A PC schedule covers
the whole tree: the codeword's 5-bit PC register starts at zero, an info
leaf i XORs its bit into bit ``(i + 1) mod 5`` and a PC leaf i decides that
bit (the JAX package's rotating register, unrotated; ``cuda_scl``).
``scan_core.fast_schedule(mask, rep=False)`` gives the rate-0-pruned static
schedule, bit-identical to the plain sweep: an all-frozen span's partial
sums are zero whatever its LLRs.

* ``sc_subtree`` is the wrapper the sweep calls. A CUDA tensor goes through
  the kernel (``csrc/sc_subtree.cu``), a CPU tensor through the plain
  version; nothing falls back from one to the other. It runs in the span
  ``kernel.sc_subtree``, counts its launches in the tracing counter
  ``launch.sc_subtree`` and reports each launch's work to a running
  ``profiling.flop_estimate``.
* ``sc_subtree_plain`` repeats the computation with tensor ops.
* ``sc_subtree_host`` runs the kernel's per-codeword routine built for the
  CPU with g++, one thread looping over a codeword's lanes, so the tests
  can check the CUDA source's logic with any group size and split.

The kernel decodes a codeword with a group of ``lanes`` threads of one
warp (4..32; ``DEFAULT_LANES``), 128 threads a block. A stage's segment is
split across the group, with a group barrier after each stage. The
workspaces sit in shared memory as far as ``SMEM_BUDGET`` bytes a block
allow (``shared_stages``: stages from 0 up), the rest in a global scratch
that the wrapper allocates; the block reads ``a`` and writes ``cw``
through per-codeword tiles in shared memory.

Hard decisions take ``llr <= 0`` as bit 1. Min-sum f/g are exact in f32,
so kernel, host build and plain version agree bit for bit; the exact
boxplus rounds differently in ``log1pf``/``expf`` and ``torch.logaddexp``
and may flip a leaf whose LLR lies within rounding of 0.
"""

import ctypes
import functools

import torch

from polar_torch import _build
# traced_schedule is shared with the SCL kernel and re-exported here
from polar_torch.models.polar.cuda_scl import (
    MAX_B, PC_REGISTER, SubtreeSchedule, _ctz, _cto, traced_schedule)
from polar_torch.ops.fg import F_FUNCTIONS, f_exact, g as g_op
from polar_torch.utils import kernel_work, tracing

# op codes of csrc/sc_subtree.cuh (z/f/i as in the SCL kernel's table)
SC_KIND_CODES = {"z": 0, "f": 4, "i": 5, "t": 6, "p": 7}
LANES = (4, 8, 16, 32)          # group sizes the kernel is built for
SMEM_BUDGET = 48 * 1024         # dynamic shared memory a block may take
SMEM_LIMIT = 232448             # the opt-in limit of a block on sm_90


# lanes per codeword: the fastest group of the SC decode at b = 8 and 9 on
# an H100 (chip_smoke.py's sc_subtree launch survey): most of a decode's
# stages are narrow, and wider groups leave their lanes idle there
DEFAULT_LANES = 8


def block_smem_bytes(b: int, lanes: int, n_shared: int,
                     route: str = "cuda") -> int:
    """Dynamic shared memory of one block (128 / lanes codewords) with
    workspace stages 0..n_shared-1 in shared memory, as the kernel lays it
    out (``sc_smem_bytes`` in csrc/sc_subtree.cuh, asked of the
    ``route``'s build): the input and codeword tiles, 5 bytes a shared
    workspace row."""
    fn = _build.load("sc_subtree", route).sc_subtree_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return int(fn(b, lanes, n_shared))


@functools.lru_cache(maxsize=None)
def shared_stages(b: int, lanes: int, route: str = "cuda") -> int:
    """The most workspace stages (from stage 0 up) that fit
    ``SMEM_BUDGET`` bytes a block; the stages above go to a global
    scratch."""
    n = b
    while n > 0 and block_smem_bytes(b, lanes, n, route) > SMEM_BUDGET:
        n -= 1
    return n


def sc_schedule(ops, device) -> SubtreeSchedule:
    """An SC subtree's ops (kinds z/f/i/t/p) as a ``SubtreeSchedule``."""
    return SubtreeSchedule(ops, device, codes=SC_KIND_CODES)


# ----------------------------------------------------------------------
# the wrapper
# ----------------------------------------------------------------------
def sc_subtree(a, frz, sched: SubtreeSchedule, *, b: int, llr_max: float,
               mode: str, lanes=None, n_shared=None):
    """Decode one subtree; see the module docstring. ``frz`` is None
    unless the schedule has ``'t'`` ops. CUDA tensors launch the kernel
    (``lanes`` and ``n_shared`` override its group size and its shared
    workspace stages), CPU tensors run ``sc_subtree_plain``."""
    with tracing.span("kernel.sc_subtree"):
        if a.device.type == "cpu":
            return sc_subtree_plain(a, frz, sched.ops, b=b, llr_max=llr_max,
                                    mode=mode)
        if a.device.type != "cuda":
            raise ValueError(f"sc_subtree: unsupported device {a.device}")
        lib = _build.load("sc_subtree", "cuda")
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            out = _native_call(lib.sc_subtree_launch, a, frz, sched, b,
                               llr_max, mode, lanes, n_shared, "cuda", stream)
            tracing.count("launch.sc_subtree", ops=1)
        kernel_work.report(kernel_work.sc_subtree_work, sched.ops, b,
                           a.shape[1], mode)
        return out


def sc_subtree_host(a, frz, sched: SubtreeSchedule, *, b: int,
                    llr_max: float, mode: str, lanes=None, n_shared=None):
    """The kernel's per-codeword routine built for the CPU (g++), with the
    card's group size and split unless given; CPU tensors only. For tests:
    the main path never calls it."""
    if a.device.type != "cpu":
        raise ValueError("sc_subtree_host takes CPU tensors")
    lib = _build.load("sc_subtree", "host")
    return _native_call(lib.sc_subtree_host, a, frz, sched, b, llr_max,
                        mode, lanes, n_shared, "host", None)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_int, ctypes.c_int, ctypes.c_int]


def _native_call(fn, a, frz, sched, b, llr_max, mode, lanes, n_shared,
                 route, stream):
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
    lanes = DEFAULT_LANES if lanes is None else int(lanes)
    if lanes not in LANES:
        raise ValueError(f"lanes must be one of {LANES}")
    n_shared = (shared_stages(b, lanes, route) if n_shared is None
                else int(n_shared))
    if not 0 <= n_shared <= b:
        raise ValueError(f"n_shared={n_shared} not in [0, {b}]")
    if block_smem_bytes(b, lanes, n_shared, route) > SMEM_LIMIT:
        raise ValueError(f"b={b}, {lanes} lanes, {n_shared} shared stages: "
                         "a block does not fit shared memory")
    dev = a.device
    cw = torch.empty((w, bs), dtype=torch.int32, device=dev)
    # the global workspace stages n_shared..b-1, [bs, 2^b - 2^n_shared]
    g_rows = w - (1 << n_shared)
    lloc = uloc = None
    if g_rows and bs:
        lloc = torch.empty((bs, g_rows), dtype=torch.float32, device=dev)
        uloc = torch.empty((bs, g_rows), dtype=torch.int8, device=dev)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES + ([] if stream is None
                                   else [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    if bs == 0:
        return cw
    args = [a.data_ptr(), a.stride(0), frz_ptr, sched.table.data_ptr(),
            sched.table.shape[0], cw.data_ptr(),
            None if lloc is None else lloc.data_ptr(),
            None if uloc is None else uloc.data_ptr(), b, bs, float(llr_max),
            int(F_FUNCTIONS[mode] is f_exact), n_shared, lanes]
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
    sums waiting for their right sibling; ``y`` [bs] is the PC register
    when a ``'p'`` leaf reads it."""
    f = F_FUNCTIONS[mode]
    bs = a.shape[1]
    lloc = [None] * b + [a.to(torch.float32)]
    uloc = [None] * b
    cw = None
    y = (torch.zeros(bs, dtype=torch.int8, device=a.device)
         if any(k == "p" for k, _, _ in ops) else None)
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
            if y is not None:
                y = y ^ (ubit[0] << ((lo + 1) % PC_REGISTER))
        elif kind == "p":
            ubit = ((y >> ((lo + 1) % PC_REGISTER)) & 1)[None]
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
