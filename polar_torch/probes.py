"""The probe kernels: hand-written CUDA counterparts of the eleven Pallas
kernels of ``benchmarks/probe_r4.py``, its ``mini:<variant>`` and ``bf16``
steps, each of which isolates one construct of a decoder kernel:

* ``sweepcombo``, ``bigsweep``, ``bigsweep_noloop``: a BP-style min-sum
  stage sweep over a scratch (``k_sweepcombo``, ``k_big``);
* ``gather``: a row gather by pointers, as the path pointers of SCL do
  (``k_gather``);
* ``arith``, ``int8``: a bf16 and an int8 datapath (``k_arith``, ``k_i8``);
* ``fori``, ``scratchfori``, ``roll``, ``reduce``, ``shift``, ``bcast``:
  loops, rolls, reductions, row-bit selects and a constant-index block.

No path of the system runs them; their times against their bounds give the
card's cost of each construct alone.

    python -m polar_torch.probes                      # every step, the card
    python -m polar_torch.probes mini:bigsweep bf16   # the named steps
    python -m polar_torch.probes --device cpu         # the plain versions
    python -m polar_torch.probes --split              # a launch's host time

Each step prints one JSON line: the step, the card's name and power limit,
and per probe the card's ms per launch (CUDA events; null on the CPU), the
elements whose bits differ from the plain version, the largest absolute
difference and the bound. A failure
or a differing element exits non-zero. ``--split`` prints instead what one
call of the ``gather`` and ``reduce`` wrappers spends on the card's host,
piece by piece (``launch_split``).

* Each probe's wrapper (``fori``, ``bcast``, ..., ``int8``, also in
  ``WRAPPERS``) launches the kernel (``csrc/probes.cu``) on a CUDA tensor
  and runs the plain version on a CPU one; nothing falls back from one to
  the other. It runs in the span ``kernel.probe.<name>``, counts its
  launches in the tracing counter ``launch.probe.<name>``
  (``launch_counts``, ``reset_launch_counts``) and reports each launch's
  work to a running ``profiling.flop_estimate``.
* ``<name>_plain`` is the plain PyTorch version, on any device. It rounds
  as the JAX package's kernel does on the CPU (in interpret mode): the
  five adds of ``k_fori`` in order (``6 x`` rounds differently),
  ``k_scratchfori``'s ``scr * 1.5 + x`` rounded once (XLA fuses it:
  ``ops/fg.fma_f32``, ``fmaf`` in the kernel), ``jnp.sign``'s signed
  zeros and NaN.
* ``probe_host`` runs the kernels' routines built for the CPU with g++.

The f32 probes take ``[64, 128 g]`` f32 (the script's ``[64, 512]`` runs a
grid of four 128-column blocks); ``bcast`` writes twice block 0 into every
block, as its constant index map reads it. ``arith`` takes bf16, ``gather``
bf16 ``x`` and int32 pointers of its shape in ``[0, rows)`` (not checked on
the card), ``int8`` int8, each 2-D.

A wrapper's call on the card is its launch and little else: a cheap check
of its arguments (``_check``), no device switch when the tensor lies on
the current card, the current stream's raw handle, one ``ctypes`` call
of the probe's own entry point, and its span and counter.
"""

import argparse
import ctypes
import json
import sys
import time

import numpy as np
import torch

from polar_torch import _build
from polar_torch._device import card_info, resolve_device
from polar_torch.ops.fg import fma_f32
from polar_torch.utils import kernel_work, tracing
from polar_torch.utils.profiling import cuda_ms

TB = 128        # columns of a TPU grid step's block
ROWS = 64       # rows of an f32 probe
BIG_ROWS = 1024  # k_big's scratch rows
BIG_STAGES = 8   # k_big's stages a sweep
COMBO_STAGES, COMBO_SWEEPS = 3, 4  # k_sweepcombo's stages and sweeps

# the probes in the order of csrc/probes.cuh ProbeId
PROBES = ("fori", "bcast", "roll", "reduce", "shift", "scratchfori",
          "sweepcombo", "bigsweep", "bigsweep_noloop", "arith", "gather",
          "int8")
MINI = PROBES[:9]       # the script's mini:<variant> steps
BF16 = PROBES[9:]       # its bf16 step
STEPS = tuple(f"mini:{name}" for name in MINI) + ("bf16",)
DTYPES = {"arith": torch.bfloat16, "gather": torch.bfloat16,
          "int8": torch.int8}
# the line of each probe's Pallas kernel in benchmarks/probe_r4.py
REPLACES = {"fori": 213, "bcast": 220, "roll": 223, "reduce": 227,
            "shift": 238, "scratchfori": 247, "sweepcombo": 256,
            "bigsweep": 278, "bigsweep_noloop": 278, "arith": 333,
            "gather": 337, "int8": 340}
REPS = 200      # timed launches a probe
SPLIT_CALLS = 10 ** 4  # calls a piece of launch_split


# ----------------------------------------------------------------------
# the plain versions
# ----------------------------------------------------------------------
def _sign(x):
    """``jnp.sign``: +-1, and ``x`` itself at +-0 and NaN (``torch.sign``
    gives +0 there)."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))


F32_ABS, F32_SIGN = 0x7FFFFFFF, -2 ** 31   # masks of int32 views
F32_INF, F32_QUIET = 0x7F800000, 0x00400000


def _minsum(x, p, sign_first, part_first):
    """One stage's update min(|x|, |p|) sign(x) sign(p) of every row (``x``
    its own value, ``p`` its partner's; int32 views of f32) with the bits
    XLA gives on the CPU: off NaN min(|x|, |p|) with the sign bit sign(x)
    XOR sign(p); with a NaN, ``p`` if it is a NaN and ``part_first``, else
    ``x`` if it is a NaN (its magnitude unless ``sign_first``), else ``p``'s
    magnitude, quieted. The order flags are those of XLA's two products
    (``csrc/probes.cuh`` ``probe_minsum_rule``, which says why): stage 0
    of a sweep runs (True, False), every later stage (False, True), and
    ``k_big``'s copies their own (``BIG_COPIES``). Integer operations and
    selects only, so no NaN payload depends on the float unit."""
    ax, ap = x & F32_ABS, p & F32_ABS
    num = torch.minimum(ax, ap) | ((x ^ p) & F32_SIGN)
    nx, np_ = ax > F32_INF, ap > F32_INF
    out = torch.where(nx, x if sign_first else ax, torch.where(np_, ap, num))
    if part_first:
        out = torch.where(np_, p, out)
    return torch.where(nx | np_, out | F32_QUIET, out)


# k_big's copies (csrc/probes.cuh probe_big_copy): the chain of a row whose
# value it sends its stage-s partner, s = 0..7, with 4 sweeps and with 1.
# MAIN: the row's own (the stage orders of ``_minsum``); ALT: stage 0 in
# the order (True, True), every later stage as MAIN; ALT_LAST: ALT with
# its last stage, s - 1, in the order (True, True). XLA computes each
# partner array again from the sweep's scratch in a fusion of its own, in
# that fusion's orders (tests/xla_copy_orders.py reads them off its code).
MAIN, ALT, ALT_LAST = 0, 1, 2
BIG_COPIES = {4: (MAIN, MAIN, ALT, ALT, ALT_LAST, ALT_LAST, ALT_LAST, MAIN),
              1: (MAIN, MAIN, ALT, ALT, MAIN, MAIN, MAIN, MAIN)}


def _big_sweep(x, sweeps):
    """``k_big``'s scratch (``x`` [64, cols] tiled to 1,024 rows) after
    ``sweeps`` sweeps of 8 stages, row r meeting r ^ 2^s at stage s: each
    row's main chain takes ``_minsum`` of its value and what its partner
    sent, the copy of the partner's value that ``BIG_COPIES`` names."""
    rows = torch.arange(BIG_ROWS, device=x.device)
    copies = BIG_COPIES[sweeps]
    v = x.repeat(BIG_ROWS // ROWS, 1).view(torch.int32)
    for _ in range(sweeps):
        w = sent = v
        for s in range(BIG_STAGES):
            q = sent[rows ^ (1 << s)]
            nxt = copies[s + 1] if s + 1 < BIG_STAGES else MAIN
            last = _minsum(w, q, True, True) if nxt == ALT_LAST else None
            v = _minsum(v, q, s == 0, s != 0)
            w = _minsum(w, q, s == 0, True)
            sent = (v, w, last)[nxt]
    return v.view(torch.float32)


def fori_plain(x):
    o = x.clone()
    for _ in range(5):
        o = o + x
    return o


def bcast_plain(x):
    return (x[:, :TB] * 2.0).repeat(1, x.shape[1] // TB)


def roll_plain(x):
    return torch.cat([x[8:], x[:8]]) + x


def _xla_min(x, y):
    """``jnp.minimum`` as XLA runs it on the CPU (LLVM's x86 lowering of
    ``llvm.minimum``): where ``x``'s sign bit is set the operands swap,
    then ``nx`` if it is NaN or below ``ny``, else ``ny``. So -0 < +0, a
    NaN propagates, and of two NaNs ``x`` is kept when it is a positive
    NaN, else ``y`` (``torch.minimum`` and ``torch.min`` keep other zeros
    and NaNs)."""
    swap = torch.signbit(x)
    nx, ny = torch.where(swap, y, x), torch.where(swap, x, y)
    return torch.where(torch.isnan(nx) | (nx < ny), nx, ny)


def reduce_plain(x):
    """``jnp.min(x, axis=0)`` as XLA folds it on the CPU, row by row with
    ``_xla_min``: a column's first positive NaN, else its last NaN, else
    its least value with -0 below +0; broadcast to every row."""
    m = x[0]
    for r in range(1, x.shape[0]):
        m = _xla_min(m, x[r])
    return m.expand_as(x).contiguous()


def shift_plain(x):
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    acc = x
    for s in range(3):
        acc = torch.where(((rows >> s) & 1) == 0, acc + x, acc - x)
    return acc


def scratchfori_plain(x):
    scr = x
    for _ in range(5):
        scr = fma_f32(1.5, scr, x)
    return scr


def sweepcombo_plain(x):
    """4 sweeps of stages 0..2: row r meets r ^ 2^s (the script's rolls
    wrap, but no partner reaches them) and takes ``_minsum`` of its own
    value and its partner's in its stage's order."""
    rows = torch.arange(x.shape[0], device=x.device)
    bits = x.contiguous().view(torch.int32)
    for _ in range(COMBO_SWEEPS):
        for s in range(COMBO_STAGES):
            bits = _minsum(bits, bits[rows ^ (1 << s)], s == 0, s != 0)
    return bits.view(torch.float32)


def bigsweep_plain(x):
    return _big_sweep(x, 4)[:ROWS]


def bigsweep_noloop_plain(x):
    return _big_sweep(x, 1)[:ROWS]


def arith_plain(x):
    two = torch.tensor(2.0, dtype=x.dtype, device=x.device)
    return torch.minimum(x.abs(), two) * _sign(x) + x


def gather_plain(x, ptr):
    """``take_along_axis(x, ptr, axis=0)`` as XLA's gather gives it on the
    CPU: every bf16 NaN written as its sign and ``0x7fc0``."""
    h = x[ptr.long(), torch.arange(x.shape[1], device=x.device)].view(
        torch.int16)
    nan = (h & 0x7FFF) > 0x7F80
    return torch.where(nan, (h & -2 ** 15) | 0x7FC0, h).view(torch.bfloat16)


def int8_plain(x):
    return torch.where(x > 0, x, -x) + 1


PLAIN = {name: globals()[f"{name}_plain"] for name in PROBES}


# ----------------------------------------------------------------------
# the wrappers
# ----------------------------------------------------------------------
def _checker(name):
    """The check of probe ``name``'s arguments, which raises unless they
    are what it takes: per-probe constants, the types compared by
    identity, the shape read once."""
    dtype = DTYPES.get(name, torch.float32)
    n_args, mini, gather = (2 if name == "gather" else 1), name in MINI, \
        name == "gather"

    def check(args):
        if len(args) != n_args:
            raise TypeError(f"{name} takes {n_args} tensor(s), not "
                            f"{len(args)}")
        x = args[0]
        s = x.shape
        if x.dtype is not dtype or len(s) != 2 or not s[0] or not s[1]:
            raise TypeError(f"{name} takes a non-empty 2-D {dtype} tensor")
        if not x.is_contiguous():
            raise ValueError(f"{name} takes a contiguous tensor")
        if mini and (s[0] != ROWS or s[1] % TB):
            raise ValueError(f"{name} takes [{ROWS}, {TB} g], not {list(s)}")
        if gather:
            ptr = args[1]
            if (ptr.dtype is not torch.int32 or ptr.shape != s
                    or not ptr.is_contiguous() or ptr.device != x.device):
                raise ValueError("gather takes contiguous int32 pointers of "
                                 "x's shape on x's device")

    return check


_CHECKS = {name: _checker(name) for name in PROBES}


def _check(name, args):
    """Raises unless ``args`` are what probe ``name`` takes."""
    if name not in _CHECKS:
        raise ValueError(f"unknown probe {name!r}")
    _CHECKS[name](args)


def _entry(name):
    """``probe_<name>`` of the card's library (``csrc/probes.cu``), its
    argument types set: the tensors' pointers, then ``cols`` (f32 probes)
    or ``rows, cols``, then the stream."""
    fn = getattr(_build.load("probes", "cuda"), f"probe_{name}")
    n_ptrs = 3 if name == "gather" else 2
    n_ints = 1 if name in MINI else 2
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _stream(idx):
    """The raw handle of card ``idx``'s current stream. No public call of
    torch returns it without building a ``Stream`` object, which costs the
    host more (``launch_split``); torch's own generated launchers read it
    so."""
    return torch._C._cuda_getCurrentRawStream(idx)


def _launcher(name):
    """The function that launches probe ``name``'s kernel on ``x`` (and
    the pointers in ``args``) on the current stream of card ``idx``, which
    holds them, and returns its output."""
    fn, is_f32, is_gather = None, name in MINI, name == "gather"

    def launch(x, args, idx):
        nonlocal fn
        if fn is None:
            fn = _entry(name)
        out = torch.empty_like(x)
        rows, cols = x.shape
        if is_f32:
            rc = fn(x.data_ptr(), out.data_ptr(), cols, _stream(idx))
        elif is_gather:
            rc = fn(x.data_ptr(), args[1].data_ptr(), out.data_ptr(), rows,
                    cols, _stream(idx))
        else:
            rc = fn(x.data_ptr(), out.data_ptr(), rows, cols, _stream(idx))
        if rc != 0:
            raise RuntimeError(f"probe {name}: launch failed with code {rc}")
        return out

    return launch


def _wrapper(name):
    check, plain, launch = _CHECKS[name], PLAIN[name], _launcher(name)
    span_name, counter_name = f"kernel.probe.{name}", f"launch.probe.{name}"

    def probe(*args):
        with tracing.span(span_name):
            check(args)
            x = args[0]
            if x.is_cuda:
                idx = x.get_device()
                if idx == torch.cuda.current_device():
                    out = launch(x, args, idx)
                else:
                    with torch.cuda.device(idx):
                        out = launch(x, args, idx)
                tracing.count(counter_name, ops=1)
                kernel_work.report(kernel_work.probe_work, name, *args)
                return out
            if x.device.type == "cpu":
                return plain(*args)
            raise ValueError(f"{name}: unsupported device {x.device}")

    probe.__name__ = probe.__qualname__ = name
    probe.__doc__ = (f"The ``{name}`` probe (``benchmarks/probe_r4.py:"
                     f"{REPLACES[name]}``): its kernel on a CUDA tensor, "
                     f"``{name}_plain`` on a CPU one.")
    return probe


WRAPPERS = {name: _wrapper(name) for name in PROBES}
(fori, bcast, roll, reduce, shift, scratchfori, sweepcombo, bigsweep,
 bigsweep_noloop, arith, gather, int8) = WRAPPERS.values()


def launch_counts():
    """Each probe kernel's launch count (``launch.probe.<name>``)."""
    return {name: tracing.counter(f"launch.probe.{name}") for name in PROBES}


def reset_launch_counts():
    """Every probe's launch count to 0."""
    tracing.reset_counters([f"launch.probe.{name}" for name in PROBES])


def probe_host(name, *args):
    """Probe ``name`` through the kernels' routines built for the CPU
    (g++), CPU tensors only; for the tests. The main path never calls
    it."""
    _check(name, args)
    x = args[0]
    if x.device.type != "cpu":
        raise ValueError("probe_host takes CPU tensors")
    fn = _build.load("probes", "host").probes_host
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    out = torch.empty_like(x)
    rc = fn(PROBES.index(name), x.data_ptr(),
            args[1].data_ptr() if name == "gather" else None,
            out.data_ptr(), *x.shape)
    if rc != 0:
        raise RuntimeError(f"probe_host {name}: refused with code {rc}")
    return out


# ----------------------------------------------------------------------
# the entry point
# ----------------------------------------------------------------------
def mini_input(seed=0):
    """The ``mini:`` steps' input: f32 [64, 512] from
    ``default_rng(seed).normal(0, 2)``, as the script makes it."""
    x = np.random.default_rng(seed).normal(0, 2, (ROWS, 4 * TB))
    return torch.from_numpy(x.astype(np.float32))


# NaNs of two payloads and both signs, +-1 and +-0 (f32 bits)
SPECIAL_F32 = (0x7FC00001, 0xFFC00002, 0x7FC00004, 0xFFC00008, 0x3F800000,
               0xBF800000, 0x00000000, 0x80000000)


def _f32(bits):
    """f32 tensor of the given bits (uint32 values in a numpy array)."""
    return torch.from_numpy(np.asarray(bits, np.uint32).view(np.float32))


def pair_input(seed=0):
    """An f32 [64, 512] input of the stage sweeps that meets every ordered
    pair (a, p) of ``SPECIAL_F32`` at each of ``k_sweepcombo``'s stages
    0..2: column 3 i + s (i < 64, s < 3) holds a = ``SPECIAL_F32[i // 8]``
    at row r = 8 (i % 8) and p = ``SPECIAL_F32[i % 8]`` at its stage-s
    partner r + 2^s; its other rows, and columns 192..511, are
    ``mini_input(seed)``'s magnitudes plus 1."""
    x = mini_input(seed).abs() + 1.0
    bits = x.numpy().view(np.uint32).copy()
    for i in range(64):
        for s in range(3):
            r = 8 * (i % 8)
            bits[r, 3 * i + s] = SPECIAL_F32[i // 8]
            bits[r + (1 << s), 3 * i + s] = SPECIAL_F32[i % 8]
    return _f32(bits)


def bits_input(seed=0, cols=4 * TB):
    """f32 [64, cols] of random bits: NaNs of many payloads (quiet and
    signalling) and both signs, infinities; subnormals written as zeros of
    their sign (XLA's CPU code flushes them to zero, the card and torch do
    not), so about 1 in 256 elements is a NaN and as many are zeros."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2 ** 32, (ROWS, cols), dtype=np.uint64).astype(
        np.uint32)
    sub = (bits & np.uint32(0x7F800000)) == 0
    bits[sub] &= np.uint32(0x80000000)
    return _f32(bits)


def bf16_inputs(seed=0):
    """The ``bf16`` step's inputs, drawn from ``default_rng(seed)`` in the
    script's order (``xb``, ``ptr``, ``x8``, ``xi``), as each probe's
    arguments."""
    rng = np.random.default_rng(seed)
    xb = rng.normal(0, 2, (16, 256))
    ptr = rng.integers(0, 8, (8, 256))
    x8 = rng.normal(0, 2, (8, 256))
    xi = rng.integers(-8, 8, (32, 256))
    return {"arith": (_to_bf16(xb),),
            "gather": (_to_bf16(x8), torch.from_numpy(ptr.astype(np.int32))),
            "int8": (torch.from_numpy(xi.astype(np.int8)),)}


def _to_bf16(a):
    """f64 values rounded to bf16 through f32, as JAX's conversion rounds
    them (twice)."""
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def differing(want, got):
    """Elements whose bits differ between two tensors of one shape and
    type."""
    if want.shape != got.shape or want.dtype != got.dtype:
        raise ValueError(f"shapes or types differ: {want.shape} "
                         f"{want.dtype}, {got.shape} {got.dtype}")
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if want.dtype in bits:
        want, got = want.view(bits[want.dtype]), got.view(bits[got.dtype])
    return int((want != got).sum().item())


def step_inputs(step, seed=0):
    """{probe name: its arguments (CPU tensors)} of ``step``."""
    if step == "bf16":
        return bf16_inputs(seed)
    name = step.partition(":")[2]
    if not step.startswith("mini:") or name not in MINI:
        raise ValueError(f"unknown step {step!r}; the steps are {STEPS}")
    return {name: (mini_input(seed),)}


def run_step(step, device=None, seed=0):
    """Run ``step`` on ``device`` (the card by default) on the draw of
    ``seed``: each of its probes once against its plain version, then
    timed over ``REPS`` launches on the card. Returns the step's JSON row
    (``bf16``: one entry a probe)."""
    dev = resolve_device(device)
    name, power = card_info(dev)
    row = {"step": step, "device": name, "power_limit": power}
    for probe, args in step_inputs(step, seed).items():
        args = tuple(a.to(dev) for a in args)
        wrapper = WRAPPERS[probe]
        got = wrapper(*args)
        want = PLAIN[probe](*args)
        result = {"ms": (cuda_ms(lambda: wrapper(*args), REPS)
                         if dev.type == "cuda" else None),
                  "mismatches": differing(want, got),
                  "max_abs_err": (want.double() - got.double()).abs().max()
                  .item()}
        bound, by = kernel_work.bound_ms(*kernel_work.probe_work(probe,
                                                                 *args))
        result.update(bound_ms=bound, bound_by=by)
        if step == "bf16":
            row[probe] = result
        else:
            row.update(result)
    return row


def results(row):
    """{probe name: its result} of a ``run_step`` row."""
    if row["step"] == "bf16":
        return {probe: row[probe] for probe in BF16}
    return {row["step"].partition(":")[2]: row}


def _host_us(fn, calls):
    """Mean host time of ``fn()`` in µs over ``calls`` calls, from a
    synchronised card to a synchronised card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def launch_split(device=None, calls=SPLIT_CALLS):
    """What one call of the ``gather`` and ``reduce`` wrappers spends on
    the card's host, piece by piece, at the script's inputs: {probe:
    {piece: µs a call}}, each piece timed alone over ``calls`` calls. The
    pieces of the wrapper's path; the entry point called with 0 columns,
    which returns before any launch (the ``ctypes`` call alone); two
    calls the path avoids (a ``torch.cuda.device`` context, the stream
    through a ``Stream`` object); the library call of the same function
    (``torch.gather`` on int64 pointers, ``torch.amin``)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("launch_split times the card's launches")
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    split = {}
    for name in ("gather", "reduce"):
        step = "bf16" if name in BF16 else f"mini:{name}"
        args = tuple(a.to(dev) for a in step_inputs(step)[name])
        x = args[0]
        out = torch.empty_like(x)
        wrapper, fn = WRAPPERS[name], _entry(name)
        ptrs = [a.data_ptr() for a in args] + [out.data_ptr()]
        shape = [x.shape[1]] if name in MINI else list(x.shape)
        stream = _stream(idx)
        span_name, counter_name = (f"kernel.probe.{name}",
                                   f"launch.probe.{name}")

        def device_context():
            with torch.cuda.device(x.device):
                pass

        if name == "gather":
            ptr = args[1].long()
            library = ("torch.gather", lambda: torch.gather(x, 0, ptr))
        else:
            library = ("torch.amin",
                       lambda: torch.amin(x, dim=0, keepdim=True))
        pieces = {
            "wrapper": lambda: wrapper(*args),
            "_check": lambda: _CHECKS[name](args),
            "x.get_device, torch.cuda.current_device":
                lambda: x.get_device() == torch.cuda.current_device(),
            "raw stream handle": lambda: _stream(idx),
            "torch.empty_like": lambda: torch.empty_like(x),
            "ctypes call, no launch": lambda: fn(*ptrs, *[0] * len(shape),
                                                 stream),
            "ctypes call and launch": lambda: fn(*ptrs, *shape, stream),
            "kernel_work.report": lambda: kernel_work.report(
                kernel_work.probe_work, name, *args),
            "tracing.span, off": lambda: tracing.span(span_name),
            "tracing.count": lambda: tracing.count(counter_name, 0),
            "not on the path: torch.cuda.device context": device_context,
            "not on the path: current_stream().cuda_stream":
                lambda: torch.cuda.current_stream(x.device).cuda_stream,
            f"library: {library[0]}": library[1],
        }
        split[name] = {k: _host_us(f, calls) for k, f in pieces.items()}
    return split


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m polar_torch.probes",
        description="The probe kernels against their plain versions, "
                    "timed on the card (one JSON line a step).")
    ap.add_argument("steps", nargs="*", default=list(STEPS),
                    help=f"steps to run (default: all): {' '.join(STEPS)}")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--split", action="store_true",
                    help="print the gather and reduce wrappers' host time "
                         "a call, piece by piece, instead (the card only)")
    args = ap.parse_args(argv)
    if args.split:
        name, power = card_info(resolve_device(args.device))
        print(json.dumps({"device": name, "power_limit": power,
                          "calls": SPLIT_CALLS,
                          "us_a_call": launch_split(args.device)}))
        return 0
    bad = []
    for step in args.steps:
        row = run_step(step, args.device)
        print(json.dumps(row), flush=True)
        if any(r["mismatches"] for r in results(row).values()):
            bad.append(step)
    if bad:
        print(f"probes: kernels differ from their plain versions in {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
