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

Each step prints one JSON line: the step, the card's name and power limit,
and per probe the card's ms per launch (CUDA events; null on the CPU), the
elements whose bits differ from the plain version, the largest absolute
difference and the bound. A failure
or a differing element exits non-zero.

* Each probe's wrapper (``fori``, ``bcast``, ..., ``int8``, also in
  ``WRAPPERS``) launches the kernel (``csrc/probes.cu``) on a CUDA tensor
  and runs the plain version on a CPU one; nothing falls back from one to
  the other. It counts its launches in ``launches`` (``launch_counts``,
  ``reset_launch_counts``) and reports each launch's work to a running
  ``profiling.flop_estimate``.
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
"""

import argparse
import ctypes
import json
import sys

import numpy as np
import torch

from polar_torch import _build
from polar_torch._device import card_info, resolve_device
from polar_torch.ops.fg import fma_f32
from polar_torch.utils import kernel_work
from polar_torch.utils.profiling import cuda_ms

TB = 128        # columns of a TPU grid step's block
ROWS = 64       # rows of an f32 probe
BIG_ROWS = 1024  # k_big's scratch rows

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


# ----------------------------------------------------------------------
# the plain versions
# ----------------------------------------------------------------------
def _sign(x):
    """``jnp.sign``: +-1, and ``x`` itself at +-0 and NaN (``torch.sign``
    gives +0 there)."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))


def _sweep(scr, stages, sweeps):
    """``sweeps`` sweeps over stages 0..stages-1 of ``scr`` [rows, cols]:
    row r meets r + 2^s where bit s of r is 0, else r - 2^s, and takes
    min(|a|, |p|) sign(a) sign(p)."""
    rows = torch.arange(scr.shape[0])
    partners = []
    for s in range(stages):
        p = torch.where(((rows >> s) & 1) == 0, rows + (1 << s),
                        rows - (1 << s))
        # the scripts' rolls wrap, but no partner reaches them
        assert bool(((p >= 0) & (p < len(rows))).all())
        partners.append(p.to(scr.device))
    for _ in range(sweeps):
        for p in partners:
            part = scr[p]
            scr = torch.minimum(scr.abs(), part.abs()) * _sign(scr) \
                * _sign(part)
    return scr


def fori_plain(x):
    o = x.clone()
    for _ in range(5):
        o = o + x
    return o


def bcast_plain(x):
    return (x[:, :TB] * 2.0).repeat(1, x.shape[1] // TB)


def roll_plain(x):
    return torch.cat([x[8:], x[:8]]) + x


def reduce_plain(x):
    return x.min(dim=0, keepdim=True).values.expand_as(x).contiguous()


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
    return _sweep(x, 3, 4)


def bigsweep_plain(x):
    return _sweep(x.repeat(BIG_ROWS // ROWS, 1), 8, 4)[:ROWS]


def bigsweep_noloop_plain(x):
    return _sweep(x.repeat(BIG_ROWS // ROWS, 1), 8, 1)[:ROWS]


def arith_plain(x):
    two = torch.tensor(2.0, dtype=x.dtype, device=x.device)
    return torch.minimum(x.abs(), two) * _sign(x) + x


def gather_plain(x, ptr):
    return x[ptr.long(), torch.arange(x.shape[1], device=x.device)]


def int8_plain(x):
    return torch.where(x > 0, x, -x) + 1


PLAIN = {name: globals()[f"{name}_plain"] for name in PROBES}


# ----------------------------------------------------------------------
# the wrappers
# ----------------------------------------------------------------------
def _check(name, args):
    """Raises unless ``args`` are what probe ``name`` takes."""
    if name not in PROBES:
        raise ValueError(f"unknown probe {name!r}")
    want = 2 if name == "gather" else 1
    if len(args) != want:
        raise TypeError(f"{name} takes {want} tensor(s), not {len(args)}")
    x = args[0]
    dtype = DTYPES.get(name, torch.float32)
    if x.dtype != dtype or x.dim() != 2 or x.numel() == 0:
        raise TypeError(f"{name} takes a non-empty 2-D {dtype} tensor")
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")
    if name in MINI and (x.shape[0] != ROWS or x.shape[1] % TB):
        raise ValueError(f"{name} takes [{ROWS}, {TB} g], not "
                         f"{list(x.shape)}")
    if name == "gather":
        ptr = args[1]
        if (ptr.dtype != torch.int32 or ptr.shape != x.shape
                or ptr.device != x.device or not ptr.is_contiguous()):
            raise ValueError("gather takes contiguous int32 pointers of "
                             "x's shape on x's device")


def _native_call(fn, name, args, last):
    """Call ``probes_launch`` or ``probes_host``; ``last`` is the stream's
    (ctypes type, value), or None for the host."""
    x = args[0]
    ptr = args[1] if name == "gather" else None
    out = torch.empty_like(x)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + (
                           [] if last is None else [last[0]])
        fn.restype = ctypes.c_int
    rc = fn(PROBES.index(name), x.data_ptr(),
            None if ptr is None else ptr.data_ptr(), out.data_ptr(),
            x.shape[0], x.shape[1], *([] if last is None else [last[1]]))
    if rc != 0:
        raise RuntimeError(f"probe {name}: native call failed with code {rc}")
    return out


def _wrapper(name):
    def probe(*args):
        _check(name, args)
        x = args[0]
        if x.device.type == "cpu":
            return PLAIN[name](*args)
        if x.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {x.device}")
        lib = _build.load("probes", "cuda")
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            out = _native_call(lib.probes_launch, name, args,
                               (ctypes.c_void_p, stream))
        probe.launches += 1
        kernel_work.report(kernel_work.probe_work, name, *args)
        return out

    probe.__name__ = probe.__qualname__ = name
    probe.__doc__ = (f"The ``{name}`` probe (``benchmarks/probe_r4.py:"
                     f"{REPLACES[name]}``): its kernel on a CUDA tensor, "
                     f"``{name}_plain`` on a CPU one.")
    probe.launches = 0
    return probe


WRAPPERS = {name: _wrapper(name) for name in PROBES}
(fori, bcast, roll, reduce, shift, scratchfori, sweepcombo, bigsweep,
 bigsweep_noloop, arith, gather, int8) = WRAPPERS.values()


def launch_counts():
    """Each probe kernel's launch count, as its wrapper keeps it."""
    return {name: WRAPPERS[name].launches for name in PROBES}


def reset_launch_counts():
    """Every probe wrapper's launch count to 0."""
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0


def probe_host(name, *args):
    """Probe ``name`` through the kernels' routines built for the CPU
    (g++), CPU tensors only; for the tests. The main path never calls
    it."""
    _check(name, args)
    if args[0].device.type != "cpu":
        raise ValueError("probe_host takes CPU tensors")
    return _native_call(_build.load("probes", "host").probes_host, name,
                        args, None)


# ----------------------------------------------------------------------
# the entry point
# ----------------------------------------------------------------------
def mini_input(seed=0):
    """The ``mini:`` steps' input: f32 [64, 512] from
    ``default_rng(seed).normal(0, 2)``, as the script makes it."""
    x = np.random.default_rng(seed).normal(0, 2, (ROWS, 4 * TB))
    return torch.from_numpy(x.astype(np.float32))


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


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m polar_torch.probes",
        description="The probe kernels against their plain versions, "
                    "timed on the card (one JSON line a step).")
    ap.add_argument("steps", nargs="*", default=list(STEPS),
                    help=f"steps to run (default: all): {' '.join(STEPS)}")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
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
