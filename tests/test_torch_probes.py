"""polar_torch.probes against the Pallas probe kernels of
``benchmarks/probe_r4.py``: each probe's plain version bit for bit against
the script's own kernel, run in interpret mode at the script's inputs and
two more draws (and, for the reduction and the stage sweeps, with signed
zeros and a NaN); the g++ build of the kernels' routines bit for bit against
the plain versions; the entry point on the CPU; the work counts. The
kernels themselves are tested on the card in ``test_torch_gpu.py``.

The reference kernels come from the script's source through ``ast``:
importing the script would run its TPU session (``import polar_tpu``,
``jax.devices()``, its steps from ``sys.argv``). The calls are rebuilt with
its specs (``:234-237``, ``:307-317``, ``:358``)."""

import ast
import json
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from polar_torch import probes
from polar_torch.utils import kernel_work, tracing

from _torch_parity import (REDUCE_ZERO_NAN_MINIMA, gather_zero_nan_input,
                           reduce_zero_nan_input)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "benchmarks", "probe_r4.py")
KERNELS = ("k_fori", "k_bcast", "k_roll", "k_reduce", "k_shift",
           "k_scratchfori", "k_sweepcombo", "make_bigsweep", "k_arith",
           "k_gather", "k_i8")
TBm = 128
SEEDS = (0, 1, 2)        # the script's draw and two more


@pytest.fixture(scope="module")
def script():
    """The script's kernel functions, executed from its source."""
    return _script_kernels()


def _script_kernels():
    with open(SCRIPT) as fh:
        tree = ast.parse(fh.read(), SCRIPT)
    nodes = [node for node in ast.walk(tree)
             if isinstance(node, ast.FunctionDef) and node.name in KERNELS]
    assert sorted(node.name for node in nodes) == sorted(KERNELS)
    ns = {"jnp": jnp, "lax": lax, "np": np, "TBm": TBm}
    exec(compile(ast.Module(body=nodes, type_ignores=[]), SCRIPT, "exec"),
         ns)
    return ns


def _script_input(seed):
    """The ``mini:`` steps' input as the script draws it (``:231-232``)."""
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(0, 2, (64, 4 * TBm)), jnp.float32)


def _jax_mini(ns, variant, x):
    """``mini:<variant>`` on ``x`` as the script runs it (``:233-237``,
    ``:300-317``), in interpret mode."""
    oshape = jax.ShapeDtypeStruct((64, 4 * TBm), jnp.float32)
    bspec = pl.BlockSpec((64, TBm), lambda i: (0, i),
                         memory_space=pltpu.VMEM)
    cspec = pl.BlockSpec((64, TBm), lambda i: (0, 0),
                         memory_space=pltpu.VMEM)
    kern = {"bigsweep": ns["make_bigsweep"](True),
            "bigsweep_noloop": ns["make_bigsweep"](False)}.get(
                variant) or ns[f"k_{variant}"]
    scratch = ([pltpu.VMEM((64, TBm), jnp.float32)]
               if variant in ("scratchfori", "sweepcombo") else [])
    if variant.startswith("bigsweep"):
        scratch = [pltpu.VMEM((1024, TBm), jnp.float32)]
    r = pl.pallas_call(kern, grid=(4,),
                       in_specs=[cspec if variant == "bcast" else bspec],
                       out_specs=bspec, out_shape=oshape,
                       scratch_shapes=scratch, interpret=True)(x)
    return np.asarray(r)


def _jax_bf16(ns, name, seed):
    """One probe of the ``bf16`` step as the script runs it
    (``:344-358``), in interpret mode: (its arguments, its output)."""
    rng = np.random.default_rng(seed)
    xb = jnp.asarray(rng.normal(0, 2, (16, 256)), jnp.bfloat16)
    ptr = jnp.asarray(rng.integers(0, 8, (8, 256)), jnp.int32)
    x8 = jnp.asarray(rng.normal(0, 2, (8, 256)), jnp.bfloat16)
    xi = jnp.asarray(rng.integers(-8, 8, (32, 256)), jnp.int8)
    kern, args, oshape = {
        "arith": (ns["k_arith"], (xb,),
                  jax.ShapeDtypeStruct((16, 256), jnp.bfloat16)),
        "gather": (ns["k_gather"], (x8, ptr),
                   jax.ShapeDtypeStruct((8, 256), jnp.bfloat16)),
        "int8": (ns["k_i8"], (xi,),
                 jax.ShapeDtypeStruct((32, 256), jnp.int8))}[name]
    r = pl.pallas_call(kern, out_shape=oshape, interpret=True)(*args)
    return tuple(np.asarray(a) for a in args), np.asarray(r)


def _bits(a):
    """The bits of each element of a numpy array or CPU tensor."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a.view(np.int16) if str(a.dtype) == "bfloat16" else a


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", probes.PROBES)
def test_plain_equals_script_kernel(script, name, seed):
    inputs = probes.step_inputs("bf16" if name in probes.BF16
                                else f"mini:{name}", seed)[name]
    if name in probes.MINI:
        x = _script_input(seed)
        args, want = (np.asarray(x),), _jax_mini(script, name, x)
    else:
        args, want = _jax_bf16(script, name, seed)
    # the port draws the script's inputs, bit for bit
    assert len(args) == len(inputs)
    for a, t in zip(args, inputs):
        np.testing.assert_array_equal(_bits(a), _bits(t))
    got = getattr(probes, name)(*inputs)        # CPU: the plain version
    assert got.dtype == inputs[0].dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_plain_keeps_jax_signed_zeros_and_nan(script):
    x = probes.mini_input(3)
    x[0, :4] = torch.tensor([0.0, -0.0, float("nan"), -0.0])
    x[1:9, 4] = 0.0
    for variant in ("reduce", "sweepcombo", "bigsweep_noloop"):
        want = _jax_mini(script, variant, jnp.asarray(x.numpy()))
        got = probes.PLAIN[variant](x)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(
            _bits(probes.probe_host(variant, x)), _bits(got))


def test_reduce_combine_order_keeps_jax_bits(script):
    """JAX's ``jnp.min`` keeps -0 below +0 and picks between NaNs by sign
    and order (``probes._xla_min``); the plain version and the host build
    of the card's split reduction (row chunks combined in row order) give
    its bits."""
    x = reduce_zero_nan_input(probes.mini_input(4))
    want = _jax_mini(script, "reduce", jnp.asarray(x.numpy()))
    got = probes.reduce(x)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(probes.probe_host("reduce", x)),
                                  _bits(want))
    # the columns' minima, as JAX folds them
    assert list(_bits(want)[0, :10].view(np.uint32)) == \
        REDUCE_ZERO_NAN_MINIMA


def _sweep_input(kind):
    """The stage sweeps' NaN inputs: ``reduce_zero_nan_input`` (zeros of
    both signs, NaNs of two payloads and both signs in one column), f32 of
    random bits (``probes.bits_input``) and every ordered pair of NaNs,
    +-1 and +-0 at each of ``k_sweepcombo``'s stages
    (``probes.pair_input``)."""
    return {"zero_nan": lambda: reduce_zero_nan_input(probes.mini_input(4)),
            "bits": lambda: probes.bits_input(0),
            "pairs": lambda: probes.pair_input(0)}[kind]()


@pytest.mark.parametrize("name,kind", [
    ("sweepcombo", "zero_nan"), ("sweepcombo", "bits"),
    ("sweepcombo", "pairs"), ("bigsweep_noloop", "zero_nan"),
    ("bigsweep_noloop", "bits"), ("bigsweep", "zero_nan"),
    ("bigsweep", "bits"), ("bigsweep", "pairs"),
    ("bigsweep_noloop", "pairs")])
def test_sweeps_keep_jax_nan_bits(script, name, kind):
    """The stage update's NaN bits (``probes._minsum``, ``probes.cuh``
    ``probe_minsum_rule``: at stage 0 of a sweep the row's own NaN first,
    at later stages its partner's, else the other NaN's magnitude) against
    the script's kernel, bit for bit, in the plain version and in the host
    build of the card's routine (``k_big``: warps, lanes and the fold of
    the four quarters). ``k_big``'s partners are XLA's copies, each from a
    fusion with its own orders (``probes.BIG_COPIES``), so where NaNs meet
    a row takes the bits of the copy its partner sent. The pairs input
    holds every ordered pair of four NaNs, +-1 and +-0 at every stage of
    ``k_sweepcombo``."""
    x = _sweep_input(kind)
    want = _bits(_jax_mini(script, name, jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(_bits(probes.PLAIN[name](x)), want)
    np.testing.assert_array_equal(_bits(probes.probe_host(name, x)), want)


def test_big_copy_table_equals_host_build():
    """``probes.BIG_COPIES``, the chain whose value a row of ``k_big``
    sends its stage-s partner, is ``probes.cuh``'s ``probe_big_copy`` as
    the host build reads it, for both sweep counts (stage 8: the next
    sweep's scratch, the main chain)."""
    from polar_torch import _build
    fn = _build.load("probes", "host").probes_host_big_copy
    for sweeps, copies in probes.BIG_COPIES.items():
        assert [fn(s, sweeps) for s in range(9)] == \
            list(copies) + [probes.MAIN], sweeps


@pytest.mark.parametrize("name", ["sweepcombo", "bigsweep",
                                  "bigsweep_noloop"])
def test_sweeps_host_build_on_wide_nan_input(name):
    """The host build of the card's routine (``k_sweepcombo``: one thread
    a column and 8-row group) against the plain version on f32 of random
    bits at [64, 768], six 128-column blocks."""
    x = probes.bits_input(9, 6 * TBm)
    assert probes.differing(probes.PLAIN[name](x),
                            probes.probe_host(name, x)) == 0


@pytest.mark.parametrize("shape", [(8, 250), (8, 3), (13, 1001), (16, 1024),
                                   (300, 40), (1024, 9), (1025, 8),
                                   (3072, 16), (3073, 9)])
def test_gather_host_build_tiles_and_masks(script, shape):
    """The host build of the card's gather (slabs of up to 256 columns, 8
    columns a thread; widths not a multiple of 8 element by element,
    masked past the last column; more units a slab than a CTA holds
    pointers for past 1,024 rows; element by element from ``x`` past the
    3,072 rows a tile holds) against the plain version and the script's
    kernel, bit for bit, on finite values and on random bf16 bits (NaNs of
    many payloads, written as XLA's gather writes them: sign and
    ``0x7fc0``; signed zeros)."""
    rows, cols = shape
    x, ptr = gather_zero_nan_input(rows, cols, rows * cols)
    assert probes.differing(probes.gather(x, ptr),
                            probes.probe_host("gather", x, ptr)) == 0
    if rows * cols <= 8192:
        xf = probes._to_bf16(np.random.default_rng(cols).normal(0, 2, shape))
        for xs in (xf, x):
            want = pl.pallas_call(
                script["k_gather"], interpret=True,
                out_shape=jax.ShapeDtypeStruct(shape, jnp.bfloat16))(
                    jnp.asarray(xs.view(torch.int16).numpy()).view(
                        jnp.bfloat16), jnp.asarray(ptr.numpy()))
            want = _bits(np.asarray(want))
            np.testing.assert_array_equal(
                _bits(probes.probe_host("gather", xs, ptr)), want)
            np.testing.assert_array_equal(_bits(probes.gather(xs, ptr)),
                                          want)


@pytest.mark.parametrize("name", ["reduce", "gather", "int8"])
def test_host_build_takes_unaligned_tensors(name):
    """A contiguous view one element past a 16-byte boundary takes the
    card's element-by-element form, bit-equal to the plain version."""
    step = "bf16" if name in probes.BF16 else f"mini:{name}"
    args = probes.step_inputs(step, 2)[name]
    if name == "reduce":
        args = (reduce_zero_nan_input(args[0]),)
    x = args[0]
    flat = x.new_empty(x.numel() + 1)
    flat[1:] = x.flatten()
    args = (flat[1:].view(x.shape),) + args[1:]
    assert args[0].data_ptr() % 16 and args[0].is_contiguous()
    np.testing.assert_array_equal(_bits(probes.probe_host(name, *args)),
                                  _bits(probes.PLAIN[name](*args)))


@pytest.mark.parametrize("name", probes.PROBES)
def test_host_build_equals_plain(name):
    for seed in SEEDS:
        step = "bf16" if name in probes.BF16 else f"mini:{name}"
        args = probes.step_inputs(step, seed)[name]
        want = probes.PLAIN[name](*args)
        got = probes.probe_host(name, *args)
        assert probes.differing(want, got) == 0, (name, seed)
    if name in probes.MINI:
        # a wider input: more blocks than the script's four
        x = torch.from_numpy(np.random.default_rng(5).normal(
            0, 2, (64, 6 * TBm)).astype(np.float32))
        assert probes.differing(probes.PLAIN[name](x),
                                probes.probe_host(name, x)) == 0


@pytest.mark.parametrize("shape", [(3, 17), (32, 250)])
def test_int8_host_build_takes_ragged_widths(shape):
    """Widths that are not a multiple of 16 and sizes that leave a partial
    16-byte unit: the host build of the card's kernel (whole units as
    16-byte words, the last one byte by byte) against the plain version,
    on every int8 value."""
    x = torch.from_numpy(np.random.default_rng(shape[1]).integers(
        -128, 128, shape).astype(np.int8))
    x.view(-1)[:256] = torch.arange(-128, 128, dtype=torch.int8)[
        :x.numel()]
    assert probes.differing(probes.PLAIN["int8"](x),
                            probes.probe_host("int8", x)) == 0


def test_int8_wraps_as_int8():
    x = torch.tensor([[-128, -8, -1, 0, 1, 126, 127]], dtype=torch.int8)
    want = torch.tensor([[-127, 9, 2, 1, 2, 127, -128]], dtype=torch.int8)
    assert torch.equal(probes.int8(x), want)
    assert torch.equal(probes.probe_host("int8", x), want)


def test_main_on_cpu_prints_one_line_per_step(capsys):
    assert probes.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    rows = [json.loads(line) for line in lines]
    assert [row["step"] for row in rows] == list(probes.STEPS)
    for row in rows:
        assert (row["device"], row["power_limit"]) == ("cpu", None)
        for r in probes.results(row).values():
            assert r["ms"] is None and r["mismatches"] == 0
            assert r["max_abs_err"] == 0
            assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes",
                                                           "operations")
    assert probes.main(["--device", "cpu", "mini:roll"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 1


def test_entry_point_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        probes.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        probes.run_step("bf16")
    with pytest.raises(ValueError, match="unknown step"):
        probes.run_step("mini:nope", "cpu")


def test_probe_times_needs_the_card(monkeypatch):
    """The tool that times two checkouts' probes refuses to run without a
    card, as the entry point does."""
    import sys
    from polar_torch.utils import probe_times
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        probe_times.main([REPO, "roll"])


def test_main_fails_on_a_mismatch(monkeypatch, capsys):
    monkeypatch.setitem(probes.WRAPPERS, "roll", lambda x: x)
    assert probes.main(["--device", "cpu", "mini:roll"]) == 1
    assert json.loads(capsys.readouterr().out)["mismatches"] > 0


def test_wrappers_check_their_arguments():
    x = probes.mini_input()
    with pytest.raises(TypeError):
        probes.fori(x.double())
    with pytest.raises(ValueError):
        probes.roll(x[:, :100].contiguous())
    with pytest.raises(ValueError):
        probes.shift(x.t())
    with pytest.raises(TypeError):
        probes.gather(x)
    xb, ptr = probes.bf16_inputs()["gather"]
    with pytest.raises(ValueError):
        probes.gather(xb, ptr.long())
    with pytest.raises(ValueError, match="unsupported device"):
        probes.fori(torch.empty((64, 128), device="meta"))
    with pytest.raises(ValueError, match="CPU tensors"):
        probes.probe_host("fori", torch.empty((64, 128), device="meta"))


def _argument_cases(name):
    """Arguments of probe ``name`` that ``_check`` accepts (first) and
    ones it refuses, each way it can."""
    step = "bf16" if name in probes.BF16 else f"mini:{name}"
    good = probes.step_inputs(step)[name]
    x = good[0]
    other = torch.float32 if x.dtype != torch.float32 else torch.float64
    cases = [good, good + good[:1], (),
             (x.to(other),) + good[1:],
             (x[:, :0].contiguous(),) + good[1:],
             (x.reshape(-1),) + good[1:],
             (x.t(),) + good[1:],
             (x[:, :x.shape[1] // 2 + 1].contiguous(),) + good[1:],
             (x[:x.shape[0] // 2].contiguous(),) + good[1:]]
    if name == "gather":
        ptr = good[1]
        cases += [(x, ptr.long()), (x, ptr[:4].contiguous()), (x, ptr.t()),
                  (x, ptr.to("meta"))]
    return cases


@pytest.mark.parametrize("name", probes.PROBES)
def test_wrapper_checks_every_call(name):
    """Every call runs ``_check``: arguments it refuses raise the same
    error from the wrapper, and ones it accepts give the plain version's
    answer."""
    cases = _argument_cases(name)
    probes._check(name, cases[0])
    for args in cases:
        try:
            probes._check(name, args)
        except (TypeError, ValueError) as err:
            with pytest.raises(type(err), match=re.escape(str(err))):
                probes.WRAPPERS[name](*args)
            continue
        assert probes.differing(probes.PLAIN[name](*args),
                                probes.WRAPPERS[name](*args)) == 0


def test_probe_work_and_bounds():
    x = probes.mini_input()
    work = {name: kernel_work.probe_work(name, x) for name in probes.MINI}
    assert {work[n][0] for n in probes.MINI if n != "bcast"} == {262144}
    assert work["bcast"][0] == 163840
    # the sweeps' least work: g - 1 min-sums (5 operations) and one |.|
    # a group of g rows (test_sweeps_give_each_groups_least_magnitude)
    assert work["sweepcombo"][1] == 64 // 8 * 512 * (7 * 5 + 1)
    assert work["bigsweep"][1] == work["bigsweep_noloop"][1] == \
        512 * (63 * 5 + 1)
    for name, args in probes.bf16_inputs().items():
        assert kernel_work.probe_work(name, *args)[0] == 16384
    bound, by = kernel_work.bound_ms(*work["fori"])
    assert by == "bytes" and bound == pytest.approx(262144 / 3.35e9)
    for name in probes.MINI:
        assert kernel_work.bound_ms(*work[name])[1] == "bytes"


@pytest.mark.parametrize("seed", SEEDS)
def test_sweeps_give_each_groups_least_magnitude(seed):
    """The premise of the sweeps' work count: each group of rows that
    the stages pair inside (8 for ``k_sweepcombo``, the 64-row block for
    ``k_big``, whose scratch tiles it) ends as its least |x|, signed zeros
    included, whatever the sweeps."""
    x = probes.mini_input(seed)
    x[0, :4] = torch.tensor([0.0, -0.0, 0.0, -0.0])
    x[1:9, 4] = -0.0
    for name, g in kernel_work.PROBE_GROUP_ROWS.items():
        least = x.abs().view(64 // g, g, -1).amin(1, keepdim=True)
        want = least.expand(64 // g, g, x.shape[1]).reshape(x.shape)
        assert probes.differing(want.contiguous(),
                                probes.PLAIN[name](x)) == 0, name


def test_launch_counts_read_and_reset_every_probe():
    probes.reset_launch_counts()
    for i, name in enumerate(probes.PROBES):
        tracing.count(f"launch.probe.{name}", i + 1)
    assert probes.launch_counts() == {name: i + 1 for i, name
                                      in enumerate(probes.PROBES)}
    probes.reset_launch_counts()
    assert set(probes.launch_counts().values()) == {0}
    # the decoder kernels' counts leave the probes out
    assert not set(kernel_work.launch_counts()) & set(probes.PROBES)


def nan_bit_report():
    """Each stage sweep's elements whose bits differ from the script's
    kernel on each NaN input, and those that differ beyond a NaN's sign
    bit: one JSON line each, all 0 where the plain versions give JAX's
    bits."""
    ns = _script_kernels()
    for kind in ("zero_nan", "bits", "pairs"):
        x = _sweep_input(kind)
        for name in ("sweepcombo", "bigsweep_noloop", "bigsweep"):
            want = _bits(_jax_mini(ns, name, jnp.asarray(x.numpy())))
            got = _bits(probes.PLAIN[name](x))
            print(json.dumps({
                "probe": name, "input": kind,
                "differ": int((got != want).sum()),
                "beyond_sign": int(((got ^ want) & 0x7FFFFFFF != 0).sum()),
                "elements": int(got.size)}))


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_probes.py
    nan_bit_report()
