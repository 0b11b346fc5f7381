"""The BP-20 cell (``bp20_n1024.wide_batch``): its files, whole runs on the
CPU at tiny batches, faults planted in the program's place, and the two
readers it adds (``kernel.bp.roofline_pct``, ``bp.sweeps_per_cw``).

A BP decode whose G-matrix check never passes ends where its min-sum
dynamics leave it after 20 sweeps, and that end moves with the last bit
of the channel LLRs. The comparison decodes the reference on its own
LLRs, which differ from the program's by an ulp or so, so about a tenth
of the blocks at 2.0 dB differ on a sound program (``PERF.md`` §2): the
limit on ``blocks_differ_share`` holds at the cell's 131072 sampled
blocks, and a run of a few dozen blocks reads it within a wide spread.
The runs here that must be correct run at 3.0 dB, where nearly every
block converges."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import compare, harness, reference, work
from portbench.reference import polar_bp as ref_bp
from portbench.systems import polar_bp
from portbench.trace import Slice

CELL = "bp20_n1024.wide_batch"
ROOT = harness.ROOT
MAN = harness.load_manifest()
SMALL = {"system": "polar_bp", "code": "5g_ranked", "k": 32, "n": 64,
         "decoder": "bp", "num_iter": 20, "mode": "minsum", "msf": 0.9375,
         "early_stop": True, "check_every": 2, "llr_max": 30.0}


def test_manifest_finds_the_cells_files():
    _, wl, cfg, traffic, limits = harness.cell_spec(CELL)
    assert wl["config"] == "nr_k512_n1024_bp20" and wl["chips"] == 1
    assert cfg["system"] == "polar_bp" and cfg["decoder"] == "bp"
    assert (cfg["k"], cfg["n"], cfg["num_iter"], cfg["check_every"]) == \
        (512, 1024, 20, 2)
    assert traffic["ebno_db"] == 2.0 and traffic["batch_size"] == 65536
    assert traffic["batches_per_chunk"] == 2
    assert 0 < limits["blocks_differ_share"] < 1
    e2e = [m["name"] for m in harness.cell_metrics(MAN, CELL, False)]
    assert e2e == ["info_bps", "batch_ms_p95", "setup_s"]
    per_layer = [m["name"] for m in harness.cell_metrics(MAN, CELL, True)]
    assert {"kernel.bp.roofline_pct", "bp.sweeps_per_cw", "step.decode_ms",
            "device.idle_pct"} <= set(per_layer)
    assert "kernel.scl.roofline_pct" not in per_layer
    for name in per_layer:
        assert callable(harness.reader(name))


def command(*args):
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=600)


@pytest.mark.parametrize("trace", ["0", "1"])
def test_last_line_of_a_cpu_run(trace):
    out = command("--workload", CELL, "--seed", str(2 ** 31 + 77),
                  "--seconds", "0.3", "--trace", trace, "--device", "cpu",
                  "--batch-size", "16")
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks" and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"
    checks = res["checks"]
    # the numbers that do not hang on BP's unconverged blocks hold exactly
    for name in ("bits_differ", "codeword_bits_differ", "counts_differ"):
        assert checks[name]["value"] == 0
    assert checks["llr_err"]["value"] < checks["llr_err"]["limit"]
    assert res["correct"] is all(c["value"] <= c["limit"]
                                 for c in checks.values())
    if trace == "0":
        assert set(res["metrics"]) == {"info_bps", "batch_ms_p95",
                                       "setup_s"}
    else:
        # no card: only the program's own counter has something to read
        assert set(res["metrics"]) == {"bp.sweeps_per_cw"}
        assert 2 <= res["metrics"]["bp.sweeps_per_cw"]["value"] <= 20


def _run(build, ebno_db=3.0):
    return harness.run_cell(CELL, 2 ** 31 + 3, 0.2, False, device="cpu",
                            overrides={"batch_size": 48,
                                       "batches_per_chunk": 2,
                                       "warmup_chunks": 1,
                                       "reference_rows": 48,
                                       "ebno_db": ebno_db},
                            build=build, log=lambda m: None, age=0.0)


def test_sound_run_is_correct():
    res = _run(None)
    assert res["correct"] is True
    assert res["checks"]["blocks_differ_share"]["value"] <= 0.05


def _channel_side(cfg, dev):
    """Decisions read off the channel LLRs at the info positions."""
    model = polar_bp.build(cfg, dev)
    info = torch.as_tensor(model.decoder.info_pos, device=dev)

    def decoder(llr):
        return (llr[:, info] > 0).to(torch.float32)
    model.decoder = decoder
    return model


class _ReferenceInPlace:
    """The plain reference in bfloat16, in the program's place."""

    def __init__(self, cfg, dev):
        self.device = dev
        self.link = reference.link(cfg, dev, torch.bfloat16)

    def front(self, generator, batch_size, ebno_db):
        bits, cw, llr = self.link.front(generator.initial_seed(),
                                        batch_size, ebno_db, torch.bfloat16)
        return bits.float(), cw, llr

    def decoder(self, llr):
        return self.link.decode(llr).float()

    def step(self, generator, batch_size, ebno_db):
        bits, _, llr = self.front(generator, batch_size, ebno_db)
        return bits, self.decoder(llr)


@pytest.mark.parametrize("fault", ["channel_side", "control"])
def test_fault_is_not_correct(fault):
    build = {"channel_side": _channel_side,
             "control": _ReferenceInPlace}[fault]
    res = _run(build, ebno_db=2.0)
    assert res["correct"] is False
    failed = [k for k, v in res["checks"].items() if v["value"] > v["limit"]]
    expect = {"channel_side": "blocks_differ_share",
              "control": "llr_err"}[fault]
    assert expect in failed


@pytest.mark.gpu
@pytest.mark.parametrize("num_iter", [20, 19])
def test_one_sweep_fewer_is_not_correct_at_the_cells_size_on_card(
        card, num_iter):
    # one chunk of the cell's own size (131072 blocks), judged as a run
    # judges it: a sound program reads about 0.102, one that stops a sweep
    # short about 0.120 (PERF.md section 2)
    _, _, cfg, traffic, limits = harness.cell_spec(CELL)
    tap = harness.Tap(polar_bp.build(dict(cfg, num_iter=num_iter), card))
    tap.hold = True
    sample = harness.Reservoir(1, 7)
    harness.run_chunks(tap, traffic, 2 ** 31 + 101, 0, 1, sample)
    tap.detach()
    checks = compare.judge(sample.items, cfg, traffic, card)
    assert all(v["value"] <= limits[k] for k, v in checks.items()) is \
        (num_iter == 20)


def test_bfloat16_reference_decides_otherwise():
    link32 = ref_bp.Link(SMALL, "cpu")
    link16 = ref_bp.Link(SMALL, "cpu", torch.bfloat16)
    _, _, llr = link32.front(2 ** 31 + 9, 256, 1.0, torch.float64)
    assert bool((link32.decode(llr) != link16.decode(llr)).any())


# ---- the readers ----
def _ctx(slice_=None, cfg=SMALL):
    ctx = harness.Ctx()
    ctx.cfg, ctx.traffic = cfg, {"batch_size": 1000, "ebno_db": 1.0}
    ctx.slice, ctx.power_limit = slice_, None
    return ctx


def test_roofline_reader():
    assert harness.reader("kernel.bp.roofline_pct")(_ctx()) is None
    no_bp = Slice([("scl_subtree_kernel<8,false>", 0.0, 0.001)], [], 0.0,
                  0.01, 1)
    assert harness.reader("kernel.bp.roofline_pct")(_ctx(no_bp)) is None
    # 4 ms of the BP kernel over 2 batches: 2 ms a batch
    sl = Slice([("void polar_torch::bp_kernel<1, true, false>", 0.001,
                 0.003), ("elementwise", 0.003, 0.004),
                ("void polar_torch::bp_kernel<1, true, false>", 0.005,
                 0.007)], [], 0.0, 0.01, 2)
    link = ref_bp.Link(SMALL, "cuda" if torch.cuda.is_available() else
                       "cpu")
    bound = work.bound_ms(*link.decode_work(1000, 1.0))[0]
    assert harness.reader("kernel.bp.roofline_pct")(_ctx(sl)) == \
        pytest.approx(100 * bound / 2.0)


@pytest.fixture
def summary(monkeypatch):
    from polar_torch.utils import tracing

    def plant(s):
        monkeypatch.setattr(tracing, "summary", lambda: s)
    return plant


def test_sweeps_reader(summary):
    read = harness.reader("bp.sweeps_per_cw")
    summary(None)
    assert read(None) is None
    summary({"events": True})          # a program without the counter
    assert read(None) is None
    summary({"events": True, "device_counters": {}})
    assert read(None) is None
    summary({"events": True, "device_counters": {
        "sweeps.bp": {"sum": 0, "items": 0}}})
    assert read(None) is None
    summary({"events": False, "device_counters": {
        "sweeps.bp": {"sum": 350, "items": 30},
        "converged.bp": {"sum": 27, "items": 30}}})
    assert read(None) == pytest.approx(350 / 30)


def test_sweeps_reader_without_a_program(tmp_path):
    # a checkout with the benchmark's files and no program: the reader
    # finds no module and stays silent
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import harness\n"
            "print(harness.reader('bp.sweeps_per_cw')(None))" % ROOT)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c",
                          "import sys; sys.modules['polar_torch'] = None\n"
                          + code], capture_output=True, text=True,
                         cwd=tmp_path, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "None"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench.reference import polar_bp\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(eval(out.stdout.strip()))
    assert not names & {"polar_torch", "polar_tpu", "jax", "jaxlib"}


def test_reference_mean_sweeps_at_the_cells_point():
    # the work's sweeps come from a fixed batch, whatever decodes the cell
    link = ref_bp.Link(SMALL, "cpu")
    a = link.mean_sweeps(2.0, blocks=128)
    b = link.mean_sweeps(2.0, blocks=128)
    assert a == b and 2 <= a[0] <= 20
    assert np.isfinite(a[1])
