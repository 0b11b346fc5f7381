"""The SC cell (``sc_n1024.wide_batch``): its files, whole runs on the CPU
at tiny batches, faults planted in the program's place, and the two
readers it adds (``kernel.sc.roofline_pct``, ``sc.glue_ms``).

Min-sum SC decides each bit from a sign after exact f's and once-rounded
g's, so the program and the reference decide alike on the same LLRs; the
comparison decodes the reference on its own LLRs, which differ from the
program's by an ulp or so, so a sound run reads ``blocks_differ_share``
at or near 0 (``PERF.md`` section 2)."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness, reference, work
from portbench.reference import polar_sc as ref_sc
from portbench.systems import polar_sc
from portbench.trace import Slice

CELL = "sc_n1024.wide_batch"
ROOT = harness.ROOT
MAN = harness.load_manifest()
SMALL = {"system": "polar_sc", "code": "5g_ranked", "k": 32, "n": 64,
         "decoder": "sc", "mode": "minsum", "llr_max": 30.0}


def test_manifest_finds_the_cells_files():
    _, wl, cfg, traffic, limits = harness.cell_spec(CELL)
    assert wl["config"] == "nr_k512_n1024_sc" and wl["chips"] == 1
    assert wl["traffic"] == "point_2.0dB_bs65536"
    assert cfg["system"] == "polar_sc" and cfg["decoder"] == "sc"
    assert (cfg["k"], cfg["n"], cfg["mode"]) == (512, 1024, "minsum")
    assert "lower_stages" not in cfg
    assert traffic["ebno_db"] == 2.0 and traffic["batch_size"] == 65536
    assert 0 < limits["blocks_differ_share"] < 1
    e2e = [m["name"] for m in harness.cell_metrics(MAN, CELL, False)]
    assert e2e == ["info_bps", "batch_ms_p95", "setup_s"]
    per_layer = [m["name"] for m in harness.cell_metrics(MAN, CELL, True)]
    assert per_layer == ["harness.gap_ms", "step.front_ms", "step.decode_ms",
                         "device.idle_pct", "kernel.sc.roofline_pct",
                         "sc.glue_ms"]
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
    assert res["correct"] is True
    assert res["device"]["platform"] == "cpu"
    assert all(c["value"] == 0 for k, c in res["checks"].items()
               if k != "llr_err")
    if trace == "0":
        assert set(res["metrics"]) == {"info_bps", "batch_ms_p95",
                                       "setup_s"}
    else:
        # no card: no events and no profile, so every reader stays silent
        assert res["metrics"] == {}


def _run(build):
    return harness.run_cell(CELL, 2 ** 31 + 3, 0.2, False, device="cpu",
                            overrides={"batch_size": 48,
                                       "batches_per_chunk": 2,
                                       "warmup_chunks": 1,
                                       "reference_rows": 48},
                            build=build, log=lambda m: None, age=0.0)


def test_sound_run_is_correct():
    res = _run(None)
    assert res["correct"] is True
    assert res["checks"]["blocks_differ_share"]["value"] == 0


def _stale(cfg, dev):
    model = polar_sc.build(cfg, dev)
    front, first = model.front, []

    def stale_front(generator, batch_size, ebno_db):
        out = front(generator, batch_size, ebno_db)
        if not first:
            first.append(out)
        return first[0]                    # the step's state never moves
    model.front = stale_front
    return model


def _half(cfg, dev):
    model = polar_sc.build(cfg, dev)

    def half_step(generator, batch_size, ebno_db):
        bits, _, llr = model.front(generator, batch_size, ebno_db)
        h = batch_size // 2
        return bits[:h], model.decoder(llr[:h])   # the rest left out
    model.step = half_step
    return model


def _altered(cfg, dev):
    model = polar_sc.build(cfg, dev)
    decoder = model.decoder

    def altered(llr):
        out = decoder(llr).clone()
        out[::16, 0] = 1.0 - out[::16, 0]     # an answer altered
        return out
    model.decoder = altered
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


@pytest.mark.parametrize("fault", ["stale", "half", "altered", "control"])
def test_fault_is_not_correct(fault):
    build = {"stale": _stale, "half": _half, "altered": _altered,
             "control": _ReferenceInPlace}[fault]
    res = _run(build)
    assert res["correct"] is False
    failed = [k for k, v in res["checks"].items() if v["value"] > v["limit"]]
    expect = {"stale": "bits_differ", "half": "counts_differ",
              "altered": "blocks_differ_share", "control": "llr_err"}[fault]
    assert expect in failed


def test_bfloat16_reference_decides_otherwise():
    link32 = ref_sc.Link(SMALL, "cpu")
    link16 = ref_sc.Link(SMALL, "cpu", torch.bfloat16)
    _, _, llr = link32.front(2 ** 31 + 9, 256, 1.0, torch.float64)
    assert bool((link32.decode(llr) != link16.decode(llr)).any())


# ---- the readers ----
def _ctx(slice_=None, cfg=SMALL):
    ctx = harness.Ctx()
    ctx.cfg, ctx.traffic = cfg, {"batch_size": 1000, "ebno_db": 1.0}
    ctx.slice, ctx.power_limit = slice_, None
    return ctx


def test_roofline_reader():
    read = harness.reader("kernel.sc.roofline_pct")
    assert read(_ctx()) is None
    no_sc = Slice([("void polar_torch::scl_subtree_kernel<8, false>", 0.0,
                    0.001)], [], 0.0, 0.01, 1)
    assert read(_ctx(no_sc)) is None
    # 3 ms of the SC kernel over 2 batches: 1.5 ms a batch; the SCL
    # kernel's 4 ms beside it are not counted
    sl = Slice([("void polar_torch::sc_subtree_kernel<8>(ScArgs)", 0.001,
                 0.002), ("void polar_torch::scl_subtree_kernel<8, false>",
                          0.002, 0.006),
                ("void polar_torch::sc_subtree_kernel<8>(ScArgs)", 0.007,
                 0.009)], [], 0.0, 0.01, 2)
    bound = work.bound_ms(*ref_sc.Link(SMALL, "cpu").decode_work(1000))[0]
    assert read(_ctx(sl)) == pytest.approx(100 * bound / 1.5)


def _row(name, parent, batch, dev, **counts):
    return dict(name=name, parent=parent, batch=batch, host_ms=0.5,
                device_ms=dev, ops=0, cpu_ops=0, counts=counts)


def fixed_table(events=True):
    # two timed batches after the counted one: the sweep 9 ms on the
    # device, 2 x 3 of them in two subtree calls
    rows = []
    for b in (7, 8, 9):
        dev = (lambda v: v) if events else (lambda v: None)
        i = len(rows)
        rows += [_row("sim.step", None, b, dev(20.0)),
                 _row("chain.decode", i, b, dev(11.0)),
                 _row("sc.sweep", i + 1, b, dev(9.0),
                      **{"rows.sc.top": 1024}),
                 _row("kernel.sc_subtree", i + 2, b, dev(3.0),
                      **{"launch.sc_subtree": 1}),
                 _row("kernel.sc_subtree", i + 2, b, dev(3.0),
                      **{"launch.sc_subtree": 1})]
    from polar_torch.utils import tracing
    return tracing.summarize(rows, counted=7)


@pytest.fixture
def summary(monkeypatch):
    from polar_torch.utils import tracing

    def plant(s):
        monkeypatch.setattr(tracing, "summary", lambda: s)
    return plant


def test_glue_reader(summary, capsys):
    read = harness.reader("sc.glue_ms")
    table = fixed_table()
    assert table["spans"]["sc.sweep"]["rows.sc.top"] == 1024
    summary(table)
    assert read(None) == pytest.approx(3.0)
    # the span table goes to standard error
    err = capsys.readouterr().err
    assert err.count("sc.sweep") == 1 and "counter rows.sc.top 1024" in err
    summary(None)
    assert read(None) is None
    summary(fixed_table(events=False))
    assert read(None) is None
    # a session that ran no SC sweep
    rows = [_row("sim.step", None, b, 1.0) for b in (1, 2)]
    from polar_torch.utils import tracing
    summary(tracing.summarize(rows, counted=1))
    assert read(None) is None


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench.reference import polar_sc\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(eval(out.stdout.strip()))
    assert not names & {"polar_torch", "polar_tpu", "jax", "jaxlib"}
