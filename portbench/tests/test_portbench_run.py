"""Whole runs of the command on the CPU at tiny batches: the last line's
shape, the exits that print no result, and faults planted in the timed
path and the control in the program's place, each judged not correct."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness, reference
from portbench.systems import polar_awgn

ROOT = harness.ROOT
CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]


def command(*args, cwd=ROOT):
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          capture_output=True, text=True, cwd=cwd,
                          timeout=600)


@pytest.mark.parametrize("trace", ["0", "1"])
def test_last_line_of_a_cpu_run(trace):
    out = command("--workload", "uci_a19_e864.deep_point", "--seed",
                  str(2 ** 31 + 77), "--seconds", "0.5", "--trace", trace,
                  "--device", "cpu", "--batch-size", "16")
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 8
    assert res["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0}
    if trace == "0":
        assert set(res["metrics"]) == {"info_bps.launch_paced",
                                       "batch_ms_p95.launch_paced",
                                       "setup_s"}
        for m in res["metrics"].values():
            assert m["value"] > 0
    else:
        # no card: the device readers find nothing and stay silent
        assert res["metrics"] == {}
    lines = out.stderr.strip().splitlines()
    assert lines[-1] == "correct True"
    checks = [ln for ln in lines[-6:-1] if ln.startswith("check ")]
    assert len(checks) == len(res["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_no_card_no_result(cell):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = command("--workload", cell, "--seed", "1", "--seconds", "1")
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_no_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = command("--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                  "--device", "cpu", "--batch-size", "8", cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


# ---- faults planted in the timed path, and the control ----
def _run(build):
    return harness.run_cell("uci_a19_e864.deep_point", 2 ** 31 + 3, 0.3,
                            False, device="cpu",
                            overrides={"batch_size": 32,
                                       "batches_per_chunk": 2,
                                       "warmup_chunks": 1},
                            build=build, log=lambda m: None, age=0.0)


def test_sound_run_is_correct():
    assert _run(None)["correct"] is True


def _stale(cfg, dev):
    model = polar_awgn.build(cfg, dev)
    front, first = model.front, []

    def stale_front(generator, batch_size, ebno_db):
        out = front(generator, batch_size, ebno_db)
        if not first:
            first.append(out)
        return first[0]                    # the step's state never moves
    model.front = stale_front
    return model


def _half(cfg, dev):
    model = polar_awgn.build(cfg, dev)

    def half_step(generator, batch_size, ebno_db):
        bits, _, llr = model.front(generator, batch_size, ebno_db)
        h = batch_size // 2
        return bits[:h], model.decoder(llr[:h])   # the rest left out
    model.step = half_step
    return model


def _altered(cfg, dev):
    model = polar_awgn.build(cfg, dev)
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


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size_on_card(card, cell):
    # the control's reading at the cell's own size, as portbench/control.py
    # takes it: the bf16 reference in the program's place is not correct
    from portbench import compare
    from portbench.control import control_sample
    _, _, cfg, traffic, limits = harness.cell_spec(cell)
    checks = compare.judge([control_sample(cfg, traffic, 2 ** 31 + 99,
                                           card)], cfg, traffic, card)
    assert any(v["value"] > limits[k] for k, v in checks.items())
