"""BENCHMARK.json against the benchmark's contract, and the files it
names."""

import json
import os
import re

import pytest

from portbench import harness

ROOT = harness.ROOT
MAN = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_check_budget_fits_full_24_cells():
    per_cell = 14 * (MAN["run_seconds"] + 60) + 2 * 90
    assert 2 * (MAN["run_seconds"] + 60) + 24 * per_cell + 1200 <= 43200


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_configs_exist_and_are_used():
    used = {w["config"] for w in MAN["workloads"]}
    files = set()
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert c["reduced"] == [] and cfg["precision"] == "float32"
        for kind in ("systems", "reference"):
            assert os.path.exists(os.path.join(
                harness.HERE, kind, cfg["system"] + ".py"))


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_workload_files(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and _line(w["why"])
    _, _, cfg, traffic, limits = harness.cell_spec(w["name"])
    from portbench.compare import NAMES
    assert set(limits) == set(NAMES)
    for key in ("ebno_db", "batch_size", "batches_per_chunk",
                "sampled_chunks", "warmup_chunks", "trace_chunks"):
        assert key in traffic
    e2e = harness.cell_metrics(MAN, w["name"], False)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert harness.cell_metrics(MAN, w["name"], True)


def test_pairs_and_names_unique():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("m", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries_and_readers(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    # a reader of its own, or its base's where the name only sets it apart
    base = m["name"]
    while not os.path.exists(os.path.join(harness.HERE, "metrics",
                                          base + ".py")):
        base = base.rsplit(".", 1)[0]
        assert base in [e["name"] for e in MAN["end_to_end"]
                        + MAN["per_layer"]]
    assert callable(harness.reader(m["name"]))
    if m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in [e["name"] for e in MAN["end_to_end"]]
        assert _line(m["layer"])
