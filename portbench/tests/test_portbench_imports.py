"""No JAX anywhere the benchmark runs, and a reference that stands alone.

Each check imports in a fresh interpreter and compares the top-level name
of every loaded module (the part before the first dot) whole: the
program's ``polar_torch`` begins with the JAX package's first letters and
must not match it."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "polar_tpu"}
ROOT = harness.ROOT


def loaded_after(code):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, %r)\n%s\n"
         "import json; print(json.dumps(sorted({m.split('.')[0] for m in "
         "sys.modules})))" % (ROOT, code)],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_top_level_names_compare_whole():
    assert "polar_torch".split(".")[0] not in FORBIDDEN
    assert "polar_tpu.models".split(".")[0] in FORBIDDEN


def test_benchmark_and_program_import_no_jax():
    readers = "; ".join(
        f"harness.reader({m['name']!r})"
        for m in harness.load_manifest()["end_to_end"]
        + harness.load_manifest()["per_layer"])
    names = loaded_after(
        "from portbench import harness, compare, control, trace, work\n"
        "import portbench.run\n"
        "from portbench.systems import polar_awgn\n"
        "import polar_torch, polar_torch.sim, polar_torch.models.systems\n"
        + readers)
    assert "polar_torch" in names and "torch" in names
    assert not names & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    names = loaded_after(
        "from portbench.reference import channel, nr, polar_awgn, scl\n"
        "from portbench import compare, work")
    assert not names & (FORBIDDEN | {"polar_torch"})


@pytest.mark.parametrize("module", ["jax", "polar_tpu.models"])
def test_a_loaded_forbidden_module_is_found(monkeypatch, module):
    monkeypatch.setitem(sys.modules, module, object())
    assert harness.forbidden_modules() == [module.split(".")[0]]
