"""The port's walkthroughs (``examples/torch_0*.py``) run on the CPU at
tiny sizes and print their result lines, and the ``polar-torch`` console
script names the port's CLI entry point."""

import importlib
import os
import re
import subprocess
import sys
import tomllib

import pytest

import _torch_parity  # noqa: F401 (caps torch's threads under xdist)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (script, arguments after --device cpu, result lines it must print)
EXAMPLES = [
    ("torch_01_bler_sweep.py",
     ["--k", "32", "--n", "64", "--batch-size", "32", "--max-mc-iter", "1"],
     [r"^SC: BER  \[", r"^SC: BLER \[", r"^SCL-8: BLER \[",
      r"^BP-20: BLER \[", r"^kernel launches: \{"]),
    ("torch_02_5g_chain.py", ["--batch-size", "4"],
     [r"^BER \d\.\d{5}; CRC pass rate \d\.\d{3}$",
      r"^hybSCL BER \d\.\d{5}$", r"^kernel launches: \{"]),
    ("torch_03_multichip.py",
     ["--world", "2", "--batch-size", "16", "--max-mc-iter", "1"],
     [r"^world of 2 \(gloo\), rank 0 on cpu$", r"^BER :", r"^BLER:",
      r"^kernel launches \(rank 0\): \{"]),
    ("torch_04_osd_any_linear_code.py", ["--batch-size", "32"],
     [r"^OSD-2 codeword BER \d\.\d{5}  \(SCL-8 info BER \d\.\d{5}\)$",
      r"^kernel launches: \{"]),
]


def _run_example(script, args, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", script),
         "--device", "cpu", *args], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=timeout)


@pytest.mark.parametrize("script,args,lines", EXAMPLES,
                         ids=[e[0][:8] for e in EXAMPLES])
def test_example_runs_on_cpu(script, args, lines):
    out = _run_example(script, args)
    assert out.returncode == 0, out.stderr[-3000:]
    for pattern in lines:
        assert re.search(pattern, out.stdout, re.M), (pattern, out.stdout)
    if script.startswith("torch_03"):
        # rank 0 alone prints the summed counters
        assert out.stdout.count("BLER:") == 1


def test_bler_sweep_writes_png_on_request(tmp_path):
    pytest.importorskip("matplotlib")
    png = tmp_path / "sweep.png"
    out = _run_example("torch_01_bler_sweep.py",
                       ["--k", "16", "--n", "32", "--batch-size", "16",
                        "--max-mc-iter", "1", "--png", str(png)])
    assert out.returncode == 0, out.stderr[-3000:]
    assert png.stat().st_size > 0 and f"wrote {png}" in out.stdout


def test_examples_cover_the_jax_walkthroughs():
    jax_examples = sorted(fn for fn in os.listdir(os.path.join(REPO,
                                                               "examples"))
                          if re.match(r"0\d_.*\.py$", fn))
    assert [f"torch_{fn}" for fn in jax_examples] == [e[0] for e in EXAMPLES]


def test_console_script_names_the_port_cli():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fh:
        scripts = tomllib.load(fh)["project"]["scripts"]
    assert scripts["polar-tpu"] == "polar_tpu.main:main"
    module, attr = scripts["polar-torch"].split(":")
    target = getattr(importlib.import_module(module), attr)
    from polar_torch.main import main
    assert callable(target) and target is main
