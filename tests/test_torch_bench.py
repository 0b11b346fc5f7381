"""The port's headline benchmark (``python -m polar_torch.bench``) against
the JAX package's ``bench.py``: the chain ``build_model`` builds equals
the one ``bench.py`` builds (frozen set, resolved sweep options, decoder
output bit for bit in min-sum, L=8), the JSON line the script prints on
the CPU, and ``time_steps``' error counts."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import polar_tpu as jpt

from _torch_parity import run_both
from polar_torch import bench
from polar_torch.sim import count_block_errors, count_errors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "vs_baseline", "ms_per_step", "bs",
        "iters", "lower_stages", "scl_subtree_launches", "device",
        "power_limit"}


def _jax_chain(k, n):
    """The chain ``bench.build_step`` builds at the leader configuration
    (fast SCL with rate-1 nodes), rebuilt with the same calls."""
    frozen, _ = jpt.generate_5g_ranking(k, n)
    enc = jpt.PolarEncoder(frozen, n)
    dec = jpt.PolarSCLDecoder(frozen, n, list_size=8, use_fast_scl=True,
                              fast_rate1=True)
    return frozen, enc, dec


@pytest.mark.parametrize("k,n", [(32, 64), (128, 256)])
def test_build_model_equals_bench_chain(k, n):
    frozen, j_enc, j_dec = _jax_chain(k, n)
    model = bench.build_model(k, n, device="cpu")
    dec = model.decoder
    np.testing.assert_array_equal(dec.frozen_pos, frozen)
    assert (dec.schedule, dec.use_fast_scl, dec.fast_rate1) == (
        j_dec.schedule, j_dec.use_fast_scl, j_dec.fast_rate1)
    assert dec.schedule == ("scan" if n >= 256 else "unrolled")
    assert (dec.mode, dec.list_size, model.k, model.n) == ("minsum", 8, k, n)
    rng = np.random.default_rng(n)
    u = rng.integers(0, 2, (16, k)).astype(np.float32)
    np.testing.assert_array_equal(*run_both(j_enc, model.encoder, u))
    logits = rng.normal(0.0, 4.0, (48, n)).astype(np.float32)
    np.testing.assert_array_equal(*run_both(j_dec, dec, logits))


def test_build_model_options():
    model = bench.build_model(32, 64, list_size=4, fast_scl=False,
                              lower_stages=3, device="cpu")
    dec = model.decoder
    assert (dec.list_size, dec.use_fast_scl, dec.fast_rate1,
            dec.lower_stages) == (4, False, False, 3)


def test_defaults_are_bench_py_defaults():
    """The flags' defaults are ``bench.py``'s, read from its source
    (importing it would touch the environment)."""
    with open(os.path.join(REPO, "bench.py")) as fh:
        src = fh.read()
    args = bench.parse_args([])
    assert (f"BASELINE_INFO_BPS = {bench.BASELINE_INFO_BPS}" in src)
    assert (f"k, n, L = {args.k}, {args.n}, {args.list_size}" in src)
    assert f'"BENCH_BS", "{args.bs}"' in src
    assert f'"BENCH_ITERS", "{args.iters}"' in src
    assert f"for i in range({args.warmup})" in src
    assert src.count(f"jnp.float32({args.ebno_db})") >= 3
    assert (args.fast_scl, args.rate1, args.lower_stages) == (1, 1, None)
    assert bench.metric_name(8, 1024) == "scl8_n1024_chain_info_bits_per_s"


def test_script_prints_one_json_line_on_cpu():
    k, bs, iters = 32, 64, 2
    out = subprocess.run(
        [sys.executable, "-m", "polar_torch.bench", "--device", "cpu",
         "--k", str(k), "--n", "64", "--bs", str(bs), "--iters",
         str(iters), "--warmup", "1"], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    row = json.loads(lines[0])
    assert set(row) == KEYS
    assert row["metric"] == "scl8_n64_chain_info_bits_per_s"
    assert (row["device"], row["power_limit"]) == ("cpu", None)
    assert (row["bs"], row["iters"], row["lower_stages"]) == (bs, iters, 6)
    assert row["scl_subtree_launches"] == 0 and row["unit"] == "info bit/s"
    want = k * bs * iters / (iters * row["ms_per_step"] / 1e3)
    assert row["value"] > 0 and abs(row["value"] - want) <= 0.05 + 1e-9 * want
    assert row["vs_baseline"] == round(row["value"]
                                       / bench.BASELINE_INFO_BPS, 2)
    assert "# complexity SCL-8" in out.stderr and "ber@2.0dB" in out.stderr


def test_time_steps_counts_equal_summed_counters():
    model = bench.build_model(32, 64, device="cpu")
    bs, ebno_db, warmup, iters = 64, 1.0, 1, 3
    step_s, errs, blk = bench.time_steps(
        model, torch.Generator().manual_seed(5), bs, ebno_db, warmup, iters)
    gen = torch.Generator().manual_seed(5)
    for _ in range(warmup):
        model.step(gen, bs, ebno_db)
    want_errs = want_blk = 0
    for _ in range(iters):
        b, b_hat = model.step(gen, bs, ebno_db)
        want_errs += count_errors(b, b_hat).item()
        want_blk += count_block_errors(b, b_hat).item()
    assert (errs, blk) == (want_errs, want_blk) and want_blk > 0
    assert step_s > 0
    with pytest.raises(ValueError):
        bench.time_steps(model, gen, bs, ebno_db, warmup, 0)


def test_launch_checks_raise():
    ok = {"scl_subtree": 3, "scl_subtree traced": 0, "scl_subtree wide": 0}
    bench.check_launches(ok, 8, True)
    for bad, L, fast in ((dict(ok, scl_subtree=0), 8, True),
                         (dict(ok, **{"scl_subtree traced": 3}), 8, True),
                         (dict(ok, **{"scl_subtree wide": 3}), 8, False)):
        with pytest.raises(RuntimeError):
            bench.check_launches(bad, L, fast)
    bench.check_launches(dict(ok, **{"scl_subtree traced": 3}), 8, False)
    bench.check_launches(dict(ok, **{"scl_subtree wide": 3}), 32, True)


def test_no_card_raises_without_cpu_flag():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--k", "32", "--n", "64", "--bs", "8", "--iters", "1"])
    assert bench.card_info(torch.device("cpu")) == ("cpu", None)


def test_launch_counts_read_and_reset_every_wrapper():
    from polar_torch.utils import tracing
    from polar_torch.utils.kernel_work import (launch_counts,
                                               reset_launch_counts)
    counters = [("launch.scl_subtree", "scl_subtree"),
                ("form.scl_subtree.traced", "scl_subtree traced"),
                ("form.scl_subtree.wide", "scl_subtree wide"),
                ("launch.sc_subtree", "sc_subtree"),
                ("launch.bp", "bp"),
                ("form.bp.bf16", "bp bf16"),
                ("launch.butterfly_rows", "butterfly_rows"),
                ("launch.qpsk_front", "qpsk_front")]
    reset_launch_counts()
    for i, (name, _) in enumerate(counters):
        tracing.count(name, i + 1)
    assert launch_counts() == {key: i + 1
                               for i, (_, key) in enumerate(counters)}
    reset_launch_counts()
    assert set(launch_counts().values()) == {0}
