"""The polar_torch CLI: configuration parsing, the RM-style construction
and the complexity meter against polar_tpu's, and ``main`` and ``sweep``
(SC, SCL and BP) end to end on the CPU (as ``tests/test_config.py`` holds
the JAX CLI's parsing)."""

import dataclasses
import os

import numpy as np
import pytest

from polar_tpu.config import parse_config as j_parse_config
from polar_tpu.models.polar.construction import (
    get_kern_frozen_bits as j_get_kern_frozen_bits)
from polar_tpu.utils import profiling as jprof

from polar_torch import main as tmain
from polar_torch.config import PolarConfig, parse_config
from polar_torch.models.polar.construction import (ARIKAN_F2, gen_arikan,
                                                   generate_5g_ranking,
                                                   get_kern_frozen_bits)
from polar_torch.utils import profiling as tprof

ARGVS = [
    [],
    ["--algos", "[scl]"],
    ["--algos", "[scl,bp]", "--verbose", "true"],
    ["--algos", "scl", "--verbose", "0", "--fast_scl", "true"],
    ["--fast_scl", "false", "--k", "128", "--n", "256", "--snr_end", "3.5"],
    ["--construction", "5g", "--mode", "llr", "--bs", "8192",
     "--target_block_errs", "100", "--seed", "3"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "none")
def test_parse_config_equals_jax(argv):
    got = dataclasses.asdict(parse_config(argv))
    assert got.pop("device") == "cuda"
    assert got == dataclasses.asdict(j_parse_config(argv))


def test_device_field():
    assert parse_config(["--device", "cpu"]).device == "cpu"
    assert isinstance(parse_config([]), PolarConfig)
    assert parse_config([]).fast_scl is None


@pytest.mark.parametrize("n", [64, 256, 1024])
def test_get_kern_frozen_bits_equals_jax(n):
    for f_num in (0, n // 4, n // 2, n - 1):
        for got, want in zip(get_kern_frozen_bits(n, f_num),
                             j_get_kern_frozen_bits(n, f_num)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gen_arikan(ARIKAN_F2, 1), ARIKAN_F2)
    with pytest.raises(ValueError):
        get_kern_frozen_bits(3 * n // 2, 1)


def _mask(k, n):
    mask = np.zeros(n, bool)
    mask[generate_5g_ranking(k, n)[0]] = True
    return mask


@pytest.mark.parametrize("case", ["sc", "plain_scl", "fast_scl", "rate1"])
def test_decode_complexity_equals_jax(case):
    n, k = 1024, 512
    kw = {"sc": dict(list_size=1),
          "plain_scl": dict(list_size=8),
          "fast_scl": dict(list_size=8, fast=True, frozen_mask=_mask(k, n)),
          "rate1": dict(list_size=8, fast=True, rate1=True,
                        frozen_mask=_mask(k, n))}[case]
    got = tprof.decode_complexity(n, k, **kw)
    want = jprof.decode_complexity(n, k, **kw)
    assert got.as_dict() == want.as_dict()
    assert (tprof.complexity_line(case, got)
            == jprof.complexity_line(case, want))
    assert (tprof.bp_complexity(n, k, 20).as_dict()
            == jprof.bp_complexity(n, k, 20).as_dict())


def test_main_runs_and_saves_its_plot(tmp_path, capsys):
    c = parse_config(["--k", "32", "--n", "64", "--algos", "[scl]", "--bs",
                      "100", "--mc_iter", "1", "--device", "cpu",
                      "--plot_dir", str(tmp_path)])
    out = tmain.main(c)
    assert os.path.isfile(out) and out.startswith(str(tmp_path))
    text = capsys.readouterr().out
    for line in ("Running: SC", "Running: SCL-8", "# complexity SC:",
                 "# complexity SCL-8:", f"saved plot to {out}"):
        assert line in text


def test_sweep_5g_curves_and_decoders():
    c = PolarConfig(k=32, n=64, construction="5g", bs=64, mc_iter=1,
                    device="cpu")
    plot = tmain.sweep(c, ebno_dbs=[1.0, 2.0])
    assert plot.legend == ["SC", "SC (BLER)", "SCL-8", "SCL-8 (BLER)"]
    assert all(len(curve) == 2 for curve in plot.ber)
    model, _ = tmain.gen_code(c, "SCL-8", mode="scl")
    assert model.decoder.use_fast_scl and model.k == 32
    model, _ = tmain.gen_code(dataclasses.replace(c, n=256, k=128), "SCL-8",
                              mode="scl")
    assert not model.decoder.use_fast_scl


def test_sweep_with_bp_runs_sc_scl_and_bp(capsys):
    """``--algos [scl,bp]``: SC, SCL-8 and BP-20 curves, each with its
    complexity line (BP's from ``bp_complexity``, as the JAX CLI prints)."""
    c = PolarConfig(k=32, n=64, construction="5g", bs=64, mc_iter=1,
                    algos=["scl", "bp"], device="cpu")
    plot = tmain.sweep(c, ebno_dbs=[1.0, 3.0])
    assert plot.legend == ["SC", "SC (BLER)", "SCL-8", "SCL-8 (BLER)",
                           "BP-20", "BP-20 (BLER)"]
    assert all(len(curve) == 2 for curve in plot.ber)
    bp_bler = np.asarray(plot.ber[5])
    assert np.all((0 <= bp_bler) & (bp_bler <= 1)) and bp_bler[1] < 0.5
    text = capsys.readouterr().out
    want = jprof.complexity_line("BP-20", jprof.bp_complexity(64, 32, 20))
    assert "Running: BP-20" in text and want in text
    model, _ = tmain.gen_code(c, "BP-20", mode="bp")
    dec = model.decoder
    assert (dec.num_iter, dec.mode, dec.msf) == (20, "minsum", 0.9375)
    assert dec.early_stop and dec.check_every == 2


@pytest.mark.parametrize("change,item", [
    ({"kern": "F3"}, "Queue 1 item 14"),
    ({"construction": "rm-ref"}, "Queue 1 item 14"),
    ({"construction": "ga"}, "Queue 1 item 14"),
    ({"num_devices": 2}, "Queue 1 item 16"),
])
def test_cli_raises_for_later_slices(change, item):
    c = dataclasses.replace(PolarConfig(device="cpu"), **change)
    with pytest.raises(NotImplementedError, match=item):
        tmain.sweep(c, ebno_dbs=[1.0])
