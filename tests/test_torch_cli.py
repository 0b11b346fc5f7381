"""The polar_torch CLI: configuration parsing, the constructions (``rm``,
``rm-ref``, ``ga``, ``5g``, over any kernel of the zoo) and the complexity
meter against polar_tpu's, and ``main`` and ``sweep`` (SC, SCL, BP, and
dense-G OSD for ``--kern``) end to end on the CPU (as
``tests/test_config.py`` holds the JAX CLI's parsing)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_tpu import native as j_native
from polar_tpu.config import PolarConfig as j_PolarConfig
from polar_tpu.config import parse_config as j_parse_config
from polar_tpu.main import gen_code as j_gen_code
from polar_tpu.models.osd import OSDecoder as JOSDecoder
from polar_tpu.models.polar.construction import (
    get_kern_frozen_bits as j_get_kern_frozen_bits)
from polar_tpu.models.polar.encode import PolarEncoder as JPolarEncoder
from polar_tpu.utils import profiling as jprof

from _torch_parity import assert_osd_agrees
from polar_torch import from_numpy_state
from polar_torch import main as tmain
from polar_torch.config import PolarConfig, parse_config
from polar_torch.models.osd import OSDecoder
from polar_torch.models.polar.dense import DenseKernelDecoder
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


@pytest.mark.parametrize("change,error,match", [
    ({"kern": "F3"}, KeyError, "unknown kernel"),
    ({"num_devices": 2}, None, None),
])
def test_cli_raises_for_later_slices(change, error, match):
    """An unknown kernel raises as ``get_kernel`` does. ``num_devices``,
    once left to a later slice, is unread, as in the JAX CLI (data-parallel
    runs go through ``parallel.ShardedSystem``): the sweep equals the one
    with ``num_devices=1``."""
    c = dataclasses.replace(PolarConfig(device="cpu"), **change)
    if error is not None:
        with pytest.raises(error, match=match):
            tmain.sweep(c, ebno_dbs=[1.0])
        return
    c = dataclasses.replace(c, k=16, n=32, bs=64, mc_iter=2)
    one = dataclasses.replace(c, num_devices=1)
    got, want = (tmain.sweep(x, ebno_dbs=[1.0, 2.0]) for x in (c, one))
    assert got.legend == want.legend and len(got.ber) == 4   # SC, SCL-8
    np.testing.assert_array_equal(np.asarray(got.ber), np.asarray(want.ber))


def test_kern_cli_runs_dense_osd_and_saves_its_plot(tmp_path, capsys):
    """``--kern K16`` runs the dense-G chain with OSD alone, end to end,
    as ``tests/test_kern.py`` runs the JAX CLI."""
    c = PolarConfig(k=8, n=16, kern="K16", bs=32, mc_iter=1, snr_end=1.0,
                    osd_t=1, plot_dir=str(tmp_path), device="cpu")
    out = tmain.main(c)
    text = capsys.readouterr().out
    assert "Running: K16 OSD-1" in text and "# complexity" not in text
    assert os.path.isfile(out)
    model, name = tmain.gen_code(c, "x", mode="sc")
    assert isinstance(model.decoder, DenseKernelDecoder)
    assert model.decoder.t == 1 and model.encoder.kern.shape == (16, 16)


def test_kern_cli_rejects_f2_only_construction():
    for construction in ("5g", "ga"):
        c = PolarConfig(k=8, n=16, kern="K16", construction=construction,
                        device="cpu")
        with pytest.raises(ValueError, match="F2-only"):
            tmain.gen_code(c, "x", mode="osd")
        with pytest.raises(ValueError, match="F2-only"):
            j_gen_code(j_PolarConfig(k=8, n=16, kern="K16",
                                     construction=construction), "x",
                       mode="osd")


@pytest.mark.parametrize("kern,construction,k,n", [
    ("F2", "rm-ref", 32, 64), ("F2", "rm-ref", 128, 256),
    ("F2", "ga", 32, 64), ("F2", "ga", 512, 1024), ("F2", "rm", 100, 256),
    ("G16", "rm-ref", 128, 256), ("G16", "rm", 128, 256),
    ("K8", "rm-ref", 30, 64), ("R4", "rm", 8, 16)])
def test_gen_code_frozen_sets_equal_jax(monkeypatch, kern, construction, k,
                                        n):
    # the JAX side's GA means from its NumPy twin, so its committed native
    # library is left as it is
    monkeypatch.setattr(j_native, "ga_bit_channel_means",
                        lambda n, m0: j_native._ga_means_numpy(n, m0))
    kw = dict(k=k, n=n, kern=kern, construction=construction, osd_t=1)
    for mode in (("sc", "osd") if kern == "F2" else ("osd",)):
        model, _ = tmain.gen_code(PolarConfig(device="cpu", **kw), "x",
                                  mode=mode)
        j_model, _ = j_gen_code(j_PolarConfig(**kw), "x", mode=mode)
        want = np.sort(np.asarray(j_model.encoder.frozen_pos
                                  if mode == "osd" else
                                  j_model.decoder.frozen_pos))
        np.testing.assert_array_equal(model.encoder.frozen_pos, want)
        assert model.k == k == n - len(want)


def test_from_numpy_state_osd_decodes_like_jax():
    """The throughput suite's ``osd2_k64_n128`` row (OSD-2 on the 5G
    (64, 128) code, patterns in chunks of 1024, codeword estimates) built
    from its state decodes as JAX's ``OSDecoder`` does."""
    k, n = 64, 128
    frozen, _ = generate_5g_ranking(k, n)
    model = from_numpy_state(dict(frozen_pos=frozen, n=n, k=k,
                                  decoder="osd", osd_t=2,
                                  pattern_chunk=1024, cw_estimates=True),
                             device="cpu")
    assert isinstance(model.decoder, OSDecoder) and model.cw_estimates
    j_dec = JOSDecoder(t=2, encoder=JPolarEncoder(frozen, n),
                       pattern_chunk=1024)
    llr = np.random.default_rng(3).normal(0, 2, (16, n)).astype(np.float32)
    assert_osd_agrees(llr, model.decoder(torch.from_numpy(llr)).numpy(),
                      np.asarray(j_dec(jnp.asarray(llr))), llr_max=100.0)
    c, c_hat = model.step(torch.Generator().manual_seed(0), 32, 6.0)
    assert c.shape == c_hat.shape == (32, n)
    np.testing.assert_array_equal(c_hat.numpy(), c.numpy())
