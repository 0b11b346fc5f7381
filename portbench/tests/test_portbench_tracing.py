"""The readers of the program's spans (``front.ops``, ``decode.ops``,
``decode.glue_ms``, ``harness.host_ms`` and their ``.launch_paced``
names) on fixed ``polar_torch.utils.tracing.summary()`` tables: no card
needed."""

import pytest

from polar_torch.utils import tracing
from portbench import harness

READINGS = {"front.ops": "front_ops", "decode.ops": "decode_ops",
            "decode.glue_ms": "decode_glue_ms",
            "harness.host_ms": "harness_host_ms"}


def _row(name, parent, batch, host, dev, ops=0, **counts):
    return dict(name=name, parent=parent, batch=batch, host_ms=host,
                device_ms=dev, ops=ops, cpu_ops=0, counts=counts)


def fixed_table(events=True):
    # two timed batches after the counted one: decode 6 ms on the device,
    # 2.5 of them in the kernel; the harness 1 ms of sim.step's 5
    rows = []
    for b in (7, 8, 9):
        i = len(rows)
        dev = (lambda v: v) if events else (lambda v: None)
        rows += [_row("sim.step", None, b, 5.0, dev(8.0), ops=4),
                 _row("chain.front", i, b, 1.5, dev(1.0), ops=40, h2d=3),
                 _row("chain.decode", i, b, 2.0, dev(6.0), ops=60),
                 _row("kernel.scl_subtree", i + 2, b, 0.1, dev(2.5), ops=2,
                      **{"launch.scl_subtree": 1}),
                 _row("sim.sync", i, b, 0.5, dev(0.1), sync=1)]
    return tracing.summarize(rows, counted=7)


@pytest.fixture
def table(monkeypatch):
    def plant(s):
        monkeypatch.setattr(tracing, "summary", lambda: s)
    return plant


@pytest.mark.parametrize("variant", ["", ".launch_paced"])
def test_readers_read_the_summary(table, variant, capsys):
    table(fixed_table())
    got = {name: harness.reader(name + variant)(None) for name in READINGS}
    assert got == {"front.ops": 40, "decode.ops": 62,
                   "decode.glue_ms": pytest.approx(3.5),
                   "harness.host_ms": pytest.approx(1.0)}
    # the span table goes to standard error, once a run
    err = capsys.readouterr().err
    assert err.count("chain.decode") == 1 and "decode_glue_ms 3.5" in err


@pytest.mark.parametrize("name", sorted(READINGS))
def test_readers_find_nothing_without_a_session_or_events(table, name):
    table(None)
    assert harness.reader(name)(None) is None
    table(fixed_table(events=False))
    assert harness.reader(name)(None) is None


def test_every_reader_is_listed_with_its_twin():
    man = harness.load_manifest()
    entries = {m["name"]: m for m in man["per_layer"]}
    for name in READINGS:
        plain, twin = entries[name], entries[name + ".launch_paced"]
        assert plain["source"] == twin["source"] == "program_span"
        assert plain["moves"] == "info_bps"
        assert twin["moves"] == "info_bps.launch_paced"
        assert plain["layer"] == twin["layer"]
        assert plain["workloads"] == ["scl8_n1024.deep_point",
                                      "uci_a19_e864.wide_batch"]
        assert twin["workloads"] == ["uci_a19_e864.deep_point"]
