"""The program's spans and counters (``polar_torch.utils.tracing``) through
``sim_ber`` on the CPU: a (64, 32) SCL-8 chain and the uplink (19, 864)
CA-SCL-8 chain at a few blocks, off, under ``torch.profiler`` and under
``tracing.enabled()``; and ``summarize``'s arithmetic on fixed records."""

import pytest
import torch

import _torch_parity  # noqa: F401 (caps torch's threads under xdist)
from polar_torch.models.polar.construction import generate_5g_ranking
from polar_torch.models.polar.decode5g import Polar5GDecoder
from polar_torch.models.polar.encode import Polar5GEncoder, PolarEncoder
from polar_torch.models.polar.scl import PolarSCLDecoder
from polar_torch.models.systems import SystemAWGNModel
from polar_torch.sim import iteration_generator, sim_ber
from polar_torch.utils import tracing

BS = 4

# each span's parent in the chains' trees
PARENTS = {
    "sim.seed": "sim.step", "sim.count": "sim.step", "sim.sync": "sim.step",
    "chain.front": "sim.step", "chain.decode": "sim.step",
    "front.source": "chain.front", "front.encode": "chain.front",
    "front.map": "chain.front", "front.channel": "chain.front",
    "front.demap": "chain.front",
    # the QPSK transmitter kernel's path on a card (cuda_front)
    "front.transmit": "chain.front", "kernel.qpsk_front": "front.transmit",
    "encode.crc": "front.encode", "encode.polar": "front.encode",
    "encode.rate_match": "front.encode",
    "decode.rate_recover": "chain.decode", "decode.polar": "chain.decode",
    "decode.crc": "chain.decode",
    "scl.sweep": ("chain.decode", "decode.polar"),
    "scl.prep": ("chain.decode", "decode.polar"),
    "scl.select": ("chain.decode", "decode.polar"),
    "sweep.descend": "scl.sweep", "sweep.cast": "scl.sweep",
    "sweep.rise": "scl.sweep", "sweep.node": "scl.sweep",
    "sweep.backtrack": "scl.sweep", "sweep.transform": "scl.sweep",
    "kernel.scl_subtree": "scl.sweep",
}
SCL_SPANS = {"sim.step", "sim.seed", "sim.count", "sim.sync", "chain.front",
             "chain.decode", "front.source", "front.encode", "front.map",
             "front.channel", "front.demap", "scl.prep", "scl.sweep",
             "scl.select", "sweep.descend", "sweep.cast", "sweep.rise",
             "sweep.backtrack", "sweep.transform", "kernel.scl_subtree"}
UCI_SPANS = SCL_SPANS | {"encode.crc", "encode.polar", "encode.rate_match",
                         "decode.rate_recover", "decode.polar", "decode.crc"}


def _scl_chain():
    frozen, _ = generate_5g_ranking(32, 64)
    enc = PolarEncoder(frozen, 64, device="cpu")
    dec = PolarSCLDecoder(frozen, 64, list_size=8, use_fast_scl=True,
                          fast_rate1=True, device="cpu")
    return SystemAWGNModel(64, 32, enc, dec)


def _uci_chain():
    enc = Polar5GEncoder(19, 864, channel_type="uplink", device="cpu")
    dec = Polar5GDecoder(enc, dec_type="SCL", list_size=8, mode="exact")
    return SystemAWGNModel(864, 19, enc, dec)


CHAINS = {"scl8_n64": (_scl_chain, SCL_SPANS),
          "uci_a19_e864": (_uci_chain, UCI_SPANS)}


@pytest.fixture(scope="module", params=sorted(CHAINS))
def chain(request):
    build, spans = CHAINS[request.param]
    return build(), spans


def _run(model, iters=2, seed=2 ** 31 + 5, ebno=2.0):
    return sim_ber(model, [ebno], BS, iters, early_stop=False,
                   verbose=False, seed=seed)


def _check_tree(records, spans):
    names = {name for name, _, _ in records}
    assert spans <= names
    roots = [i for i, (name, parent, _) in enumerate(records)
             if parent is None]
    assert [records[i][0] for i in roots] == ["sim.step"] * len(roots)
    assert len({records[i][2] for i in roots}) == len(roots)
    for name, parent, batch in records:
        if parent is None:
            continue
        want = PARENTS.get(name)
        if want is not None:
            assert records[parent][0] in (
                want if isinstance(want, tuple) else (want,)), name
        # one batch id a batch: every span shares its root's
        assert batch == records[parent][2]
    return roots


def test_off_span_is_the_shared_null_and_leaves_no_record(chain):
    model, _ = chain
    assert tracing.span("a") is tracing.span("b")
    assert not tracing.span("a").__enter__()
    before = tracing.records()
    _run(model, iters=1)
    assert tracing.records() == before


def test_spans_nest_under_the_cpu_profiler(chain):
    model, spans = chain
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run(model)
    roots = _check_tree(tracing.records(), spans)
    assert len(roots) == 2
    names = {ev.name for ev in prof.events()}
    assert spans <= names
    s = tracing.summary()
    assert s["batches"] == 2 and s["timed_batches"] == 1
    assert s["events"] is False and s["decode_glue_ms"] is None
    assert s["harness_host_ms"] > 0


def test_spans_nest_under_enabled(chain):
    model, spans = chain
    with tracing.enabled():
        _run(model, iters=3)
    assert len(_check_tree(tracing.records(), spans)) == 3
    s = tracing.summary()
    assert s["batches"] == 3 and s["timed_batches"] == 2
    for name in spans:
        assert s["spans"][name]["calls"] >= 1
        assert s["spans"][name]["host_ms"] >= s["spans"][name][
            "self_host_ms"] >= 0


def test_op_counts_equal_over_batches_and_seeds(chain):
    model, _ = chain
    tables = []
    for seed, ebno in ((2 ** 31 + 5, 2.0), (2 ** 33 + 11, 4.0)):
        with tracing.enabled():
            _run(model, iters=2, seed=seed, ebno=ebno)
        s = tracing.summary()
        tables.append({k: v["ops"] for k, v in s["spans"].items()})
        assert s["front_ops"] > 0 and s["decode_ops"] > 0
        assert s["harness_ops"] >= 0
        assert s["spans"]["sim.step"]["ops"] == (
            s["front_ops"] + s["decode_ops"] + s["harness_ops"])
    assert tables[0] == tables[1]


def test_sim_sync_counts_one_blocking_read_a_batch(chain):
    model, _ = chain
    before = tracing.counter("sync")
    with tracing.enabled():
        _run(model, iters=3)
    assert tracing.counter("sync") == before + 3
    s = tracing.summary()
    assert s["spans"]["sim.sync"]["sync"] == 1
    assert s["spans"]["sim.step"]["sync"] == 1
    assert s["spans"]["chain.front"]["h2d"] == 3    # AWGN, demapper
    assert "sync" not in s["spans"]["chain.decode"]


def test_decisions_bit_identical_on_and_off(chain):
    model, _ = chain

    def step():
        gen = iteration_generator(2 ** 32 + 3, 0, 0, "cpu")
        return model.step(gen, BS, 1.0)

    off = step()
    with tracing.enabled():
        on = step()
    assert all(torch.equal(a, b) for a, b in zip(off, on))


def test_a_launch_charges_its_device_ops_to_the_counted_batch():
    with tracing.enabled():
        for _ in range(2):
            with tracing.batch():
                with tracing.span("chain.decode"):
                    with tracing.span("kernel.k"):
                        tracing.count("launch.k", ops=2)
    s = tracing.summary()
    assert s["spans"]["kernel.k"]["ops"] == 2
    assert s["spans"]["kernel.k"]["launch.k"] == 1
    assert s["decode_ops"] == 2 and s["front_ops"] is None


def _row(name, parent, batch, host, dev, ops=0, **counts):
    return dict(name=name, parent=parent, batch=batch, host_ms=host,
                device_ms=dev, ops=ops, cpu_ops=0, counts=counts)


def test_summarize_on_fixed_records():
    # batch 1 is the counted one: its times stay out of every mean
    rows = []
    for b, scale in ((1, 100.0), (2, 1.0), (3, 3.0)):
        i = len(rows)
        rows += [
            _row("sim.step", None, b, 10 * scale, 9 * scale),
            _row("chain.front", i, b, 2 * scale, 1 * scale, ops=5, h2d=3),
            _row("chain.decode", i, b, 4 * scale, 6 * scale, ops=7),
            _row("kernel.scl_subtree", i + 2, b, 1 * scale, 4 * scale,
                 ops=2, **{"launch.scl_subtree": 1,
                           "rows.scl_subtree.quad": 8988,
                           "rows.scl_subtree.scalar": 174,
                           "ops.scl_subtree": 54,
                           "leaves.scl_subtree.run": 220}),
            _row("sim.sync", i, b, 3 * scale, 0.5 * scale, sync=1),
        ]
    s = tracing.summarize(rows, counted=1)
    assert (s["batches"], s["timed_batches"], s["events"]) == (3, 2, True)
    dec = s["spans"]["chain.decode"]
    assert dec["calls"] == 1 and dec["ops"] == 9
    assert dec["host_ms"] == pytest.approx(8.0)
    assert dec["device_ms"] == pytest.approx(12.0)
    assert dec["self_device_ms"] == pytest.approx(4.0)
    assert dec["launch.scl_subtree"] == 1
    assert s["spans"]["sim.step"]["h2d"] == 3
    assert s["spans"]["sim.step"]["sync"] == 1
    assert s["spans"]["sim.step"]["self_host_ms"] == pytest.approx(2.0)
    assert (s["front_ops"], s["decode_ops"], s["harness_ops"]) == (5, 9, 0)
    assert s["decode_kernel_ms"] == pytest.approx(8.0)
    assert s["decode_glue_ms"] == pytest.approx(4.0)
    # sim.step 20 less front 4, decode 8 and the wait in sim.sync 6
    assert s["harness_host_ms"] == pytest.approx(2.0)
    text = tracing.format_table(s)
    assert "kernel.scl_subtree" in text and "decode_glue_ms 4.0" in text
    # the quad rows' share of the SCL kernel's rows (scl8's schedule)
    assert ("counter rows.scl_subtree.quad 8988.00 a batch (98.1% of "
            "rows.scl_subtree.*)") in text
    # the kernel's table rows and the leaves inside its frozen-run rows
    # (the uplink PC schedule's), beside the rows
    assert "counter ops.scl_subtree 54.00 a batch\n" in text + "\n"
    assert "counter leaves.scl_subtree.run 220.00 a batch\n" in text + "\n"
    assert "launch.scl_subtree" not in text
