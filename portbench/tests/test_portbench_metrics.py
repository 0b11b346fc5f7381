"""The metric arithmetic on fixed spans and counts."""

import numpy as np
import pytest

from portbench import harness, work
from portbench.reference.polar_awgn import Link
from portbench.trace import DECODE, FRONT, Slice, union

CFG = {"system": "polar_awgn", "code": "5g_ranked", "k": 32, "n": 64,
       "decoder": "scl", "list_size": 8, "mode": "minsum",
       "fast_scl": True, "fast_rate1": True, "llr_max": 30.0}


def fixed_slice():
    # a 10 ms slice of 2 batches: kernels busy 1-3, 2-4 (overlapping),
    # 6-7 and 8-9 ms; the host in front 0-5, decode 5-8.5
    ops = [("scl_subtree_kernel<8,false>", 0.001, 0.003),
           ("elementwise", 0.002, 0.004),
           ("scl_cw_kernel<8>", 0.006, 0.007),
           ("elementwise", 0.008, 0.009),
           ("outside", 0.020, 0.021)]
    spans = [(FRONT, 0.0, 0.005), (DECODE, 0.005, 0.0085)]
    return Slice(ops, spans, 0.0, 0.010, batches=2)


def test_union_merges_overlaps():
    assert union([(3, 4), (1, 2), (1.5, 2.5), (2.5, 3)]) == [(1, 4)]


def test_slice_busy_idle_and_tops():
    sl = fixed_slice()
    assert sl.busy == [(0.001, 0.004), (0.006, 0.007), (0.008, 0.009)]
    assert sl.busy_s == pytest.approx(0.005)
    assert sl.window_s == pytest.approx(0.010)
    tops = sl.top_ops()
    assert tops[0][0] == "elementwise" and tops[0][1] == pytest.approx(
        0.003)
    assert sl.op_seconds(lambda n: n.startswith(
        ("scl_subtree_kernel", "scl_cw_kernel"))) == pytest.approx(0.003)
    gaps = dict(sl.idle_gaps())
    # gaps 0-1 (front, before the SCL kernel), 4-6 (front/decode edge at
    # 5: the middle is 5.0, in decode), 7-8 (decode), 9-10 (harness)
    assert gaps["front before scl_subtree_kernel<8,false>"] == \
        pytest.approx(0.001)
    assert gaps["decode before scl_cw_kernel<8>"] == pytest.approx(0.002)
    assert gaps["decode before elementwise"] == pytest.approx(0.001)
    assert gaps["harness before end of slice"] == pytest.approx(0.001)
    assert sum(gaps.values()) == pytest.approx(sl.window_s - sl.busy_s)


def test_idle_share_against_the_window_period():
    # 5 ms busy over 2 profiled batches against the window's 5 ms and
    # 10 ms batch periods: the profiled slice's own length plays no part
    ctx = _ctx(slice=fixed_slice())
    assert harness.reader("device.idle_pct")(ctx) == pytest.approx(50.0)
    ctx.batch_period_s = 0.010
    assert harness.reader("device.idle_pct")(ctx) == pytest.approx(75.0)


def test_variant_names_read_their_base():
    ctx = _ctx()
    assert harness.reader("info_bps.launch_paced")(ctx) == \
        harness.reader("info_bps")(ctx)
    with pytest.raises(harness.CellError):
        harness.reader("no_such_metric.launch_paced")


def _ctx(**kw):
    ctx = harness.Ctx()
    ctx.cfg, ctx.traffic = CFG, {"batch_size": 1000}
    ctx.k, ctx.blocks, ctx.window_s, ctx.setup_s = 32, 64000, 2.0, 7.5
    ctx.periods_s = np.arange(1, 101) * 1e-3
    ctx.batch_period_s = 0.005
    ctx.front_ms = ctx.decode_ms = ctx.gap_ms = ctx.slice = None
    ctx.power_limit = "NVIDIA H100 80GB HBM3, 700.00 W"
    for key, v in kw.items():
        setattr(ctx, key, v)
    return ctx


def test_end_to_end_readers():
    ctx = _ctx()
    assert harness.reader("info_bps")(ctx) == pytest.approx(
        32 * 64000 / 2.0)
    assert harness.reader("batch_ms_p95")(ctx) == pytest.approx(95.05)
    assert harness.reader("setup_s")(ctx) == 7.5


def test_span_readers_and_silence():
    ctx = _ctx(front_ms=[1.0, 3.0], decode_ms=[5.0, 7.0], gap_ms=[0.25])
    assert harness.reader("step.front_ms")(ctx) == 2.0
    assert harness.reader("step.decode_ms")(ctx) == 6.0
    assert harness.reader("harness.gap_ms")(ctx) == 0.25
    empty = _ctx()
    for name in ("step.front_ms", "step.decode_ms", "harness.gap_ms",
                 "device.idle_pct", "kernel.scl.roofline_pct"):
        assert harness.reader(name)(empty) is None


def test_trace_readers():
    ctx = _ctx(slice=fixed_slice())
    assert harness.reader("device.idle_pct")(ctx) == pytest.approx(50.0)
    link = Link(CFG, "cpu")
    b, o = work.decode_work(link.dec.schedule(), 64, 32, 8, 1000,
                            "minsum")
    bound = work.bound_ms(b, o)[0]
    # 3 ms of SCL kernels over 2 batches: 1.5 ms a batch
    assert harness.reader("kernel.scl.roofline_pct")(ctx) == \
        pytest.approx(100 * bound / 1.5)
    no_kernel = Slice([("elementwise", 0.0, 0.001)], [], 0.0, 0.01, 1)
    assert harness.reader("kernel.scl.roofline_pct")(
        _ctx(slice=no_kernel)) is None


def test_work_counts_by_hand():
    # one rate-1 node over a 4-leaf tree, L = 2: one f-free root node
    ops = [("rate1", 2, 0)]
    b, o = work.decode_work(ops, 4, 4, 2, 10, "minsum")
    assert b == 4 * 4 * 10 + 4 * 4 * 10
    # softplus on 4 rows a path, theta = min(1, 4) = 1 fork comparing
    # 2 L^2 = 8 candidates and sorting 4 rows
    assert o == 2 * 10 * (6 * 4) + 10 * (1 * (8 + 4))
    # a split node: two leaves under one f and one g
    ops = [("info", 0, 0), ("info", 0, 1)]
    b, o = work.decode_work(ops, 2, 2, 1, 1, "exact")
    assert o == 1 * (20 * 1 + 2 * 1 + 6 * 4 + 1 * 1) + 2 * 2


def test_bound_picks_the_larger():
    ms, kind = work.bound_ms(3.35e9, 1.0)
    assert ms == pytest.approx(1.0) and kind == "bytes"
    ms, kind = work.bound_ms(1.0, 67e9)
    assert ms == pytest.approx(1.0) and kind == "operations"
