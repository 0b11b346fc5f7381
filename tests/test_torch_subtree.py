"""The SCL subtree of polar_torch: the plain PyTorch version against the
Pallas kernel of polar_tpu (interpret mode), and the host build of the
CUDA kernel's routine against the plain version. The kernel itself is
tested on the card in ``test_torch_gpu.py``."""

import hashlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from polar_tpu.models.polar import pallas_scl as jps
from polar_tpu.models.polar.pallas_scl import subtree_pallas

from polar_torch.models.polar import cuda_scl
from polar_torch.models.polar.construction import generate_5g_ranking
from polar_torch.models.polar.cuda_scl import (
    KIND_CODES, SubtreeSchedule, scl_subtree, scl_subtree_host,
    scl_subtree_plain, traced_schedule)
from polar_torch.models.polar.scan_core import (leaf_schedule,
                                                split_fast_schedule)
from polar_torch.utils import tracing

from _torch_parity import PM_RTOL, assert_blocks_agree, block_agreement

LLR_MAX = 30.0


def _mask_5g(k, n):
    frozen, _ = generate_5g_ranking(k, n)
    mask = np.zeros(n, bool)
    mask[frozen] = True
    return mask


def _random_mask(n, seed):
    rng = np.random.default_rng(seed)
    return rng.random(n) < rng.uniform(0.2, 0.8)


def _uplink_pc_ops(k, e):
    """The PC leaf schedule of the uplink (k, e) code's mother code and
    its depth."""
    from polar_torch.models.polar.encode import Polar5GEncoder
    enc = Polar5GEncoder(k, e, device="cpu")
    mask = np.zeros(enc.n_polar, bool)
    mask[enc.frozen_pos] = True
    pc = np.zeros(enc.n_polar, bool)
    pc[enc.pc_pos] = True
    return leaf_schedule(mask, pc), enc.n_polar.bit_length() - 1


def _random_pc_ops(n, seed):
    """A leaf schedule of n leaves with random frozen and PC leaves."""
    rng = np.random.default_rng(seed)
    frozen = rng.random(n) < 0.6
    return leaf_schedule(frozen, ~frozen & (rng.random(n) < 0.2))


def _inputs(b, L, bs, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 3, (1 << b, L, bs)).astype(np.float32)
    pm = rng.exponential(2.0, (L, bs)).astype(np.float32)
    return a, pm


def _sub_units(mask, b, rate1, spc=None):
    units, _ = split_fast_schedule(mask, b, rate1=rate1, spc_min_stage=spc)
    return [u[2] for u in units if u[0] == "sub"]


# (mask, b, L, mode, rate1, spc, units to run): interpret mode costs about
# a second per unit, so each case runs a few distinct units
PALLAS_CASES = {
    "5g_k32_n64_b3": (_mask_5g(32, 64), 3, 8, "minsum", True, None, 4),
    "5g_k128_n256_b4": (_mask_5g(128, 256), 4, 8, "minsum", True, None, 3),
    "random_b4_spc": (_random_mask(64, 3), 4, 8, "minsum", True, 2, 3),
    "random_b3_L4_exact": (_random_mask(64, 4), 3, 4, "exact", True, None,
                           3),
}


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_plain_subtree_equals_pallas_interpret(case):
    mask, b, L, mode, rate1, spc, count = PALLAS_CASES[case]
    # the Pallas kernel takes its schedule as given; only the sweep reads
    # the SPC threshold from the environment
    units = _sub_units(mask, b, rate1, spc)
    units = sorted(set(units), key=lambda ops: (-len(ops), ops))[:count]
    for i, ops in enumerate(units):
        a, pm = _inputs(b, L, 128, seed=100 * i + b)
        cw_j, p_j, pm_j = subtree_pallas(
            jnp.asarray(a), None, jnp.asarray(pm), b=b, L=L, llr_max=LLR_MAX,
            mode=mode, interpret=True, sched_static=ops)
        cw_t, p_t, pm_t = scl_subtree_plain(
            torch.from_numpy(a), torch.from_numpy(pm), ops, b=b,
            llr_max=LLR_MAX, mode=mode)
        assert cw_t.dtype == torch.int32 and p_t.dtype == torch.int32
        assert_blocks_agree((np.asarray(cw_j), np.asarray(p_j)),
                            (cw_t.numpy(), p_t.numpy()), np.asarray(pm_j),
                            pm_t.numpy())


# L = 16, 32 run the blocked kernel (``_subtree_kernel_blocked``), whose
# interpret mode costs 8-40 s per fork op on the CPU: one small schedule
# each. Info leaves at L = 16, 32 and rate-1 forks at L = 32 are held
# against JAX's XLA decoders and sweeps in test_torch_scl.py.
WIDE_PALLAS_CASES = {
    "L16_rate0_rate1": (16, 2, (("z", 1, 0), ("o", 1, 2))),
    "L32_rate0_rep": (32, 2, (("z", 1, 0), ("r", 1, 2))),
}


@pytest.mark.parametrize("case", sorted(WIDE_PALLAS_CASES))
def test_plain_wide_subtree_equals_pallas_interpret(case):
    L, b, ops = WIDE_PALLAS_CASES[case]
    a, pm = _inputs(b, L, 128, seed=L + b)
    cw_j, p_j, pm_j = subtree_pallas(
        jnp.asarray(a), None, jnp.asarray(pm), b=b, L=L, llr_max=LLR_MAX,
        mode="minsum", interpret=True, sched_static=ops)
    cw_t, p_t, pm_t = scl_subtree_plain(
        torch.from_numpy(a), torch.from_numpy(pm), ops, b=b,
        llr_max=LLR_MAX, mode="minsum")
    assert_blocks_agree((np.asarray(cw_j), np.asarray(p_j)),
                        (cw_t.numpy(), p_t.numpy()), np.asarray(pm_j),
                        pm_t.numpy())


@pytest.mark.parametrize("cond_leaves", [False, True])
def test_plain_traced_subtree_equals_pallas_interpret(cond_leaves):
    """The traced form (frozen flags as data) against the Pallas kernel's
    traced form, with and without its run-time frozen-leaf skip."""
    b, L = 3, 8
    mask = _random_mask(1 << b, 11)
    a, pm = _inputs(b, L, 128, seed=12)
    frz = mask.astype(np.int32)
    cw_j, p_j, pm_j = subtree_pallas(
        jnp.asarray(a), jnp.asarray(frz), jnp.asarray(pm), b=b, L=L,
        llr_max=LLR_MAX, mode="minsum", interpret=True,
        cond_leaves=cond_leaves)
    cw_t, p_t, pm_t = scl_subtree_plain(
        torch.from_numpy(a), torch.from_numpy(pm), traced_schedule(b), b=b,
        llr_max=LLR_MAX, mode="minsum", frz=torch.from_numpy(frz))
    assert_blocks_agree((np.asarray(cw_j), np.asarray(p_j)),
                        (cw_t.numpy(), p_t.numpy()), np.asarray(pm_j),
                        pm_t.numpy())


def _near_tie_blocks(monkeypatch):
    """Record, for the plain version's forks, which blocks pick between
    two candidates whose path metrics lie within ``PM_RTOL`` of each other.
    Returns ``(calls, close_call)``: ``close_call(bs)`` after each plain
    call appends that call's [bs] bool mask of such blocks to ``calls``."""
    forks, calls = [], []
    top_l = cuda_scl._top_l

    def recording_top_l(pmc, L):
        vals, idx = top_l(pmc, L)
        srt = torch.sort(pmc, dim=0).values
        forks.append((srt[L] - srt[L - 1]).abs()
                     <= PM_RTOL * srt[L].abs().clamp_min(1.0))
        return vals, idx

    def close_call(bs):
        calls.append(torch.stack(forks).any(dim=0) if forks
                     else torch.zeros(bs, dtype=torch.bool))
        forks.clear()

    monkeypatch.setattr(cuda_scl, "_top_l", recording_top_l)
    return calls, close_call


@pytest.mark.parametrize("mode", ["minsum", "exact"])
@pytest.mark.parametrize("L", [1, 2, 4, 8])
def test_host_build_equals_plain(mode, L, monkeypatch):
    cases = [(_mask_5g(32, 64), 3, True, None),
             (_mask_5g(128, 256), 5, True, None),
             (_mask_5g(128, 256), 8, False, None),
             (_random_mask(128, L), 4, True, 2),
             (_random_mask(128, L + 1), 7, True, 3)]
    near_tie, close_call = _near_tie_blocks(monkeypatch)
    plain, host = [], []
    for c, (mask, b, rate1, spc) in enumerate(cases):
        for i, ops in enumerate(_sub_units(mask, b, rate1, spc)):
            a, pm = _inputs(b, L, 128, seed=1000 * c + i)
            sched = SubtreeSchedule(ops, "cpu")
            a_t, pm_t = torch.from_numpy(a), torch.from_numpy(pm)
            plain.append(scl_subtree_plain(a_t, pm_t, ops, b=b,
                                           llr_max=LLR_MAX, mode=mode))
            close_call(128)
            host.append(scl_subtree_host(a_t, pm_t, sched, b=b,
                                         llr_max=LLR_MAX, mode=mode))
    plain = [tuple(x.numpy() for x in out) for out in plain]
    host = [tuple(x.numpy() for x in out) for out in host]
    if mode == "minsum":
        # min-sum f/g are exact: only path-metric ulps may differ
        for (cw_p, p_p, pm_p), (cw_h, p_h, pm_h) in zip(plain, host):
            np.testing.assert_array_equal(cw_h, cw_p)
            np.testing.assert_array_equal(p_h, p_p)
            np.testing.assert_allclose(pm_h, pm_p, rtol=PM_RTOL)
        return
    # the exact boxplus rounds differently (log1pf/expf against
    # torch.logaddexp), so a decision may flip where two candidates'
    # path metrics nearly tie; every other block must agree exactly
    n_diff = 0
    for (cw_p, p_p, pm_p), (cw_h, p_h, pm_h), tie in zip(plain, host,
                                                        near_tie):
        _, rel, bad = block_agreement((cw_p, p_p), (cw_h, p_h), pm_p, pm_h)
        assert rel <= PM_RTOL
        assert not (bad & ~tie.numpy()).any(), (
            f"blocks {np.flatnonzero(bad & ~tie.numpy()).tolist()} differ "
            "with no near-tie fork")
        n_diff += int(bad.sum())
    assert n_diff <= 0.01 * sum(len(t) for t in near_tie)


@pytest.mark.parametrize("mode", ["minsum", "exact"])
@pytest.mark.parametrize("L", [16, 32])
def test_wide_host_build_equals_plain(mode, L, monkeypatch):
    """L = 16, 32: the routine's byte-per-path pointers, 64-candidate top-L
    and up to 31 rate-1 flips against the plain version, on 5G and random
    schedules (rate-1 and SPC nodes)."""
    cases = [(_mask_5g(32, 64), 3, None),
             (_mask_5g(128, 256), 5, None),
             (_random_mask(128, L), 4, 2),
             (_random_mask(256, L + 1), 6, 3)]
    near_tie, close_call = _near_tie_blocks(monkeypatch)
    n_diff = n_blocks = 0
    for c, (mask, b, spc) in enumerate(cases):
        for i, ops in enumerate(_sub_units(mask, b, True, spc)[:4]):
            a, pm = _inputs(b, L, 64, seed=2000 * c + i)
            a_t, pm_t = torch.from_numpy(a), torch.from_numpy(pm)
            want = [x.numpy() for x in scl_subtree_plain(
                a_t, pm_t, ops, b=b, llr_max=LLR_MAX, mode=mode)]
            close_call(64)
            got = [x.numpy() for x in scl_subtree_host(
                a_t, pm_t, SubtreeSchedule(ops, "cpu"), b=b,
                llr_max=LLR_MAX, mode=mode)]
            _, rel, bad = block_agreement(want[:2], got[:2], want[2], got[2])
            assert rel <= PM_RTOL
            if mode == "minsum":
                assert not bad.any()
            else:
                assert not (bad & ~near_tie[-1].numpy()).any()
            n_diff += int(bad.sum())
            n_blocks += bad.size
    assert n_diff <= 0.01 * n_blocks


@pytest.mark.parametrize("L", [1, 8, 16, 32])
def test_traced_form_equals_static_form(L):
    """One traced schedule with the frozen flags as data decodes every
    subtree bit for bit as its static leaf schedule does: in the host
    build (the kernel's run-time skip of frozen leaves) and in the plain
    version (a branchless select)."""
    b = 4
    for seed in range(3):
        mask = _random_mask(1 << b, 100 + seed)
        a, pm = _inputs(b, L, 32, seed=seed)
        a_t, pm_t = torch.from_numpy(a), torch.from_numpy(pm)
        frz = torch.from_numpy(mask.astype(np.int32))
        static = leaf_schedule(mask)
        traced = traced_schedule(b)
        kw = dict(b=b, llr_max=LLR_MAX, mode="minsum")
        outs = [
            scl_subtree_plain(a_t, pm_t, static, **kw),
            scl_subtree_plain(a_t, pm_t, traced, frz=frz, **kw),
            scl_subtree_host(a_t, pm_t, SubtreeSchedule(static, "cpu"),
                             **kw),
            scl_subtree_host(a_t, pm_t, SubtreeSchedule(traced, "cpu"),
                             frz=frz, **kw),
        ]
        for x, y in zip(outs[0], outs[1]):
            assert torch.equal(x, y)
        for x, y in zip(outs[2], outs[3]):
            assert torch.equal(x, y)
        # the host build's traced form against the plain traced form
        # (min-sum: only path-metric ulps may differ)
        for x, y in zip(outs[3][:2], outs[1][:2]):
            assert torch.equal(x, y)
        np.testing.assert_allclose(outs[3][2].numpy(), outs[1][2].numpy(),
                                   rtol=PM_RTOL)


@pytest.mark.parametrize("L,n_shared", [(8, 0), (8, 3), (32, 0), (32, 2),
                                        (1, 0), (1, 5), (8, 5), (32, 4)])
def test_host_build_split_stages_equals_plain(L, n_shared, monkeypatch):
    """Workspace stages from ``n_shared`` up in the global scratch, the
    rest in the codeword's shared arrays, as the card splits them when a
    subtree does not fit the block's budget: bit-equal to the all-shared
    layout and equal to the plain version. PC leaf schedules (the uplink
    (19, 864) and (12, 48) codes, a random PC mask), whose aligned blocks
    of frozen leaves run as frozen-run rows (the (19, 864) code's 64-leaf
    block has its root in the global scratch below 7 shared stages), in
    both modes: bit-equal as well to the routine on the table of one row
    a leaf, the parent kernel's."""
    cases = [(_mask_5g(128, 256), 6, None), (_random_mask(256, L + 5), 6, 2)]
    for c, (mask, b, spc) in enumerate(cases):
        for i, ops in enumerate(_sub_units(mask, b, True, spc)[:2]):
            a, pm = _inputs(b, L, 32, seed=3000 * c + i)
            a_t, pm_t = torch.from_numpy(a), torch.from_numpy(pm)
            kw = dict(b=b, llr_max=LLR_MAX, mode="minsum")
            sched = SubtreeSchedule(ops, "cpu")
            split = scl_subtree_host(a_t, pm_t, sched, n_shared=n_shared,
                                     **kw)
            whole = scl_subtree_host(a_t, pm_t, sched, **kw)
            for x, y in zip(split, whole):
                assert torch.equal(x, y)
            want = scl_subtree_plain(a_t, pm_t, ops, **kw)
            for x, y in zip(split[:2], want[:2]):
                assert torch.equal(x, y)
            np.testing.assert_allclose(split[2].numpy(), want[2].numpy(),
                                       rtol=PM_RTOL)
    near_tie, close_call = _near_tie_blocks(monkeypatch)
    pc_cases = [_uplink_pc_ops(19, 864), _uplink_pc_ops(12, 48),
                (_random_pc_ops(128, L), 7)]
    for c, (ops, b) in enumerate(pc_cases):
        runs = SubtreeSchedule(ops, "cpu")
        assert runs.run_leaves > 0
        leaves = SubtreeSchedule(ops, "cpu", runs=False)
        a, pm = _inputs(b, L, 32, seed=4000 * c + L)
        a_t, pm_t = torch.from_numpy(a), torch.from_numpy(pm)
        for mode in ("minsum", "exact"):
            kw = dict(b=b, llr_max=LLR_MAX, mode=mode)
            split = scl_subtree_host(a_t, pm_t, runs, n_shared=n_shared,
                                     **kw)
            for other in (scl_subtree_host(a_t, pm_t, runs, **kw),
                          scl_subtree_host(a_t, pm_t, leaves, **kw)):
                assert all(torch.equal(x, y) for x, y in zip(split, other))
            want = [x.numpy() for x in scl_subtree_plain(a_t, pm_t, ops,
                                                         **kw)]
            close_call(32)
            got = [x.numpy() for x in split]
            _, rel, bad = block_agreement(want[:2], got[:2], want[2], got[2])
            assert rel <= PM_RTOL
            if mode == "minsum":
                assert not bad.any()
            else:
                assert not (bad & ~near_tie[-1].numpy()).any()


@pytest.mark.parametrize("L", [2, 8, 32])
def test_host_build_breaks_exact_ties_as_top_l(L):
    """Candidates with exactly equal path metrics: every path holds the
    same LLRs (a broadcast input) and starts from equal metrics or the
    sweep's clone metrics, and clipped LLRs make the fork penalties equal
    llr_max. The rank top-L must keep candidate order, as ``_top_l``'s
    stable sort does: the same survivors, parents and bits."""
    b, bs = 4, 16
    rng = np.random.default_rng(L)
    row = rng.choice([-1.5, 1.5, -40.0, 40.0], (1 << b, bs)).astype(
        np.float32)
    a = torch.from_numpy(row)[:, None, :].expand(1 << b, L, bs)
    clones = np.full((L, bs), LLR_MAX, np.float32)
    clones[0] = 0.0
    for pm in (np.full((L, bs), 2.5, np.float32), clones):
        pm_t = torch.from_numpy(pm)
        for ops in (leaf_schedule(np.zeros(1 << b, bool)),
                    (("r", 2, 0), ("i", 0, 4), ("i", 0, 5), ("o", 1, 6),
                     ("o", 3, 8)),
                    (("s", 3, 0), ("o", 3, 8))):
            kw = dict(b=b, llr_max=LLR_MAX, mode="minsum")
            want = scl_subtree_plain(a, pm_t, ops, **kw)
            got = scl_subtree_host(a, pm_t, SubtreeSchedule(ops, "cpu"), **kw)
            for x, y in zip(got[:2], want[:2]):
                assert torch.equal(x, y)
            np.testing.assert_allclose(got[2].numpy(), want[2].numpy(),
                                       rtol=PM_RTOL)


def test_shared_stages_fit_the_budget():
    """A block's shared memory grows with the stages kept there (5 bytes
    per row, path and codeword, plus the codewords' exchange arrays), and
    the wrapper keeps the most stages that fit its budget."""
    size = lambda L, n: cuda_scl.block_smem_bytes(L, n, route="host")
    for L in cuda_scl.LIST_SIZES:
        C = cuda_scl.THREADS // L
        for n in range(cuda_scl.MAX_B):
            rows = (1 << n + 1) - (1 << n)
            assert size(L, n + 1) - size(L, n) in range(5 * rows * C * L,
                                                        5 * rows * C * L + 8)
        for b in range(1, cuda_scl.MAX_B + 1):
            n = cuda_scl.shared_stages(b, L, route="host")
            assert 0 <= n <= b
            assert size(L, n) <= cuda_scl.SMEM_BUDGET
            assert n == b or size(L, n + 1) > cuda_scl.SMEM_BUDGET


def test_traced_form_needs_its_frozen_flags():
    sched = SubtreeSchedule(traced_schedule(2), "cpu")
    a, pm = torch.zeros(4, 8, 4), torch.zeros(8, 4)
    for frz in (None, torch.zeros(4), torch.zeros(3, dtype=torch.int32)):
        with pytest.raises(ValueError, match="frz"):
            scl_subtree_host(a, pm, sched, b=2, llr_max=LLR_MAX,
                             mode="minsum", frz=frz)
    assert sched.traced and not SubtreeSchedule(
        (("f", 1, 0), ("i", 1, 2)), "cpu").traced


def test_host_build_reads_broadcast_input():
    """The whole-tree call passes the channel LLRs broadcast over the paths
    (path stride 0); the routine must read them the same as a copy."""
    mask = _mask_5g(128, 256)
    (ops,) = _sub_units(mask, 8, True)
    rng = np.random.default_rng(5)
    llr = torch.from_numpy(rng.normal(0, 2, (256, 40)).astype(np.float32))
    a = llr[:, None, :].expand(256, 8, 40)
    pm = torch.full((8, 40), LLR_MAX)
    pm[0] = 0.0
    sched = SubtreeSchedule(ops, "cpu")
    got = scl_subtree_host(a, pm, sched, b=8, llr_max=LLR_MAX, mode="minsum")
    want = scl_subtree_host(a.contiguous(), pm, sched, b=8, llr_max=LLR_MAX,
                            mode="minsum")
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_wrapper_runs_plain_version_on_cpu():
    ops = _sub_units(_mask_5g(32, 64), 3, True)[1]
    a, pm = _inputs(3, 8, 16, seed=3)
    before = tracing.counter("launch.scl_subtree")
    got = scl_subtree(torch.from_numpy(a), torch.from_numpy(pm),
                      SubtreeSchedule(ops, "cpu"), b=3, llr_max=LLR_MAX,
                      mode="minsum")
    want = scl_subtree_plain(torch.from_numpy(a), torch.from_numpy(pm), ops,
                             b=3, llr_max=LLR_MAX, mode="minsum")
    assert tracing.counter("launch.scl_subtree") == before
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_schedule_table_encoding():
    ops = (("z", 2, 0), ("r", 1, 4), ("o", 1, 6), ("s", 3, 8), ("f", 0, 16),
           ("i", 0, 17))
    table = SubtreeSchedule(ops, "cpu").table
    assert table.dtype == torch.int32 and table.shape == (6, 3)
    assert table[:, 0].tolist() == [KIND_CODES[k] for k, _, _ in ops]
    assert table[:, 1:].tolist() == [[s, lo] for _, s, lo in ops]


def test_pc_schedule_table_holds_frozen_runs():
    """A PC schedule's table holds each maximal aligned block of frozen
    leaves as one frozen-run row (kind ``RUN_CODE``, its stage, its first
    leaf), which the kernel's PC build walks leaf by leaf; the op list, its
    row counts and every table without PC leaves stay one op a leaf."""
    ops, b = _uplink_pc_ops(19, 864)
    sched = SubtreeSchedule(ops, "cpu")
    table = sched.table.tolist()
    assert (b, len(table), sched.n_rows, sched.run_leaves) == (8, 54, 54, 220)
    assert table[0] == [cuda_scl.RUN_CODE, 6, 0]
    runs = [s for k, s, _ in table if k == cuda_scl.RUN_CODE]
    # blocks of 2, 4, 8, 16, 32 and 64 leaves
    assert sorted(runs) == [1] * 6 + [2] * 4 + [3] * 2 + [4] * 3 + [5] * 2 + [
        6]
    # the rows cover the leaves in order, each run aligned to its size
    lo = 0
    for k, s, start in table:
        assert start == lo and start % (1 << s) == 0
        leaves = ops[lo:lo + (1 << s)]
        if k == cuda_scl.RUN_CODE:
            assert s >= 1 and all(op[0] == "f" for op in leaves)
        else:
            assert s == 0 and leaves == [(next(
                n for n, c in KIND_CODES.items() if c == k), 0, lo)]
        lo += 1 << s
    assert lo == 256
    assert sched.ops == tuple(ops)
    assert sched.rows(8) == cuda_scl.row_counts(tuple(ops), 8) == (2304, 768)
    assert SubtreeSchedule(_uplink_pc_ops(12, 48)[0], "cpu").n_rows == 35
    # one row a leaf or node where no PC leaf is: the fast schedule, a leaf
    # schedule, the traced form, and the SC kernel's tables
    from polar_torch.models.polar.cuda_sc import sc_schedule
    fast = _sub_units(_mask_5g(512, 1024), 10, True)[0]
    for plain in (fast, tuple(leaf_schedule(_mask_5g(32, 64))),
                  traced_schedule(4)):
        sched = SubtreeSchedule(plain, "cpu")
        assert sched.table.tolist() == [[KIND_CODES[k], s, lo]
                                        for k, s, lo in plain]
        assert (sched.n_rows, sched.run_leaves) == (len(plain), 0)
    assert sc_schedule(ops, "cpu").table.shape == (256, 3)


def test_liveness_rules_equal_reference():
    for i_end in range(256):
        for s in range(10):
            assert cuda_scl._lptr_live(s, i_end) == jps._lptr_live(s, i_end)
            for s_node in range(4):
                assert (cuda_scl._uptr_live(s, i_end, s_node)
                        == jps._uptr_live(s, i_end, s_node))


def test_native_call_rejects_bad_inputs():
    sched = SubtreeSchedule((("i", 0, 0), ("i", 0, 1)), "cpu")
    pm = torch.zeros(8, 4)
    with pytest.raises(ValueError):       # 3 rows are not 2^b
        scl_subtree_host(torch.zeros(3, 8, 4), pm, sched, b=1,
                         llr_max=LLR_MAX, mode="minsum")
    with pytest.raises(ValueError):       # list size 3
        scl_subtree_host(torch.zeros(2, 3, 4), torch.zeros(3, 4), sched,
                         b=1, llr_max=LLR_MAX, mode="minsum")
    with pytest.raises(TypeError):
        scl_subtree_host(torch.zeros(2, 8, 4, dtype=torch.float64), pm,
                         sched, b=1, llr_max=LLR_MAX, mode="minsum")



# sha256 of each quad-edge case's outputs (cw, P and the path metrics'
# bits, schedule by schedule), as the routine gave them with the scalar
# [row][codeword][slot] workspaces, before they became row quads
QUAD_EDGE_DIGESTS = {
    (1, 1, 'minsum'): '81d9523c8d39225b',
    (1, 1, 'exact'): '0110982825ecb5c3',
    (1, 8, 'minsum'): 'b68461b35c0964ee',
    (1, 8, 'exact'): '473051d5ba2d760d',
    (1, 32, 'minsum'): 'b524393b8921f2b5',
    (1, 32, 'exact'): 'd1031e09f3fc6ceb',
    (2, 1, 'minsum'): '05f49a2700d68ca5',
    (2, 1, 'exact'): 'bedf325d1e8a245d',
    (2, 8, 'minsum'): '73d8fe381b2948ad',
    (2, 8, 'exact'): '89a0a324024cf7ef',
    (2, 32, 'minsum'): '02581f96de7fd956',
    (2, 32, 'exact'): '551446415bf5a604',
    (3, 1, 'minsum'): '1ff7a750db5e7dda',
    (3, 1, 'exact'): 'b8d4af0a26525f55',
    (3, 8, 'minsum'): '41d6ab4810f16a63',
    (3, 8, 'exact'): 'b1cd05075d111775',
    (3, 32, 'minsum'): '69a97c685a66a265',
    (3, 32, 'exact'): 'a66b81579adaac9c',
    (4, 1, 'minsum'): 'cc5960f7d7aaf4b4',
    (4, 1, 'exact'): '643bbadd05d8eaac',
    (4, 8, 'minsum'): 'e4f7a4a1aac2b776',
    (4, 8, 'exact'): '3f7d895fa00d3e38',
    (4, 32, 'minsum'): 'b341769bdba28980',
    (4, 32, 'exact'): 'c09aff33bded35f1',
}


def _quad_edge_schedules(b):
    """Schedules of depth ``b`` whose stages sit on both sides of the quad
    edge (4 rows): fast units of a 5G mask, whole-subtree rate-0, rate-1
    and SPC nodes (their loops read the input straight), two half-subtree
    nodes, a leaf schedule with PC leaves and the traced form."""
    rng = np.random.default_rng(b)
    units = _sub_units(_mask_5g(16 << b, 32 << b), b, True, 2)
    half = 1 << (b - 1)
    leaves = rng.random(1 << b) < 0.5
    pc = ~leaves & (rng.random(1 << b) < 0.4)
    return [*units[:2], units[-1], (("z", b, 0),), (("o", b, 0),),
            (("s", b, 0),), (("r", b - 1, 0), ("s", b - 1, half)),
            leaf_schedule(leaves, pc), traced_schedule(b)], leaves


def _digest(outs):
    h = hashlib.sha256()
    for cw, P, pm in outs:
        h.update(cw.numpy().tobytes() + P.numpy().tobytes()
                 + pm.numpy().view(np.int32).tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("mode", ["minsum", "exact"])
@pytest.mark.parametrize("L", [1, 8, 32])
@pytest.mark.parametrize("b", [1, 2, 3, 4])
def test_host_build_quad_edges_equal_plain(b, L, mode, monkeypatch):
    """Row quads at their edges: depths 1-4, workspace stages split
    between the block's shared arrays and the global scratch at 0, 2, 3
    and b shared stages, a batch that fills no whole block (131 columns
    against 128 / L codewords a block). Every split gives the same bits,
    equal to the routine's outputs before the quads (``QUAD_EDGE_DIGESTS``)
    and to the plain version (exact mode: up to near-tie forks)."""
    bs = 131
    scheds, leaves = _quad_edge_schedules(b)
    frz = torch.from_numpy(leaves.astype(np.int32))
    near_tie, close_call = _near_tie_blocks(monkeypatch)
    outs = []
    for i, ops in enumerate(scheds):
        a, pm = _inputs(b, L, bs, seed=10 * b + i)
        a_t, pm_t = torch.from_numpy(a), torch.from_numpy(pm)
        kw = dict(b=b, llr_max=LLR_MAX, mode=mode,
                  frz=frz if ops[0][0] == "t" else None)
        sched = SubtreeSchedule(ops, "cpu")
        splits = [scl_subtree_host(a_t, pm_t, sched, n_shared=n, **kw)
                  for n in sorted({0, 2, 3, b} & set(range(b + 1)))]
        for other in splits[1:]:
            assert all(torch.equal(x, y) for x, y in zip(splits[0], other))
        got = [x.numpy() for x in splits[0]]
        outs.append(splits[0])
        want = [x.numpy() for x in scl_subtree_plain(a_t, pm_t, ops, **kw)]
        close_call(bs)
        _, rel, bad = block_agreement(want[:2], got[:2], want[2], got[2])
        assert rel <= PM_RTOL
        if mode == "minsum":
            assert not bad.any()
        else:
            assert not (bad & ~near_tie[-1].numpy()).any()
    assert _digest(outs) == QUAD_EDGE_DIGESTS[b, L, mode]


def test_block_smem_bytes_unchanged():
    """A block's dynamic shared memory is what it was with the scalar
    layout: per codeword 5 bytes a row and path of the shared stages
    (f32, then int8, each 8-aligned) plus its exchange arrays, so the
    budget keeps 6 shared stages at L = 8."""
    align8 = lambda x: (x + 7) & ~7
    for L in cuda_scl.LIST_SIZES:
        C = cuda_scl.THREADS // L
        exchange = align8(33 * L + 2 * L * L)   # sizeof(GroupShared<L>)
        for n in range(11):
            rows = (1 << n) - 1
            want = align8(align8(4 * rows * C * L) + C * exchange
                          + rows * C * L)
            assert cuda_scl.block_smem_bytes(L, n, route="host") == want
    assert cuda_scl.shared_stages(10, 8, route="host") == 6


def test_quad_row_counts():
    """The f/g and rise rows a path that run on quads and those that stay
    scalar: scl8's fast schedule at b=10 and the uplink (19, 864) code's PC
    leaf schedule at b=8."""
    from polar_torch.models.polar.encode import Polar5GEncoder
    (ops,) = _sub_units(_mask_5g(512, 1024), 10, True)
    assert cuda_scl.row_counts(ops, 10) == (8988, 174)
    enc = Polar5GEncoder(19, 864, device="cpu")
    mask = np.zeros(enc.n_polar, bool)
    mask[enc.frozen_pos] = True
    pc = np.zeros(enc.n_polar, bool)
    pc[enc.pc_pos] = True
    assert cuda_scl.row_counts(tuple(leaf_schedule(mask, pc)), 8) == (2304,
                                                                      768)
    assert cuda_scl.row_counts((("o", 1, 0),), 1) == (0, 0)
    assert cuda_scl.row_counts((("i", 0, 0), ("f", 0, 1)), 1) == (0, 3)
