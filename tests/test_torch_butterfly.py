"""The SCL sweep's closing polar transform (``cuda_butterfly``): the host
build of the kernel's per-slice routines against the plain version, the
wrapper's checks and its CPU route, and the sweep with the host builds of
both of its kernels against the transform it ran before, at one subtree
(the int32 codeword as the kernel wrote it) and at several (the stacked
int8 codewords)."""

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401 (caps torch's threads under xdist)
from polar_torch.models.polar import scan_core
from polar_torch.models.polar.construction import generate_5g_ranking
from polar_torch.models.polar.cuda_butterfly import (
    butterfly_rows, butterfly_rows_host, butterfly_rows_plain)
from polar_torch.models.polar.cuda_scl import scl_subtree_host
from polar_torch.ops.butterfly import polar_transform
from polar_torch.utils import tracing


def _bits(m, w, C, dtype, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 2, (m, w, C), dtype=dtype))


@pytest.mark.parametrize("C", [1, 31, 32, 33, 4100])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("dtype", [np.int32, np.int8])
@pytest.mark.parametrize("b", range(1, 13))
def test_host_build_equals_plain(b, dtype, m, C):
    """w = 2^1 .. 2^12 (a word's rows only, up to 128 words a column), on
    column counts that fill no warp or block of the card."""
    x = _bits(m, 1 << b, C, dtype, seed=b * 100 + m * 10 + C)
    got = butterfly_rows_host(x)
    assert got.dtype == torch.int8 and got.shape == x.shape
    assert torch.equal(got, butterfly_rows_plain(x))
    assert torch.equal(got, polar_transform(x.to(torch.int8), axis=1))


def test_host_build_reads_bit_zero_only():
    """int32 codewords with bits above bit 0 set transform as their bit 0;
    so does the plain version."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (2, 64, 40),
                                      dtype=np.int64).astype(np.int32))
    want = polar_transform((x & 1).to(torch.int8), axis=1)
    assert torch.equal(butterfly_rows_host(x), want)
    assert torch.equal(butterfly_rows_plain(x), want)
    assert torch.equal(butterfly_rows_host(x.to(torch.int8)), want)


def test_host_build_reads_strided_blocks_and_rows():
    """Blocks and rows at any stride, as the sweep's views give them."""
    x = _bits(3, 16, 2 * 40, np.int32, seed=5)[:, :, ::2]
    x = x.transpose(0, 1).contiguous().transpose(0, 1)[:, :, :33]
    assert x.stride(2) == 1 and not x.is_contiguous()
    assert torch.equal(butterfly_rows_host(x), butterfly_rows_plain(x))


def test_wrapper_runs_plain_version_on_cpu():
    x = _bits(2, 256, 24, np.int32, seed=3)
    before = tracing.counter("launch.butterfly_rows")
    got = butterfly_rows(x)
    assert tracing.counter("launch.butterfly_rows") == before
    assert torch.equal(got, polar_transform(x.to(torch.int8), axis=1))


@pytest.mark.parametrize("case,error", [
    ("float32", TypeError), ("int64", TypeError), ("uint8", TypeError),
    ("rank2", ValueError), ("rank4", ValueError), ("w1", ValueError),
    ("w12", ValueError), ("w8192", ValueError), ("stride2", ValueError)])
def test_wrapper_rejects_bad_inputs(case, error):
    x = torch.zeros(2, 8, 16, dtype=torch.int32)
    bad = {
        "float32": lambda: x.float(),
        "int64": lambda: x.long(),
        "uint8": lambda: x.to(torch.uint8),
        "rank2": lambda: x[0],
        "rank4": lambda: x[None],
        "w1": lambda: x[:, :1],
        "w12": lambda: torch.zeros(2, 12, 16, dtype=torch.int32),
        "w8192": lambda: torch.zeros(1, 8192, 1, dtype=torch.int8),
        "stride2": lambda: x[:, :, ::2],
    }[case]()
    for fn in (butterfly_rows, butterfly_rows_host):
        with pytest.raises(error):
            fn(bad)


def _mask_5g(k, n):
    mask = np.zeros(n, bool)
    mask[generate_5g_ranking(k, n)[0]] = True
    return mask


def _parent_transform(x):
    """The transform the sweep ran before the kernel: the int8 codewords'
    ``polar_transform``."""
    return polar_transform(x.to(torch.int8), axis=1)


@pytest.mark.parametrize("sweep,b", [("fast", 8), ("fast", 5),
                                     ("plain", 8), ("plain", 4)])
def test_sweep_with_host_builds_equals_parent_transform(sweep, b,
                                                        monkeypatch):
    """n = 256: b = 8 is one subtree (m == 1, the int32 codeword goes to
    the transform as it is); b = 5 (fast, with rate-1 and repetition nodes
    above the subtrees) and b = 4 (plain, on the traced form) stack m int8
    codewords. The same u and path metrics as the transform before."""
    n, L, bs = 256, 8, 48
    mask = _mask_5g(128, n)
    rng = np.random.default_rng(b)
    c = rng.integers(0, 2, (n, bs))
    llr = torch.from_numpy(
        (2.0 * ((1.0 - 2.0 * c) + rng.normal(0, 0.8, (n, bs))) / 0.64)
        .astype(np.float32))
    if sweep == "fast":
        run = lambda: scan_core.scl_sweep_hybrid_fast(
            llr, mask, L, lower_stages=b, rate1=True,
            subtree=scl_subtree_host)
    else:
        run = lambda: scan_core.scl_sweep_hybrid(
            llr, mask, L, lower_stages=b, subtree=scl_subtree_host)
    calls = []

    def host(x):
        calls.append((x.dtype, tuple(x.shape)))
        return butterfly_rows_host(x)

    monkeypatch.setattr(scan_core, "butterfly_rows", _parent_transform)
    u_want, pm_want = run()
    monkeypatch.setattr(scan_core, "butterfly_rows", host)
    u_got, pm_got = run()
    m = n >> b
    assert calls == [(torch.int32 if m == 1 else torch.int8,
                      (m, 1 << b, L * bs))]
    assert u_got.dtype == torch.int8 and u_got.shape == (n, L, bs)
    assert torch.equal(u_got, u_want)
    assert torch.equal(pm_got, pm_want)
