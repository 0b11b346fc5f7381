"""Headline benchmark of the port: decoded info bits/s through the whole
Monte-Carlo chain (source -> polar encoder on a 5G-ranked code -> QPSK ->
AWGN -> exact demapper -> fast-SCL list decoder with rate-1 nodes -> error
counters) at k=512, n=1024, SCL-8, bs=8192 and 2.0 dB, the north-star
configuration of ``BASELINE.md`` (reference: 2,690 info bits/s on the CPU
along its own CLI path).

    python -m polar_torch.bench                     # on the card
    python -m polar_torch.bench --device cpu --k 32 --n 64 --bs 64 \\
        --iters 2 --warmup 1                        # small, on the CPU

It prints ONE JSON line on stdout: ``metric``, ``value`` (info bit/s),
``unit`` and ``vs_baseline`` as the JAX package's ``bench.py`` prints them,
and ``ms_per_step``, ``bs``, ``iters``, ``lower_stages`` (the decoder's
subtree depth), ``scl_subtree_launches`` (over the timed steps), and the
card's name and power limit as ``nvidia-smi`` reports them (``"cpu"`` and
null on the CPU). Diagnostics go to stderr.

One configuration runs, and a failure is an error: a kernel that does not
build or launch, no card without ``--device cpu``, or a timed loop on the
card that launched no ``scl_subtree`` kernel (or, on the fast sweep, its
traced form) exits non-zero. ``bench.py`` instead steps down a ladder of
configurations and never fails.

The timed loop runs ``iters`` steps after ``warmup`` steps, each step
counting its errors on the device from one generator there, with one
synchronisation after the loop; the host clock times the synchronised
loop. ``chip_smoke.py`` times its main path through the same
``build_model`` and ``time_steps``.
"""

import argparse
import json
import subprocess
import sys
import time

import torch

from polar_torch._device import resolve_device
from polar_torch.models.polar.construction import generate_5g_ranking
from polar_torch.models.polar.encode import PolarEncoder
from polar_torch.models.polar.scl import PolarSCLDecoder
from polar_torch.models.systems import SystemAWGNModel
from polar_torch.sim import count_block_errors, count_errors
from polar_torch.utils.kernel_work import launch_counts, reset_launch_counts
from polar_torch.utils.profiling import complexity_line, decode_complexity

BASELINE_INFO_BPS = 2690.0  # BASELINE.md: SCL-8 decode+chain, k=512 n=1024


def metric_name(list_size: int, n: int) -> str:
    return f"scl{list_size}_n{n}_chain_info_bits_per_s"


def build_model(k=512, n=1024, list_size=8, fast_scl=True, rate1=True,
                lower_stages=None, device=None) -> SystemAWGNModel:
    """The benchmark's chain: ``generate_5g_ranking(k, n)``, a
    ``PolarEncoder`` and a ``PolarSCLDecoder`` (min-sum; the fast sweep
    with ``fast_scl``, rate-1 nodes with ``rate1`` on it; subtree depth
    ``lower_stages``, by default the decoder's own) in a
    ``SystemAWGNModel`` with QPSK, on ``device`` (the card by default)."""
    device = resolve_device(device)
    frozen, _ = generate_5g_ranking(k, n)
    enc = PolarEncoder(frozen, n, device=device)
    dec = PolarSCLDecoder(frozen, n, list_size=list_size,
                          use_fast_scl=bool(fast_scl),
                          fast_rate1=bool(rate1 and fast_scl),
                          lower_stages=lower_stages, device=device)
    return SystemAWGNModel(n, k, enc, dec)


def time_steps(model, generator, bs, ebno_db, warmup, iters):
    """``warmup`` steps, then ``iters`` timed steps of ``model`` at
    ``ebno_db`` from ``generator``; a warm-up step counts its errors as a
    timed one does, so that the counting kernels are loaded before the
    clock starts. The error counts stay on the device until one
    synchronisation after the timed loop, which the host clock spans. The
    kernels' launch counts are set to 0 after the warm-up, so they hold
    the timed steps' launches afterwards. Returns (seconds per step, bit
    errors, block errors) of the timed steps."""
    if iters < 1:
        raise ValueError("iters must be at least 1")
    dev = model.device

    def counted_steps(count):
        errors = torch.zeros(2, dtype=torch.int64, device=dev)
        for _ in range(count):
            b, b_hat = model.step(generator, bs, ebno_db)
            errors += torch.stack([count_errors(b, b_hat),
                                   count_block_errors(b, b_hat)])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return errors

    counted_steps(warmup)
    reset_launch_counts()
    t0 = time.perf_counter()
    errors = counted_steps(iters)
    step_s = (time.perf_counter() - t0) / iters
    bit_errors, block_errors = errors.tolist()
    return step_s, bit_errors, block_errors


def card_info(device):
    """(name, power limit) of ``device`` as ``nvidia-smi --query-gpu=
    name,power.limit`` prints them; ``("cpu", None)`` on the CPU."""
    if device.type != "cuda":
        return "cpu", None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    name, power = out[min(device.index, len(out) - 1)].rsplit(",", 1)
    return name.strip(), power.strip()


def check_launches(counts, list_size, fast_scl):
    """Raises unless the timed loop on the card launched the SCL kernel,
    on the fast sweep never in its traced form, and at L <= 8 never in
    the wide one."""
    if counts["scl_subtree"] == 0:
        raise RuntimeError("the timed loop launched no scl_subtree kernel")
    if fast_scl and counts["scl_subtree traced"]:
        raise RuntimeError(f"the fast sweep left the static form: {counts}")
    if list_size <= 8 and counts["scl_subtree wide"]:
        raise RuntimeError(f"L={list_size} launched the wide form: {counts}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m polar_torch.bench",
        description="Info bit/s of the SCL chain (one JSON line).")
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--list-size", type=int, default=8)
    ap.add_argument("--bs", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--ebno-db", type=float, default=2.0)
    ap.add_argument("--fast-scl", type=int, choices=(0, 1), default=1)
    ap.add_argument("--rate1", type=int, choices=(0, 1), default=1)
    ap.add_argument("--lower-stages", type=int, default=None,
                    help="subtree depth b (default: the decoder's own)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    model = build_model(args.k, args.n, args.list_size, args.fast_scl,
                        args.rate1, args.lower_stages, dev)
    dec = model.decoder
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    step_s, bit_errors, _ = time_steps(model, gen, args.bs, args.ebno_db,
                                       args.warmup, args.iters)
    counts = launch_counts()
    if dev.type == "cuda":
        check_launches(counts, args.list_size, dec.use_fast_scl)
    bps = args.k * args.bs / step_s
    name, power = card_info(dev)
    print(json.dumps({
        "metric": metric_name(args.list_size, args.n),
        "value": round(bps, 1),
        "unit": "info bit/s",
        "vs_baseline": round(bps / BASELINE_INFO_BPS, 2),
        "ms_per_step": step_s * 1e3,
        "bs": args.bs,
        "iters": args.iters,
        "lower_stages": dec.lower_stages,
        "scl_subtree_launches": counts["scl_subtree"],
        "device": name,
        "power_limit": power,
    }), flush=True)

    bits = args.k * args.bs * args.iters
    print(f"# device={dev} bs={args.bs} iters={args.iters} "
          f"time={step_s * args.iters:.3f}s ber@{args.ebno_db}dB="
          f"{bit_errors / bits:.4f} schedule={dec.schedule} "
          f"fast_scl={dec.use_fast_scl} rate1={dec.fast_rate1} "
          f"b={dec.lower_stages} launches={counts}", file=sys.stderr)
    comp = decode_complexity(args.n, args.k, args.list_size,
                             frozen_mask=dec._frozen_mask,
                             fast=dec.use_fast_scl, rate1=dec.fast_rate1)
    print(complexity_line(f"SCL-{args.list_size}", comp), file=sys.stderr)
    print(f"# decode element-ops/s={comp.total() * args.bs / step_s:.3e}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
