"""The readings that the limits of ``portbench/limits/<cell>.json`` are set
from, at a cell's own size, in one process:

    python3 portbench/control.py --workload NAME --seeds 12 --control-seeds 3

* sound: the program's timed path as a run drives it (``sim_ber`` chunks
  through the ``Tap``, one sampled chunk a seed), judged by
  ``compare.judge`` on each of ``--seeds`` seeds;
* control: the plain reference put in the program's place and computed in
  bfloat16, the precision below the configuration's float32 (its draws,
  encoder, demapper and decoder; ``sim_ber``'s counts taken from its own
  decisions), judged the same way on ``--control-seeds`` seeds.

Each reading is one JSON line on standard output (and in ``--out``). The
benchmark's own runs never run this.
"""

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import compare, harness, reference  # noqa: E402
from portbench.reference import channel  # noqa: E402

FIRST_SEED = 2 ** 31 + 11
CHUNKS = 3          # chunks a sound seed runs; one is sampled


def control_sample(cfg, traffic, seed, device, dtype=torch.bfloat16):
    """One chunk as the reference in ``dtype`` would give it in the
    program's place: (chunk, seed, batches, ber, bler)."""
    k = int(cfg["k"])
    bs, m = int(traffic["batch_size"]), int(traffic["batches_per_chunk"])
    rows = int(traffic.get("reference_rows", bs))
    link = reference.link(cfg, device, dtype)
    ebno = compare.ebno_db(traffic)
    cs = harness.chunk_seed(seed, 0)
    batches, bit_e, blk_e = [], 0, 0
    for ii in range(m):
        s = channel.batch_seed(cs, 0, ii)
        bits, cw, llr = link.front(s, bs, ebno, dtype)
        bits_hat = link.decode(llr, rows)
        wrong = bits.to(torch.int8) != bits_hat
        bit_e += int(wrong.sum())
        blk_e += int(wrong.any(dim=-1).sum())
        batches.append((s, bits, cw, llr, bits_hat))
    return (0, cs, batches, bit_e / (m * bs * k), blk_e / (m * bs))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    _, _, cfg, traffic, _ = harness.cell_spec(args.workload)
    if args.batch_size:
        traffic = dict(traffic, batch_size=args.batch_size,
                       reference_rows=args.batch_size)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    def emit(row):
        line = json.dumps(dict(row, workload=args.workload))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")

    model = importlib.import_module(
        f"portbench.systems.{cfg['system']}").build(cfg, dev)
    tap = harness.Tap(model)
    tap.hold = True
    harness.run_chunks(tap, traffic, FIRST_SEED, -2, 2)
    for i in range(args.seeds):
        seed = FIRST_SEED + 7919 * i
        sample = harness.Reservoir(1, seed)
        harness.run_chunks(tap, traffic, seed, 0, CHUNKS, sample)
        t = time.perf_counter()
        checks = compare.judge(sample.items, cfg, traffic, dev)
        emit({"kind": "sound", "seed": seed, "reference_s":
              time.perf_counter() - t,
              **{k: v["value"] for k, v in checks.items()}})
    tap.detach()
    del model, tap
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for i in range(args.control_seeds):
        seed = FIRST_SEED + 104729 * (i + 1)
        sample = control_sample(cfg, traffic, seed, dev)
        checks = compare.judge([sample], cfg, traffic, dev)
        emit({"kind": "control", "seed": seed,
              **{k: v["value"] for k, v in checks.items()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
