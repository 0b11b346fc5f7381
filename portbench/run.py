"""The benchmark of the PyTorch and CUDA port, one cell a run:

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The cells, their configurations, traffic and
metrics are named in ``BENCHMARK.json``; ``portbench/README.md`` says how
the files fit together. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and ``checks``: each number the
comparison with the plain reference reads, beside its limit); the checks
also close standard error. No card, too few cards, a cell that cannot
run, or JAX or the JAX package loaded: a message on standard error, no
result, a non-zero exit. ``--device cpu`` runs the same on the CPU, for
the benchmark's own tests at small sizes (``--batch-size``).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program builds its kernels into build/ inside the checkout; any
# other compiler cache goes there too, at a fixed path
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "portbench",
                                             "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(ROOT, "build", "portbench",
                                            "cuda")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python3 portbench/run.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch-size", type=int, default=None)
    return ap.parse_args(argv)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None):
    args = parse_args(argv)
    try:
        from portbench import harness
        over = ({} if args.batch_size is None
                else {"batch_size": args.batch_size,
                      "reference_rows": args.batch_size})
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), device=args.device,
                                  overrides=over, log=log)
    except ImportError as exc:
        log(f"portbench: cannot import what the cell needs: {exc}")
        return 2
    except harness.CellError as exc:
        log(f"portbench: {exc}")
        return 2
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    log(f"correct {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
