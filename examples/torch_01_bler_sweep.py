"""BER/BLER sweep on the card: SC vs SCL-8 vs BP-20 on a 5G-ranked polar
code, with ``polar_torch`` (the PyTorch and CUDA port).

The library equivalent of the CLI run
``python -m polar_torch.main --k 64 --n 128 --algos [scl,bp]
--construction 5g``. SC decodes on the ``sc_subtree`` kernel, SCL-8 on the
``scl_subtree`` kernel (the fast sweep below n = 256, the plain one from
there up) and BP-20 on the ``bp`` kernel. Pass --k 512 --n 1024 for the
north-star code.

    python examples/torch_01_bler_sweep.py [--k 64 --n 128] [--png out.png]
    python examples/torch_01_bler_sweep.py --device cpu --batch-size 64 \\
        --max-mc-iter 2                             # small, on the CPU

The PNG (``--png``) needs matplotlib.
"""

import os
import sys

# runnable without installation: put the repo root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json

import numpy as np

import polar_torch as pt
from polar_torch.utils.kernel_work import launch_counts, reset_launch_counts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=2048)
    ap.add_argument("--max-mc-iter", type=int, default=50)
    ap.add_argument("--png", default=None, help="write the curves here")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()
    k, n, dev = args.k, args.n, args.device
    frozen, _ = pt.generate_5g_ranking(k, n)
    enc = pt.PolarEncoder(frozen, n, device=dev)
    ebno_dbs = np.arange(1.0, 3.5, 0.5)

    reset_launch_counts()
    plot = pt.PlotBER(f"Polar ({n},{k}) QPSK/AWGN")
    for name, dec in (
            ("SC", pt.PolarSCDecoder(frozen, n, device=dev)),
            ("SCL-8", pt.PolarSCLDecoder(frozen, n, list_size=8,
                                         device=dev)),
            ("BP-20", pt.PolarBPDecoder(frozen, n, num_iter=20,
                                        device=dev))):
        model = pt.SystemAWGNModel(n, k, enc, dec)
        ber, bler = plot.simulate(model, ebno_dbs,
                                  batch_size=args.batch_size,
                                  max_mc_iter=args.max_mc_iter,
                                  target_block_errs=500, add_bler=True,
                                  legend=name)
        print(f"{name}: BER  {np.asarray(ber).round(5)}")
        print(f"{name}: BLER {np.asarray(bler).round(5)}")
    print(f"kernel launches: {json.dumps(launch_counts())}")

    if args.png:
        import matplotlib
        matplotlib.use("Agg")
        fig, _ = plot.plot()
        fig.savefig(args.png, bbox_inches="tight")
        print(f"wrote {args.png}")


if __name__ == "__main__":
    main()
