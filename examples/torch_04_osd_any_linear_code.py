"""Ordered-statistics decoding of an arbitrary linear code, with
``polar_torch`` (the PyTorch and CUDA port).

OSD approaches ML performance for any (n, k) generator matrix: here a
polar code, but any binary G works. OSD-2 runs in torch ops on the card;
the SCL-8 decoder it is set against runs on the ``scl_subtree`` kernel.

    python examples/torch_04_osd_any_linear_code.py
    python examples/torch_04_osd_any_linear_code.py --device cpu
"""

import os
import sys

# runnable without installation: put the repo root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json

import torch

import polar_torch as pt
from polar_torch.utils.kernel_work import launch_counts, reset_launch_counts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()
    k, n = 32, 64
    frozen, _ = pt.generate_5g_ranking(k, n)
    enc = pt.PolarEncoder(frozen, n, device=args.device)
    osd = pt.OSDecoder(t=2, encoder=enc)          # order-2 reprocessing
    scl = pt.PolarSCLDecoder(frozen, n, list_size=8, device=enc.device)

    gen = torch.Generator(device=enc.device).manual_seed(args.seed)
    u = pt.binary_source(gen, (args.batch_size, k))
    c = enc(u)
    no = pt.ebnodb2no(2.0, 2, k / n)
    constell = pt.Constellation(2, device=enc.device)
    y = pt.AWGN()(gen, (pt.Mapper(constell)(c), no))
    llr = pt.Demapper(constell)((y, no))

    reset_launch_counts()
    c_osd = osd(llr)                              # codeword estimate
    u_scl = scl(llr)
    print(f"OSD-2 codeword BER {float((c != c_osd).float().mean()):.5f}  "
          f"(SCL-8 info BER {float((u != u_scl).float().mean()):.5f})")
    print(f"kernel launches: {json.dumps(launch_counts())}")


if __name__ == "__main__":
    main()
