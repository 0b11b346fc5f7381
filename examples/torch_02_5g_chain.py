"""TS 38.212 5G NR polar chain on the card: CRC attach, rate matching,
CA-SCL decode, with ``polar_torch`` (the PyTorch and CUDA port).

``Polar5GEncoder`` / ``Polar5GDecoder`` at k=400, E=1000 (uplink, CRC11,
a 1024-bit mother code), CA-SCL-8 with the CRC status, then hybSCL-8, the
serving path (SC first, CA-SCL again on the blocks whose CRC fails).
CA-SCL decodes the whole tree in one ``scl_subtree`` kernel call; hybSCL's
SC pass runs on the ``sc_subtree`` kernel.

    python examples/torch_02_5g_chain.py
    python examples/torch_02_5g_chain.py --device cpu --batch-size 8
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
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--ebno-db", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()
    k, n = 400, 1000  # any n, not just powers of two (rate matching)
    enc = pt.Polar5GEncoder(k=k, n=n, device=args.device)  # uplink, CRC11
    dec = pt.Polar5GDecoder(enc, dec_type="SCL", list_size=8,
                            return_crc_status=True)

    # one generator on the device drives the source and the channel
    gen = torch.Generator(device=enc.device).manual_seed(args.seed)
    u = pt.binary_source(gen, (args.batch_size, k))
    c = enc(u)

    # QPSK over AWGN, exact demap
    no = pt.ebnodb2no(args.ebno_db, n_bits_per_sym=2, coderate=k / n)
    constell = pt.Constellation(2, device=enc.device)
    x = pt.Mapper(constell)(c)
    y = pt.AWGN()(gen, (x, no))
    llr = pt.Demapper(constell)((y, no))

    reset_launch_counts()
    u_hat, crc_ok = dec(llr)
    ber = (u != u_hat).float().mean()
    print(f"BER {float(ber):.5f}; CRC pass rate "
          f"{float(crc_ok.float().mean()):.3f}")

    # hybSCL: SC first, CA-SCL again on the CRC failures only
    dec_hyb = pt.Polar5GDecoder(enc, dec_type="hybSCL", list_size=8)
    u_hyb = dec_hyb(llr)
    print(f"hybSCL BER {float((u != u_hyb).float().mean()):.5f}")
    print(f"kernel launches: {json.dumps(launch_counts())}")


if __name__ == "__main__":
    main()
