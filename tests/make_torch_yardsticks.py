"""BLER yardsticks of the JAX package on the CPU for ``chip_smoke.py``'s
phases 9, 10, 11 and 12 (BP-20 with bf16 messages, the ``--kern`` OSD
path, the BEC link and the 5G uplink UCI chain with PC bits).

    JAX_PLATFORMS=cpu python tests/make_torch_yardsticks.py [--blocks N]
        [--bs B] [--only NAME ...]

Each row runs ``polar_tpu.sim.sim_ber`` on one system model at one point,
``blocks // bs`` batches of ``bs`` (seed ``SEED``), and prints one JSON
line with the block errors, the blocks and the BLER. The rows:

* ``g16_osd2_<ebno>``: ``polar_tpu.main.gen_code`` with ``--kern G16 --n
  256 --k 128 --construction rm-ref --osd_t 2``, dense-G encode and OSD-2,
  QPSK over AWGN;
* ``osd2_k64_n128``: OSD-2 on the 5G-ranked (64, 128) F2 code with
  ``pattern_chunk=1024`` and ``cw_estimates=True``, at 2.0 dB (the row of
  ``benchmarks/throughput_suite.py`` of the same name);
* ``bec_sc_<pe>``, ``bec_scl8_<pe>``: ``SystemBECModel`` on the 5G k=512
  n=1024 code with the CLI's SC and SCL-8 decoders (min-sum; SCL on the
  plain sweep), at erasure probability ``pe``;
* ``pc_sc_k19_e864``, ``pc_scl8_k19_e864``, ``pc_hybscl8_k19_e864``:
  ``Polar5GEncoder(19, 864)`` (uplink, CRC6, 3 PC bits, n_polar 256), QPSK
  over AWGN, ``Polar5GDecoder`` SC, CA-SCL-8 and hybSCL-8 in exact mode at
  4.5 dB; ``pc_scl8_k12_e48``: CA-SCL-8 on ``Polar5GEncoder(12, 48)`` at
  2.0 dB;
* ``bp20_n1024_bf16``: the CLI's BP-20 (scaled min-sum, msf 0.9375, early
  stop every 2 sweeps) with ``msg_dtype=jnp.bfloat16`` on the 5G k=512
  n=1024 code, QPSK over AWGN at 2.0 dB (the XLA engine: the CPU never
  takes the Pallas kernel).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 7
G16_EBNO_DB = (2.0, 3.0)
BEC_PE = (0.38, 0.42)
# the PC rows: (name, k, E, dec_type, Eb/N0 in dB)
PC_ROWS = (("pc_sc_k19_e864", 19, 864, "SC", 4.5),
           ("pc_scl8_k19_e864", 19, 864, "SCL", 4.5),
           ("pc_hybscl8_k19_e864", 19, 864, "hybSCL", 4.5),
           ("pc_scl8_k12_e48", 12, 48, "SCL", 2.0))


def rows():
    from polar_tpu.config import PolarConfig
    from polar_tpu.main import gen_code
    import jax.numpy as jnp
    from polar_tpu.models.osd import OSDecoder
    from polar_tpu.models.polar.bp import PolarBPDecoder
    from polar_tpu.models.polar.construction import generate_5g_ranking
    from polar_tpu.models.polar.decode5g import Polar5GDecoder
    from polar_tpu.models.polar.encode import Polar5GEncoder, PolarEncoder
    from polar_tpu.models.polar.sc import PolarSCDecoder
    from polar_tpu.models.polar.scl import PolarSCLDecoder
    from polar_tpu.models.systems import SystemAWGNModel, SystemBECModel

    def g16():
        c = PolarConfig(k=128, n=256, kern="G16", construction="rm-ref",
                        osd_t=2)
        return gen_code(c, "G16 OSD-2", mode="osd")[0]

    def osd2():
        frozen, _ = generate_5g_ranking(64, 128)
        enc = PolarEncoder(frozen, 128)
        dec = OSDecoder(t=2, encoder=enc, pattern_chunk=1024)
        return SystemAWGNModel(128, 64, enc, dec, cw_estimates=True)

    def bec(decoder):
        def make():
            frozen, _ = generate_5g_ranking(512, 1024)
            enc = PolarEncoder(frozen, 1024)
            dec = (PolarSCDecoder(frozen, 1024, mode="minsum")
                   if decoder == "sc" else
                   PolarSCLDecoder(frozen, 1024, 8, mode="minsum"))
            return SystemBECModel(1024, 512, enc, dec)
        return make

    def uci(k, e, dec_type):
        def make():
            enc = Polar5GEncoder(k, e)
            dec = Polar5GDecoder(enc, dec_type=dec_type, list_size=8,
                                 mode="exact")
            return SystemAWGNModel(e, k, enc, dec)
        return make

    def bp_bf16():
        frozen, _ = generate_5g_ranking(512, 1024)
        enc = PolarEncoder(frozen, 1024)
        dec = PolarBPDecoder(frozen, 1024, num_iter=20,
                             msg_dtype=jnp.bfloat16)
        return SystemAWGNModel(1024, 512, enc, dec)

    out = [(f"g16_osd2_{e}", g16, e) for e in G16_EBNO_DB]
    out.append(("osd2_k64_n128", osd2, 2.0))
    for pe in BEC_PE:
        out += [(f"bec_sc_{pe}", bec("sc"), pe),
                (f"bec_scl8_{pe}", bec("scl"), pe)]
    out += [(name, uci(k, e, dec_type), ebno)
            for name, k, e, dec_type, ebno in PC_ROWS]
    out.append(("bp20_n1024_bf16", bp_bf16, 2.0))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--blocks", type=int, default=8192)
    p.add_argument("--bs", type=int, default=256)
    p.add_argument("--only", nargs="*", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from polar_tpu.sim import sim_ber
    for name, make, point in rows():
        if args.only and name not in args.only:
            continue
        model = make()
        t0 = time.perf_counter()
        batches = args.blocks // args.bs
        _, bler = sim_ber(model, [point], batch_size=args.bs,
                          max_mc_iter=batches, early_stop=False,
                          verbose=False, seed=SEED)
        blocks = batches * args.bs
        print(json.dumps({"name": name, "point": point, "seed": SEED,
                          "blocks": blocks,
                          "block_errors": int(round(bler[0] * blocks)),
                          "bler": float(bler[0]),
                          "seconds": round(time.perf_counter() - t0, 1)}),
              flush=True)


if __name__ == "__main__":
    main()
