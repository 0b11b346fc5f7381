"""The program's ``polar_bp`` system: a ``SystemAWGNModel`` (QPSK, AWGN,
exact demapper) around a ``PolarEncoder`` and a ``PolarBPDecoder`` of the
5G-ranked code (``generate_5g_ranking(k, n)``), built through the
package's public classes as a user of ``python -m polar_torch.main
--algos [bp]`` builds them."""

import polar_torch as pt


def build(cfg, device):
    """The configuration's model on ``device``."""
    if cfg["code"] != "5g_ranked" or cfg["decoder"] != "bp":
        raise ValueError(f"no {cfg['code']}/{cfg['decoder']} chain")
    k, n = int(cfg["k"]), int(cfg["n"])
    frozen, _ = pt.generate_5g_ranking(k, n)
    enc = pt.PolarEncoder(frozen, n, device=device)
    dec = pt.PolarBPDecoder(frozen, n, num_iter=int(cfg["num_iter"]),
                            mode=cfg["mode"], msf=float(cfg["msf"]),
                            early_stop=bool(cfg["early_stop"]),
                            check_every=int(cfg["check_every"]),
                            llr_max=float(cfg["llr_max"]), device=device)
    return pt.SystemAWGNModel(n, k, enc, dec)
