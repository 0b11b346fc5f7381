"""The program's ``polar_sc`` system: a ``SystemAWGNModel`` (QPSK, AWGN,
exact demapper) around a ``PolarEncoder`` and a ``PolarSCDecoder`` of the
5G-ranked code (``generate_5g_ranking(k, n)``), built through the
package's public classes as ``python -m polar_torch.main`` builds the SC
chain that it simulates at every point (``gen_code(..., mode="sc")``),
with the decoder's default subtree depth."""

import polar_torch as pt


def build(cfg, device):
    """The configuration's model on ``device``."""
    if cfg["code"] != "5g_ranked" or cfg["decoder"] != "sc":
        raise ValueError(f"no {cfg['code']}/{cfg['decoder']} chain")
    k, n = int(cfg["k"]), int(cfg["n"])
    frozen, _ = pt.generate_5g_ranking(k, n)
    enc = pt.PolarEncoder(frozen, n, device=device)
    dec = pt.PolarSCDecoder(frozen, n, mode=cfg["mode"],
                            llr_max=float(cfg["llr_max"]), device=device)
    return pt.SystemAWGNModel(n, k, enc, dec)
