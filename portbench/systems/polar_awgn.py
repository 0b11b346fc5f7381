"""The program's ``polar_awgn`` system: a ``SystemAWGNModel`` (QPSK, AWGN,
exact demapper) around the encoder and decoder that a configuration names,
built through the package's public classes as a user builds them.

* ``code: 5g_ranked``, ``decoder: scl``: ``generate_5g_ranking(k, n)``, a
  ``PolarEncoder`` and a ``PolarSCLDecoder``;
* ``code: 5g_uci``, ``decoder: 5g_cascl``: ``Polar5GEncoder(k, n)`` (uplink)
  and ``Polar5GDecoder(dec_type="SCL")``.
"""

import polar_torch as pt


def build(cfg, device):
    """The configuration's model on ``device``."""
    k, n = int(cfg["k"]), int(cfg["n"])
    common = dict(list_size=int(cfg["list_size"]), mode=cfg["mode"])
    if cfg["code"] == "5g_ranked" and cfg["decoder"] == "scl":
        frozen, _ = pt.generate_5g_ranking(k, n)
        enc = pt.PolarEncoder(frozen, n, device=device)
        dec = pt.PolarSCLDecoder(frozen, n, use_fast_scl=cfg["fast_scl"],
                                 fast_rate1=cfg["fast_rate1"],
                                 llr_max=float(cfg["llr_max"]),
                                 device=device, **common)
    elif cfg["code"] == "5g_uci" and cfg["decoder"] == "5g_cascl":
        enc = pt.Polar5GEncoder(k, n, channel_type="uplink", device=device)
        dec = pt.Polar5GDecoder(enc, dec_type="SCL", **common)
    else:
        raise ValueError(f"no {cfg['code']}/{cfg['decoder']} chain")
    return pt.SystemAWGNModel(n, k, enc, dec)
