"""CLI entry point: BER/BLER sweep of polar decoders over AWGN, on the
card unless ``--device cpu``.

    python -m polar_torch.main --k 512 --n 1024 --construction 5g --bs 8192
    python -m polar_torch.main --k 512 --n 1024 --construction 5g \
        --algos [scl,bp] --bs 8192
    python -m polar_torch.main --kern G16 --n 256 --k 128 \
        --construction rm-ref --osd_t 2 --bs 1024

``--kern`` (a name of the kernel zoo, ``models/polar/kernels.py``) picks
the kernel of both the construction and the encoder. On F2 the sweep
always simulates SC, adds SCL-<list_size> when ``scl`` is in ``--algos``
(the default) and BP-<bp_iter> when ``bp`` is. Any other kernel runs the
dense-G encoder with order-``osd_t`` OSD alone ("<KERN> OSD-<t>"): SC, SCL
and BP work on F2 only. Frozen sets come from the lowest-row-weight
construction (``--construction rm``, the default, stable ties; ``rm-ref``,
the reference CLI's own tie order), or, on F2 only, the 5G NR reliability
table (``5g``) or the Gaussian approximation at ``--design_snr`` (``ga``).
``sweep`` runs the decoders and returns the curves; ``main`` also draws
them to a PNG (needs matplotlib).
"""

import os

import numpy as np

from polar_torch.config import PolarConfig, parse_config
from polar_torch.models.polar.construction import (
    ARIKAN_F2, generate_5g_ranking, generate_ga_code, get_kern_frozen_bits,
    get_ref_rm_frozen_bits)
from polar_torch.models.polar.bp import PolarBPDecoder
from polar_torch.models.polar.dense import (DenseKernelDecoder,
                                            DenseKernelEncoder)
from polar_torch.models.polar.encode import PolarEncoder
from polar_torch.models.polar.kernels import get_kernel
from polar_torch.models.polar.sc import PolarSCDecoder
from polar_torch.models.polar.scl import PolarSCLDecoder
from polar_torch.models.systems import SystemAWGNModel
from polar_torch.plotting import PlotBER
from polar_torch.utils.profiling import (bp_complexity, complexity_line,
                                        decode_complexity)


def gen_code(c: PolarConfig, name: str, mode: str = "sc"):
    """``[SystemAWGNModel, name]`` for the configured code with an SC
    (``mode="sc"``), SCL (``mode="scl"``), BP (``mode="bp"``) or dense-G
    OSD (``mode="osd"``) decoder. A kernel other than F2 always gives the
    dense-G encoder and OSD."""
    if c.n < 2 or c.n & (c.n - 1):
        raise ValueError("n must be a power of 2")
    kern_name = (c.kern or "F2").upper()
    kern = ARIKAN_F2 if kern_name == "F2" else get_kernel(kern_name)
    if c.construction == "rm":
        _, _, frozen_pos = get_kern_frozen_bits(c.n, c.n - c.k, kern)
    elif c.construction == "rm-ref":
        frozen_pos = get_ref_rm_frozen_bits(c.n, c.n - c.k, kern_name)
    elif kern_name != "F2":
        raise ValueError(f"--construction {c.construction} is F2-only; use "
                         f"rm/rm-ref with --kern {kern_name}")
    elif c.construction == "5g":
        frozen_pos, _ = generate_5g_ranking(c.k, c.n)
    elif c.construction == "ga":
        frozen_pos, _ = generate_ga_code(c.k, c.n, c.design_snr)
    else:
        raise ValueError(f"unknown construction {c.construction!r}")
    if mode == "osd" or kern_name != "F2":
        enc = DenseKernelEncoder(frozen_pos, c.n, kern, device=c.device)
        dec = DenseKernelDecoder(enc, t=c.osd_t)
        return [SystemAWGNModel(c.n, c.k, enc, dec), name]
    f_mode = "minsum" if c.mode in ("max", "minsum") else "exact"
    enc = PolarEncoder(frozen_pos, c.n, device=c.device)
    if mode == "sc":
        dec = PolarSCDecoder(frozen_pos, c.n, mode=f_mode, device=c.device)
    elif mode == "scl":
        dec = PolarSCLDecoder(frozen_pos, c.n, c.list_size, mode=f_mode,
                              use_fast_scl=c.fast_scl, device=c.device)
    elif mode == "bp":
        dec = PolarBPDecoder(frozen_pos, c.n, num_iter=c.bp_iter,
                             mode=f_mode, device=c.device)
    else:
        raise ValueError(f"unknown decode mode {mode!r}")
    return [SystemAWGNModel(c.n, c.k, enc, dec), name]


def sweep(c: PolarConfig, ebno_dbs=None, jsonl_path=None) -> PlotBER:
    """Simulate SC (and SCL-<L> when ``scl`` is in ``c.algos``, BP-<iter>
    when ``bp`` is), or "<KERN> OSD-<t>" alone for a kernel other than F2,
    over ``ebno_dbs`` (default ``arange(0, c.snr_end, 0.5)``), printing
    each decoder's complexity line (none for OSD) and progress table.
    ``jsonl_path`` collects one JSON line per point and decoder, in that
    order. Returns the curves."""
    if ebno_dbs is None:
        ebno_dbs = np.arange(0, c.snr_end, 0.5)
    kern_name = (c.kern or "F2").upper()
    if kern_name != "F2":
        codes_under_test = [gen_code(c, f"{kern_name} OSD-{c.osd_t}",
                                     mode="osd")]
    else:
        codes_under_test = [gen_code(c, "SC", mode="sc")]
        if "scl" in c.algos:
            codes_under_test.append(gen_code(c, f"SCL-{c.list_size}",
                                             mode="scl"))
        if "bp" in c.algos:
            codes_under_test.append(gen_code(c, f"BP-{c.bp_iter}",
                                             mode="bp"))
    ber_plot = PlotBER(f"Performance of Short Len Codes (k={c.k}, n={c.n})")
    for model, name in codes_under_test:
        print("\nRunning: " + name)
        dec = model.decoder
        if "OSD" in name:
            comp = None     # no closed-form count for the pattern sweep
        elif name.startswith("BP"):
            comp = bp_complexity(c.n, c.k, c.bp_iter)
        else:
            L = c.list_size if name.startswith("SCL") else 1
            fast = bool(getattr(dec, "use_fast_scl", False)) and L > 1
            comp = decode_complexity(
                c.n, c.k, L, fast=fast, frozen_mask=dec._frozen_mask,
                rate1=bool(getattr(dec, "fast_rate1", False)))
        if comp is not None:
            print(complexity_line(name, comp))
        ber_plot.simulate(
            model, ebno_dbs=ebno_dbs, batch_size=c.bs,
            target_block_errs=c.target_block_errs, legend=name,
            soft_estimates=False, max_mc_iter=c.mc_iter, add_bler=True,
            seed=c.seed, jsonl_path=jsonl_path)
    return ber_plot


def render(c: PolarConfig, ber_plot: PlotBER) -> str:
    """Draw the BLER curves of ``ber_plot`` to a PNG in ``c.plot_dir``;
    returns its path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.subplots(figsize=(16, 12))
    plt.xticks(fontsize=18)
    plt.yticks(fontsize=18)
    plt.title(f"SC vs scl (k={c.k},n={c.n})", fontsize=25)
    plt.grid(which="both")
    plt.xlabel(r"$E_b/N_0$ (dB)", fontsize=25)
    plt.ylabel(r"BLER", fontsize=25)
    for i, legend in enumerate(ber_plot.legend):
        if "BLER" in legend:
            linestyle = "--" if legend.startswith("SC") and \
                not legend.startswith("SCL") else "-"
            plt.semilogy(ber_plot.snr[i], ber_plot.ber[i], c=f"C{i}",
                         label=legend, linewidth=2, linestyle=linestyle)
    plt.legend(fontsize=20)
    plt.xlim([0, 4.5])
    os.makedirs(c.plot_dir, exist_ok=True)
    out = os.path.join(c.plot_dir, f"sc_mc_iter={c.mc_iter}_bs={c.bs}.png")
    plt.savefig(out)
    plt.close()
    return out


def main(c: PolarConfig = None):
    if c is None:
        c = parse_config()
    print(c.algos, type(c.algos))
    out = render(c, sweep(c))
    print(f"saved plot to {out}")
    return out


if __name__ == "__main__":
    main()
