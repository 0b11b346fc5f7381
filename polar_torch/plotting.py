"""BER/BLER curve store and plotting. matplotlib is imported only to draw,
so ``PlotBER.simulate`` runs where it is not installed."""

from polar_torch.sim import sim_ber


def plot_ber(plot_self, ylabel="BER"):
    """Semilogy plot of all stored curves; returns ``(fig, ax)``."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(16, 10))
    plt.xticks(fontsize=18)
    plt.yticks(fontsize=18)
    plt.title(plot_self.title, fontsize=25)
    for idx, b in enumerate(plot_self.ber):
        plt.semilogy(plot_self.snr[idx], b, linewidth=2)
    plt.grid(which="both")
    plt.xlabel(r"$E_b/N_0$ (dB)", fontsize=25)
    plt.ylabel(ylabel, fontsize=25)
    plt.legend(plot_self.legend, fontsize=20)
    return fig, ax


class PlotBER:
    """Accumulates (ber, snr, legend) curves across ``simulate()`` calls."""

    def __init__(self, title="Bit/Block Error Rate"):
        self.title = title
        self.ber = []
        self.snr = []
        self.legend = []

    def simulate(self, mc_fun, ebno_dbs, batch_size, legend="",
                 add_ber=True, add_bler=False, max_mc_iter=1,
                 soft_estimates=False, target_bit_errs=None,
                 target_block_errs=None, early_stop=True, verbose=True,
                 seed=42, **kwargs):
        """Run ``sim_ber`` and store the result curves."""
        ber, bler = sim_ber(
            mc_fun, ebno_dbs, batch_size, soft_estimates=soft_estimates,
            max_mc_iter=max_mc_iter, target_bit_errs=target_bit_errs,
            target_block_errs=target_block_errs, early_stop=early_stop,
            verbose=verbose, seed=seed, **kwargs)
        if add_ber:
            self.ber += [ber]
            self.snr += [ebno_dbs]
            self.legend += [legend]
        if add_bler:
            self.ber += [bler]
            self.snr += [ebno_dbs]
            self.legend += [legend + " (BLER)"]
        return ber, bler

    def plot(self, ylabel="BER"):
        return plot_ber(self, ylabel=ylabel)
