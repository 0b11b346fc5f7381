"""Eb/N0 (dB) to noise variance."""

import torch


def ebnodb2no(ebno_db, n_bits_per_sym, coderate):
    """``No = 1 / (10^(EbNo/10) * coderate * bits_per_symbol)`` with unit
    symbol energy, as an f32 tensor."""
    ebno = 10.0 ** (torch.as_tensor(ebno_db, dtype=torch.float32) / 10.0)
    return 1.0 / (ebno * coderate * n_bits_per_sym)
