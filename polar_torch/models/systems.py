"""End-to-end link models: source -> encode -> (map) -> channel -> (demap)
-> decode, over AWGN or the binary erasure channel."""

import torch

from polar_torch.ops.channels import AWGN, BinaryErasureChannel
from polar_torch.ops.ebno import ebnodb2no
from polar_torch.ops.mapping import Constellation, Demapper, Mapper
from polar_torch.ops.source import binary_source


class SystemAWGNModel:
    """Gray-QAM (QPSK by default) over AWGN with exact demapping.

    ``step(generator, batch_size, ebno_db)`` runs one Monte-Carlo batch on
    the generator's device, which must be the encoder's and decoder's."""

    def __init__(self, n: int, k: int, encoder, decoder,
                 cw_estimates: bool = False, n_bits_per_sym: int = 2):
        self.n = n
        self.k = k
        self.coderate = k / n
        self.cw_estimates = cw_estimates
        self.n_bits_per_sym = n_bits_per_sym
        self.device = encoder.device
        self.constell = Constellation(n_bits_per_sym, device=self.device)
        self.mapper = Mapper(self.constell)
        self.demapper = Demapper(self.constell)
        self.awgn_channel = AWGN()
        self.encoder = encoder
        self.decoder = decoder

    def front(self, generator: torch.Generator, batch_size: int, ebno_db):
        """Source -> encode -> map -> AWGN -> demap. Returns
        ``(bits, codewords, llr)``."""
        no = ebnodb2no(ebno_db, self.n_bits_per_sym, self.coderate)
        bits = binary_source(generator, (batch_size, self.k))
        codewords = self.encoder(bits)
        x = self.mapper(codewords)
        y = self.awgn_channel(generator, (x, no))
        llr = self.demapper((y, no))
        return bits, codewords, llr

    def step(self, generator: torch.Generator, batch_size: int, ebno_db):
        """One batch: ``(bits, bits_hat)``, or ``(codewords, bits_hat)``
        with ``cw_estimates``."""
        bits, codewords, llr = self.front(generator, batch_size, ebno_db)
        bits_hat = self.decoder(llr)
        return (codewords if self.cw_estimates else bits), bits_hat

    __call__ = step


class SystemBECModel:
    """Binary erasure channel link: the SNR argument of ``step`` is the
    erasure probability ``pe``. The channel gives the decoder logits
    ``+-100`` for received bits and signed zeros for erasures.

    ``step(generator, batch_size, pe)`` runs one batch on the generator's
    device, which must be the encoder's and decoder's."""

    def __init__(self, n: int, k: int, encoder, decoder,
                 cw_estimates: bool = False):
        self.n = n
        self.k = k
        self.coderate = k / n
        self.cw_estimates = cw_estimates
        self.device = encoder.device
        self.channel = BinaryErasureChannel(return_llrs=True)
        self.encoder = encoder
        self.decoder = decoder

    def front(self, generator: torch.Generator, batch_size: int, pe):
        """Source -> encode -> BEC. Returns ``(bits, codewords, llr)``."""
        bits = binary_source(generator, (batch_size, self.k))
        codewords = self.encoder(bits)
        llr = self.channel(generator, (codewords, pe))
        return bits, codewords, llr

    def step(self, generator: torch.Generator, batch_size: int, pe):
        """One batch: ``(bits, bits_hat)``, or ``(codewords, bits_hat)``
        with ``cw_estimates``."""
        bits, codewords, llr = self.front(generator, batch_size, pe)
        bits_hat = self.decoder(llr)
        return (codewords if self.cw_estimates else bits), bits_hat

    __call__ = step
