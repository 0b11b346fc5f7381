"""End-to-end link models: source -> encode -> (map) -> channel -> (demap)
-> decode, over AWGN or the binary erasure channel.

Each model's ``requires_host`` is its decoder's (False where the decoder
has none), as in the JAX package, whose models and ``sim_ber`` keep such a
decoder out of one jitted program. The port runs eagerly and does not read
it; it is informational.

``step`` runs the front end in the span ``chain.front`` and the decoder in
``chain.decode`` (``utils.tracing``); ``front`` marks ``front.source``,
``front.encode``, ``front.map``, ``front.channel`` and ``front.demap``, or,
where ``SystemAWGNModel`` takes the QPSK transmitter kernel,
``front.source`` and ``front.transmit``."""

import torch

from polar_torch.models.polar.cuda_front import qpsk_front, transmit_plan
from polar_torch.ops.channels import AWGN, BinaryErasureChannel, normal_parts
from polar_torch.ops.ebno import ebnodb2no
from polar_torch.ops.mapping import Constellation, Demapper, Mapper
from polar_torch.ops.source import binary_source
from polar_torch.utils import tracing


class SystemAWGNModel:
    """Gray-QAM (QPSK by default) over AWGN with exact demapping.

    ``step(generator, batch_size, ebno_db)`` runs one Monte-Carlo batch on
    the generator's device, which must be the encoder's and decoder's.

    Where ``cuda_front.transmit_plan`` finds the chain a plain polar code
    over QPSK on a card, everything between the draws and the LLRs is one
    kernel launch (``cuda_front.qpsk_front``), with the same draws and the
    same ``(bits, codewords, llr)`` bit for bit; elsewhere (the CPU, other
    constellations, the 5G and dense-G encoders) the composed chain runs.
    The choice is made once, when the model is built."""

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
        self.requires_host = getattr(decoder, "requires_host", False)
        # a model sized unlike its encoder keeps the composed chain, whose
        # encoder raises on it
        plan = transmit_plan(encoder, self.constell, self.device)
        self._transmit = (plan if plan and (encoder.n, encoder.k) == (n, k)
                          else None)

    def front(self, generator: torch.Generator, batch_size: int, ebno_db):
        """Source -> encode -> map -> AWGN -> demap. Returns
        ``(bits, codewords, llr)``."""
        no = ebnodb2no(ebno_db, self.n_bits_per_sym, self.coderate)
        with tracing.span("front.source"):
            bits = binary_source(generator, (batch_size, self.k))
        if self._transmit is not None and no.numel() == 1:
            with tracing.span("front.transmit"):
                xr, xi = normal_parts(generator, (batch_size, self.n // 2))
                codewords, llr = qpsk_front(bits, xr, xi, *self._transmit,
                                            no)
            return bits, codewords, llr
        with tracing.span("front.encode"):
            codewords = self.encoder(bits)
        with tracing.span("front.map"):
            x = self.mapper(codewords)
        with tracing.span("front.channel"):
            y = self.awgn_channel(generator, (x, no))
        with tracing.span("front.demap"):
            llr = self.demapper((y, no))
        return bits, codewords, llr

    def step(self, generator: torch.Generator, batch_size: int, ebno_db):
        """One batch: ``(bits, bits_hat)``, or ``(codewords, bits_hat)``
        with ``cw_estimates``."""
        with tracing.span("chain.front"):
            bits, codewords, llr = self.front(generator, batch_size, ebno_db)
        with tracing.span("chain.decode"):
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
        self.requires_host = getattr(decoder, "requires_host", False)

    def front(self, generator: torch.Generator, batch_size: int, pe):
        """Source -> encode -> BEC. Returns ``(bits, codewords, llr)``."""
        with tracing.span("front.source"):
            bits = binary_source(generator, (batch_size, self.k))
        with tracing.span("front.encode"):
            codewords = self.encoder(bits)
        with tracing.span("front.channel"):
            llr = self.channel(generator, (codewords, pe))
        return bits, codewords, llr

    def step(self, generator: torch.Generator, batch_size: int, pe):
        """One batch: ``(bits, bits_hat)``, or ``(codewords, bits_hat)``
        with ``cw_estimates``."""
        with tracing.span("chain.front"):
            bits, codewords, llr = self.front(generator, batch_size, pe)
        with tracing.span("chain.decode"):
            bits_hat = self.decoder(llr)
        return (codewords if self.cw_estimates else bits), bits_hat

    __call__ = step
