"""Channel models: complex additive white Gaussian noise, and the binary
erasure (BEC) and binary symmetric (BSC) channels.

The binary channels sample their errors differentiably, so gradients can
flow through the channel: Gumbel-softmax at temperature 0.1 with a
straight-through binarizer (hard 0/1 forward, identity backward). The
outputs are arithmetic in the error indicator, never a boolean select on
it, so the gradient reaches it.
"""

import torch

from polar_torch.utils import tracing
from polar_torch.utils.numerics import expand_to_rank


def normal_parts(generator: torch.Generator, shape):
    """The standard normal draws of ``complex_normal``'s real and imaginary
    parts, in its order, on the generator's device."""
    dev = generator.device
    xr = torch.randn(tuple(shape), generator=generator, device=dev)
    xi = torch.randn(tuple(shape), generator=generator, device=dev)
    return xr, xi


def normal_std(var=1.0):
    """The f32 standard deviation ``sqrt(var / 2)`` of each real dimension
    of CN(0, var), on the host."""
    return (torch.as_tensor(var, dtype=torch.float32) / 2.0).sqrt()


def complex_normal(generator: torch.Generator, shape, var=1.0):
    """CN(0, var) samples on the generator's device; each real dimension
    has variance ``var / 2``."""
    std = normal_std(var)
    xr, xi = normal_parts(generator, shape)
    return torch.complex(std * xr, std * xi)


class AWGN:
    """``y = x + sqrt(no) * CN(0, 1)``; ``no`` is a scalar or broadcasts
    against ``x`` from the left."""

    def __call__(self, generator: torch.Generator, inputs):
        x, no = inputs
        noise = complex_normal(generator, x.shape)
        no = torch.as_tensor(no, dtype=torch.float32, device=x.device)
        tracing.count("h2d")
        no = no.reshape(no.shape + (1,) * (x.dim() - no.dim()))
        return x + noise * no.sqrt()


def _ste_binarize(x):
    """Straight-through binarizer: 0 below 0.5, else 1, forward; identity
    backward. ``x + (hard - x)`` is exactly ``hard`` for ``x`` in [0, 1]."""
    hard = torch.where(x < 0.5, 0.0, 1.0).to(x.dtype)
    return x + (hard - x).detach()


class BinaryMemorylessChannel:
    """Base of the discrete binary channels: differentiable Bernoulli error
    sampling. ``__call__(generator, (x, p))`` draws on the generator's
    device, which must be ``x``'s."""

    def __init__(self, return_llrs=False, bipolar_input=False, llr_max=100.0,
                 temperature=0.1, eps=1e-9):
        if llr_max < 0.0:
            raise ValueError("llr_max must be nonnegative")
        self.return_llrs = return_llrs
        self.bipolar_input = bipolar_input
        self.llr_max = float(llr_max)
        self.temperature = float(temperature)
        self._eps = float(eps)

    def _probability(self, p, x):
        """``p`` as an f32 tensor on ``x``'s device, clipped to [0, 1]
        (a tensor keeps its graph)."""
        tracing.count("h2d")
        return torch.as_tensor(p, dtype=torch.float32,
                               device=x.device).clamp(0.0, 1.0)

    def _sample_errors(self, generator, pb, shape):
        """Bernoulli(``pb``) error indicators of ``shape`` through the
        Gumbel-softmax trick and the straight-through binarizer."""
        u = torch.rand(tuple(shape) + (2,), generator=generator,
                       device=generator.device)
        q = -torch.log(-torch.log(u + self._eps) + self._eps)
        p = torch.stack([pb, 1.0 - pb], dim=-1)
        p = expand_to_rank(p, q.dim(), axis=0)
        a = (torch.log(p + self._eps) + q) / self.temperature
        e_cat = torch.softmax(a, dim=-1)
        return _ste_binarize(e_cat[..., 0])


class BinaryErasureChannel(BinaryMemorylessChannel):
    """Erasure channel: ``__call__(generator, (x, pe))``.

    With ``return_llrs=True``, a received bit becomes the logit
    ``+-llr_max`` (``llr > 0`` means 1) and an erasure a signed zero:
    ``-0.0`` for a 0 bit, ``+0.0`` for a 1 bit. Otherwise the output is
    ternary, with erasures marked -1 (binary input) or 0 (bipolar)."""

    def __call__(self, generator, inputs):
        x, pb = inputs
        pb = self._probability(pb, x)
        e = self._sample_errors(generator, pb, x.shape)
        if self.return_llrs:
            v = x if self.bipolar_input else 2.0 * x - 1.0
            return v * self.llr_max * (1.0 - e)
        erased_element = 0.0 if self.bipolar_input else -1.0
        return x * (1.0 - e) + erased_element * e


class BinarySymmetricChannel(BinaryMemorylessChannel):
    """Bit-flip channel with crossover probability ``pb``:
    ``__call__(generator, (x, pb))``. With ``return_llrs=True`` the output
    is the logit ``+-ln((1 - pb) / pb)``, clipped to ``llr_max``."""

    def __call__(self, generator, inputs):
        x, pb = inputs
        pb = self._probability(pb, x)
        e = self._sample_errors(generator, pb, x.shape)
        if self.bipolar_input:
            y = x * (1.0 - 2.0 * e)
        else:
            y = (x - e).abs()       # XOR of 0/1 values, differentiable
        if self.return_llrs:
            scale = torch.log((1.0 - pb) / pb.clamp_min(self._eps)).clamp(
                -self.llr_max, self.llr_max)
            v = y if self.bipolar_input else 2.0 * y - 1.0
            return scale * v
        return y
