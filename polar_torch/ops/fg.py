"""Check-node (f) and variable-node (g) LLR updates and the SCL path-metric
update, as element-wise tensor functions.

* ``f_minsum``: ``sign(x) sign(y) min(|x|, |y|)`` after clipping to
  ``+-llr_max``; exact in f32.
* ``f_exact``: the log-domain boxplus ``ln(1 + e^(x+y)) - ln(e^x + e^y)``.
* ``g``: ``(1 - 2 u) x + y``.
* ``pm_update``: ``pm + softplus(-(1 - 2u) clip(llr))`` (Balatsoukas-Stimming
  et al., Eq. 10).
"""

import torch

LLR_MAX = 30.0


def softplus(x):
    """``log(1 + e^x)`` as ``logaddexp(0, x)``."""
    return torch.logaddexp(torch.zeros_like(x), x)


def _clip(x, llr_max):
    return torch.clamp(x, -llr_max, llr_max)


def f_minsum(x, y, llr_max=LLR_MAX):
    """Min-sum check-node update."""
    x = _clip(x, llr_max)
    y = _clip(y, llr_max)
    return torch.sign(x) * torch.sign(y) * torch.minimum(x.abs(), y.abs())


def f_exact(x, y, llr_max=LLR_MAX):
    """Exact log-domain boxplus."""
    x = _clip(x, llr_max)
    y = _clip(y, llr_max)
    return softplus(x + y) - torch.logaddexp(x, y)


F_FUNCTIONS = {"minsum": f_minsum, "max": f_minsum, "exact": f_exact,
               "llr": f_exact}


def g(x, y, u_hat):
    """Variable-node update; ``u_hat`` is the left child's partial sum
    (0/1, any numeric dtype)."""
    return (1.0 - 2.0 * u_hat.to(x.dtype)) * x + y


def pm_update(pm, llr, u_hat, llr_max=LLR_MAX):
    """Path-metric increment for decision ``u_hat`` on ``llr``."""
    llr = _clip(llr, llr_max)
    return pm + softplus(-(1.0 - 2.0 * u_hat.to(llr.dtype)) * llr)
