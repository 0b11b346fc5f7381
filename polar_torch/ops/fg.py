"""Check-node (f) and variable-node (g) LLR updates and the SCL path-metric
update, as element-wise tensor functions.

* ``f_minsum``: ``sign(x) sign(y) min(|x|, |y|)`` after clipping to
  ``+-llr_max``; exact in f32.
* ``f_exact``: the log-domain boxplus ``ln(1 + e^(x+y)) - ln(e^x + e^y)``.
* ``g``: ``(1 - 2 u) x + y``.
* ``pm_update``: ``pm + softplus(-(1 - 2u) clip(llr))`` (Balatsoukas-Stimming
  et al., Eq. 10).
* ``make_scaled_minsum``: BP's normalized min-sum ``alpha f_minsum(x, y)``,
  and ``scaled_minsum_add``, ``alpha f_minsum(x, y) + z`` rounded once, as
  XLA contracts it into a fused multiply-add on the CPU.
* ``scaled_minsum_per_op``, ``logaddexp_per_op`` and ``f_exact_per_op``: the
  same updates computed in the dtype of their inputs with one rounding per
  op, as XLA runs bf16 on the CPU (BP's bf16 message lattice): no fused
  multiply-add, and ``jnp.logaddexp``'s own formula in place of
  ``torch.logaddexp``.
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


def make_scaled_minsum(alpha: float):
    """Scaled (normalized) min-sum ``alpha * f_minsum(x, y)``, one f32
    rounding of the product. Min-sum overestimates the boxplus magnitude,
    and in iterative BP that compounds over the sweeps."""
    alpha = float(alpha)

    def f(x, y, llr_max=LLR_MAX):
        return alpha * f_minsum(x, y, llr_max)

    return f


def fma_f32(a: float, b, c):
    """``a * b + c`` for f32 tensors ``b``, ``c`` and a scalar ``a`` taken as
    f32, rounded once to f32 as ``fmaf`` does.

    The product is exact in f64 (24 + 24 bits) and TwoSum gives the f64
    sum's rounding error exactly. The cast to f32 rounds the f64 sum, which
    is the correct rounding of the exact sum except where the f64 sum lies
    on the midpoint of two f32 neighbours: there the exact sum lies on the
    error's side of it."""
    a = torch.tensor(a, dtype=torch.float32).item()
    p = b.double() * a
    c = c.double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    r = s.float()
    d = s - r.double()
    nb = torch.nextafter(r, torch.where(d > 0, torch.inf, -torch.inf).to(r))
    tie = (d != 0) & (err != 0) & (2.0 * d == nb.double() - r.double())
    return torch.where(tie & ((err > 0) == (d > 0)), nb, r)


def scaled_minsum_add(alpha: float, x, y, z, llr_max=LLR_MAX):
    """``alpha * f_minsum(x, y) + z`` with one rounding."""
    return fma_f32(alpha, f_minsum(x, y, llr_max), z)


def scaled_minsum_per_op(alpha: float, x, y, llr_max=LLR_MAX):
    """``alpha * f_minsum(x, y)`` in the inputs' dtype: ``alpha`` and
    ``llr_max`` rounded to it first (as JAX casts a weak-typed constant),
    the product rounded once. ``alpha == 1`` leaves min-sum exact."""
    f = f_minsum(x, y, _rounded(llr_max, x.dtype))
    return f if float(alpha) == 1.0 else _rounded(alpha, x.dtype) * f


def logaddexp_per_op(p, q):
    """``max(p, q) + log1p(exp(-|p - q|))``, each op rounded to the inputs'
    dtype (``jnp.logaddexp``'s formula)."""
    return torch.maximum(p, q) + torch.log1p(torch.exp(-(p - q).abs()))


def f_exact_per_op(x, y, llr_max=LLR_MAX):
    """Exact boxplus in the inputs' dtype, one rounding per op."""
    m = _rounded(llr_max, x.dtype)
    x = _clip(x, m)
    y = _clip(y, m)
    return (logaddexp_per_op(torch.zeros_like(x), x + y)
            - logaddexp_per_op(x, y))


def _rounded(v: float, dtype) -> float:
    """``v`` rounded to ``dtype``, back as a Python float."""
    return torch.tensor(float(v), dtype=dtype).item()


def g(x, y, u_hat):
    """Variable-node update; ``u_hat`` is the left child's partial sum
    (0/1, any numeric dtype)."""
    return (1.0 - 2.0 * u_hat.to(x.dtype)) * x + y


def pm_update(pm, llr, u_hat, llr_max=LLR_MAX):
    """Path-metric increment for decision ``u_hat`` on ``llr``."""
    llr = _clip(llr, llr_max)
    return pm + softplus(-(1.0 - 2.0 * u_hat.to(llr.dtype)) * llr)
