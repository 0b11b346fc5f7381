"""The link's front end, plainly: the seeded draws, QPSK, AWGN and the
exact demapper.

The draws come from a ``torch.Generator`` seeded with a batch's seed, in
the order a Monte-Carlo batch makes them: the payload bits (``randint`` of
[bs, k]), then the real and the imaginary noise parts (``randn`` of
[bs, n / 2] each). Everything after the draws is computed here in the
dtype asked for (float64 for the reference, a lower one for the control).
"""

import math

import numpy as np
import torch


def batch_seed(seed, point, iteration):
    """The seed of batch ``iteration`` of Eb/N0 point ``point`` in a sweep
    seeded with ``seed``: numpy's SeedSequence of the three, one 64-bit
    word."""
    return int(np.random.SeedSequence([seed, point, iteration])
               .generate_state(1, np.uint64)[0])


def draws(seed, bs, k, n_sym, device):
    """(bits int64 [bs, k], noise real and imaginary f32 [bs, n_sym])."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bits = torch.randint(0, 2, (bs, k), generator=gen, device=device)
    nr = torch.randn((bs, n_sym), generator=gen, device=device)
    ni = torch.randn((bs, n_sym), generator=gen, device=device)
    return bits, nr, ni


def noise_variance(ebno_db, k, n):
    """N0 of QPSK at Eb/N0 ``ebno_db`` and rate k / n, unit symbol energy."""
    return 1.0 / (10.0 ** (float(ebno_db) / 10.0) * (k / n) * 2)


def qpsk_awgn_llr(cw, nr, ni, no, dtype):
    """Exact LLRs (positive means bit 1) [bs, n] of codeword bits ``cw``
    [bs, n] sent as Gray QPSK, bit pair (b0, b1) on ((1 - 2 b0) + j (1 -
    2 b1)) / sqrt(2), through y = x + sqrt(N0 / 2) (nr + j ni): for each
    bit, the log of the summed likelihoods of the two points that carry a 1
    less that of the two that carry a 0."""
    a = 1.0 / math.sqrt(2.0)
    c = cw.to(dtype).reshape(cw.shape[0], -1, 2)
    s = math.sqrt(no / 2.0)
    y = [(1.0 - 2.0 * c[..., 0]) * a + s * nr.to(dtype),
         (1.0 - 2.0 * c[..., 1]) * a + s * ni.to(dtype)]
    pts = torch.tensor([[a, a], [a, -a], [-a, a], [-a, -a]], dtype=dtype,
                       device=cw.device)            # point of label 2 b0 + b1
    d = -((y[0][..., None] - pts[:, 0]) ** 2
          + (y[1][..., None] - pts[:, 1]) ** 2) / no   # [bs, n/2, 4]
    llr = []
    for bit in (0, 1):
        ones = [p for p in range(4) if (p >> (1 - bit)) & 1]
        zeros = [p for p in range(4) if not (p >> (1 - bit)) & 1]
        llr.append(torch.logsumexp(d[..., ones], dim=-1)
                   - torch.logsumexp(d[..., zeros], dim=-1))
    return torch.stack(llr, dim=-1).reshape(cw.shape[0], -1)
