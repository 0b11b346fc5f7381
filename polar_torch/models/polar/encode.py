"""Polar encoder for a given frozen set."""

import numpy as np
import torch

from polar_torch._device import resolve_device
from polar_torch.models.polar.construction import info_positions
from polar_torch.ops.butterfly import polar_transform


class PolarEncoder:
    """``__call__(u[..., k]) -> c[..., n]``: info bits go to the non-frozen
    positions (frozen positions are 0), then the polar transform."""

    def __init__(self, frozen_pos, n: int, dtype=torch.float32, device=None):
        n = int(n)
        if n & (n - 1):
            raise ValueError("n must be a power of 2")
        self.n = n
        self.dtype = dtype
        self.device = resolve_device(device)
        self.frozen_pos = np.asarray(frozen_pos, dtype=np.int64)
        self.info_pos = info_positions(self.frozen_pos, n)
        self.k = n - len(self.frozen_pos)
        # scatter as a gather from u padded with one zero (index k)
        gather = np.full(n, self.k, dtype=np.int64)
        gather[self.info_pos] = np.arange(self.k)
        self._scatter_idx = torch.from_numpy(gather).to(self.device)

    def scatter_info(self, u):
        """Info bits at ``info_pos``, zeros at the frozen positions."""
        u_pad = torch.cat([u, u.new_zeros(u.shape[:-1] + (1,))], dim=-1)
        return u_pad[..., self._scatter_idx]

    def __call__(self, u):
        if u.shape[-1] != self.k:
            raise ValueError(f"last dim must be of length k={self.k}")
        return polar_transform(self.scatter_info(u)).to(self.dtype)
