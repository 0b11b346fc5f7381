"""Error counters of the Monte-Carlo simulation."""

import torch


def count_errors(b, b_hat):
    """Number of differing bits (int64 tensor)."""
    return torch.count_nonzero(b != b_hat)


def count_block_errors(b, b_hat):
    """Number of blocks (last dim) with at least one bit error."""
    return torch.count_nonzero((b != b_hat).any(dim=-1))
