"""Small tensor utilities."""

import torch


def int_mod_2(x):
    """``x % 2`` through a bitwise AND on an int32 view, in ``x``'s dtype."""
    return (x.to(torch.int32) & 1).to(x.dtype)
