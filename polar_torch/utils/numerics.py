"""Small tensor utilities."""

import torch


def int_mod_2(x):
    """``x % 2`` through a bitwise AND on an int32 view, in ``x``'s dtype."""
    return (x.to(torch.int32) & 1).to(x.dtype)


def insert_dims(x, num_dims: int, axis: int = -1):
    """``x`` with ``num_dims`` length-one axes inserted at ``axis`` (a
    negative ``axis`` counts from the end of the result's new axes, as
    ``unsqueeze`` does)."""
    if num_dims < 0:
        raise ValueError("num_dims must be nonnegative")
    rank = x.dim()
    if not -(rank + 1) <= axis <= rank:
        raise ValueError(f"axis {axis} out of range for rank {rank}")
    axis = axis if axis >= 0 else rank + axis + 1
    return x.reshape(x.shape[:axis] + (1,) * num_dims + x.shape[axis:])


def expand_to_rank(x, target_rank: int, axis: int = -1):
    """``x`` (a tensor, or anything ``torch.as_tensor`` takes) with
    length-one axes inserted at ``axis`` until its rank is
    ``target_rank``."""
    x = torch.as_tensor(x)
    return insert_dims(x, max(target_rank - x.dim(), 0), axis)
