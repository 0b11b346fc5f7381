"""Random binary source."""

import torch


def binary_source(generator: torch.Generator, shape, dtype=torch.float32):
    """Uniform i.i.d. bits of ``shape`` on the generator's device."""
    return torch.randint(0, 2, tuple(shape), generator=generator,
                         device=generator.device).to(dtype)
