"""Random binary source."""

import torch


def binary_source(generator: torch.Generator, shape, dtype=torch.float32):
    """Uniform i.i.d. bits of ``shape`` on the generator's device."""
    return torch.randint(0, 2, tuple(shape), generator=generator,
                         device=generator.device).to(dtype)


class BinarySource:
    """``binary_source`` with a fixed dtype:
    ``__call__(generator, shape)``."""

    def __init__(self, dtype=torch.float32):
        self.dtype = dtype

    def __call__(self, generator: torch.Generator, shape):
        return binary_source(generator, shape, self.dtype)
