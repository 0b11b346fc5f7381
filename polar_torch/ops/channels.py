"""Complex additive white Gaussian noise."""

import torch


def complex_normal(generator: torch.Generator, shape, var=1.0):
    """CN(0, var) samples on the generator's device; each real dimension
    has variance ``var / 2``."""
    std = (torch.as_tensor(var, dtype=torch.float32) / 2.0).sqrt()
    dev = generator.device
    xr = torch.randn(tuple(shape), generator=generator, device=dev)
    xi = torch.randn(tuple(shape), generator=generator, device=dev)
    return torch.complex(std * xr, std * xi)


class AWGN:
    """``y = x + sqrt(no) * CN(0, 1)``; ``no`` is a scalar or broadcasts
    against ``x`` from the left."""

    def __call__(self, generator: torch.Generator, inputs):
        x, no = inputs
        noise = complex_normal(generator, x.shape)
        no = torch.as_tensor(no, dtype=torch.float32, device=x.device)
        no = no.reshape(no.shape + (1,) * (x.dim() - no.dim()))
        return x + noise * no.sqrt()
