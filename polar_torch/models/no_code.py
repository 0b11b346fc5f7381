"""The uncoded baseline: an identity encoder and a hard-decision decoder."""

import torch


class NoEncoder:
    """Identity encoder."""

    def __call__(self, bits):
        return bits


class NoDecoder:
    """Hard decision on logits: ``llr > 0 -> 1``, as f32."""

    def __call__(self, llr):
        return torch.where(llr > 0, 1.0, 0.0)
