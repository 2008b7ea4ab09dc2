"""Stochastic depth (counterpart of ``pytorch_toolbelt_tpu/nn/drop_path.py``).

JAX draws the mask from the ``dropout`` rng stream; here it comes from an
explicit ``torch.Generator`` (or torch's default one), so the two packages
drop different samples and only the rule is shared.
"""

from typing import Optional

import torch
from torch import nn

__all__ = ["DropPath", "drop_path"]


def drop_path(
    x: torch.Tensor, drop_prob: float = 0.0, scale_by_keep: bool = True, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Drop whole samples of the batch with probability ``drop_prob`` and,
    with ``scale_by_keep``, scale the kept ones by 1 / (1 - drop_prob)."""
    if drop_prob == 0.0:
        return x
    keep_prob = 1.0 - drop_prob
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = (torch.rand(shape, generator=generator, device=x.device) < keep_prob).to(x.dtype)
    if keep_prob > 0.0 and scale_by_keep:
        mask = mask / keep_prob
    return x * mask


class DropPath(nn.Module):
    """``drop_path`` in training; the identity in ``eval()``."""

    def __init__(self, drop_prob: float = 0.0, scale_by_keep: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.drop_prob = drop_prob
        self.scale_by_keep = scale_by_keep
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.drop_prob == 0.0:
            return x
        return drop_path(x, self.drop_prob, self.scale_by_keep, self.generator)
