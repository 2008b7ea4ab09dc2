"""Normalization registry (counterpart of ``pytorch_toolbelt_tpu/nn/normalization.py``).

Accepts every spelling the JAX package accepts.  ``momentum`` follows torch's
convention: torch 0.1 is flax 0.9.  In training mode torch updates
``running_var`` with the unbiased batch variance where flax uses the biased
one; the normalised output is the same.
"""

from typing import Optional

import torch
from torch import nn

__all__ = ["NORM_BATCH", "NORM_GROUP", "NORM_INSTANCE", "Normalization", "instantiate_normalization_block"]

NORM_BATCH = "batch_norm"
NORM_INSTANCE = "instance_norm"
NORM_GROUP = "group_norm"

_BATCH_ALIASES = {
    "bn", "batch", "batch2d", "batch_norm", "batch_norm_2d", "batchnorm", "batchnorm2d",
    "bn3d", "batch3d", "batch_norm3d", "batch_norm_3d", "batchnorm3d",
}
_GROUP_ALIASES = {"gn", "group", "group_norm", "groupnorm"}
_INSTANCE_ALIASES = {
    "in", "instance", "instance2d", "instance_norm", "instancenorm", "instance_norm_2d",
    "instancenorm2d", "in3d", "instance3d", "instance_norm_3d", "instancenorm3d",
}


class Normalization(nn.Module):
    """One wrapper for every normalization kind a block can name.  The
    wrapped torch module is ``self.norm``."""

    def __init__(
        self,
        kind: str,
        num_channels: int,
        num_groups: Optional[int] = None,
        eps: float = 1e-5,
        momentum: float = 0.1,
    ):
        super().__init__()
        self.kind = kind
        k = kind.lower()
        if k in _BATCH_ALIASES:
            self.norm = nn.BatchNorm2d(num_channels, eps=eps, momentum=momentum)
        elif k in _GROUP_ALIASES:
            self.norm = nn.GroupNorm(num_groups or 32, num_channels, eps=eps)
        elif k in _INSTANCE_ALIASES:
            # the JAX package's instance norm has no affine parameters either
            self.norm = nn.InstanceNorm2d(num_channels, eps=eps, affine=False)
        else:
            raise KeyError(f"Unknown normalization type '{kind}'")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


def instantiate_normalization_block(normalization: str, in_channels: int, **kwargs) -> Normalization:
    """String factory matching the JAX package's accepted spellings."""
    return Normalization(normalization, in_channels, num_groups=kwargs.get("num_groups"))
