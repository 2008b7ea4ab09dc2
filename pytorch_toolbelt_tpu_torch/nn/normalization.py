"""Normalization registry (counterpart of ``pytorch_toolbelt_tpu/nn/normalization.py``).

Accepts every spelling the JAX package accepts.  ``momentum`` follows torch's
convention: torch 0.1 is flax 0.9, and ``BN_MOMENTUM`` is flax's default
0.99 (a bare ``nn.BatchNorm``).  Batch norms are :class:`BatchNorm2d` (and
:class:`BatchNorm1d` on ``[B, F]``), whose training mode updates
``running_var`` with the biased batch variance, as flax does.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "BN_MOMENTUM", "BatchNorm1d", "BatchNorm2d", "NORM_BATCH", "NORM_GROUP", "NORM_INSTANCE", "Normalization",
    "instantiate_normalization_block",
]

NORM_BATCH = "batch_norm"
NORM_INSTANCE = "instance_norm"
NORM_GROUP = "group_norm"

# flax's BatchNorm momentum of 0.99, in torch's convention
BN_MOMENTUM = 0.01

_BATCH_ALIASES = {
    "bn", "batch", "batch2d", "batch_norm", "batch_norm_2d", "batchnorm", "batchnorm2d",
    "bn3d", "batch3d", "batch_norm3d", "batch_norm_3d", "batchnorm3d",
}
_GROUP_ALIASES = {"gn", "group", "group_norm", "groupnorm"}
_INSTANCE_ALIASES = {
    "in", "instance", "instance2d", "instance_norm", "instancenorm", "instance_norm_2d",
    "instancenorm2d", "in3d", "instance3d", "instance_norm_3d", "instancenorm3d",
}


class _BiasedRunningVariance:
    """Training mode of a torch batch norm that updates ``running_var`` with
    the biased batch variance (sum of squares over n), as flax's BatchNorm
    does; torch's uses the unbiased one (over n - 1).  The output is torch's.

    torch's kernel updates a copy of the running variance to
    ``(1 - m) * old + m * n / (n - 1) * var``; the module keeps
    ``(1 - m) * old`` and scales the rest by (n - 1) / n: a few elementwise
    ops on [C] and no extra pass over the input.  The copy, not the buffer,
    is what the kernel's backward saves, so the buffer may change after.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats and self.running_var is not None):
            return super().forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        m = self.momentum if self.momentum is not None else 1.0 / float(self.num_batches_tracked)
        updated = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, updated, self.weight, self.bias, True, m, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            kept = self.running_var * (1.0 - m)
            self.running_var.copy_((updated - kept) * ((n - 1) / n) + kept)
        return y


class BatchNorm2d(_BiasedRunningVariance, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running-variance update."""


class BatchNorm1d(_BiasedRunningVariance, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` with flax's running-variance update; flax's
    BatchNorm on a ``[B, F]`` input."""


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
            self.norm = BatchNorm2d(num_channels, eps=eps, momentum=momentum)
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
