"""DropBlock structured dropout (arXiv:1810.12890; counterpart of
``pytorch_toolbelt_tpu/nn/dropblock.py``).  NCHW / NCDHW.

The seeds are drawn from an explicit ``torch.Generator`` (or torch's default
one), where JAX draws them from the ``dropout`` rng stream: the two packages
drop different blocks, and only the rule is shared.  ``DropBlockScheduled``
keeps its step counter as a buffer (``step``, the JAX package's ``state``
variable).
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["DropBlock2D", "DropBlock3D", "DropBlockScheduled"]


def _block_mask(seeds: torch.Tensor, block_size: int) -> torch.Tensor:
    """[B, *spatial] dropped seeds -> [B, *spatial] mask of 0 over every
    ``block_size`` block around a seed, 1 elsewhere (an even block is cut to
    the input's size at the low end, as the JAX package does)."""
    pool = F.max_pool2d if seeds.ndim == 3 else F.max_pool3d
    pooled = pool(seeds[:, None], block_size, stride=1, padding=block_size // 2)[:, 0]
    if block_size % 2 == 0:
        pooled = pooled[(slice(None),) + (slice(None, -1),) * (seeds.ndim - 1)]
    return 1.0 - pooled


def _drop_blocks(x: torch.Tensor, drop_prob, block_size: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """``x`` times the block mask of seeds drawn with probability
    ``drop_prob / block_size ** d``, rescaled by (mask size) / (kept count),
    with the mask shared across channels."""
    spatial = x.shape[2:]
    gamma = drop_prob / block_size ** len(spatial)
    seeds = (torch.rand((x.shape[0],) + tuple(spatial), generator=generator, device=x.device) < gamma).to(x.dtype)
    mask = _block_mask(seeds, block_size)
    kept = mask.numel() - (1.0 - mask).sum(dtype=torch.float32)
    return x * mask[:, None] * (mask.numel() / kept).to(x.dtype)


class DropBlock2D(nn.Module):
    """Zero random ``block_size`` x ``block_size`` blocks of an NCHW input in
    training; the identity in ``eval()`` or at ``drop_prob`` 0."""

    def __init__(self, drop_prob: float, block_size: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.drop_prob = drop_prob
        self.block_size = block_size
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 4:
            raise ValueError("Expected an NCHW input")
        if not self.training or self.drop_prob == 0.0:
            return x
        return _drop_blocks(x, self.drop_prob, self.block_size, self.generator)


class DropBlock3D(DropBlock2D):
    """The 3D analogue, on NCDHW volumes."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 5:
            raise ValueError("Expected an NCDHW input")
        if not self.training or self.drop_prob == 0.0:
            return x
        return _drop_blocks(x, self.drop_prob, self.block_size, self.generator)


class DropBlockScheduled(nn.Module):
    """DropBlock2D whose ``drop_prob`` ramps linearly from ``start_value`` to
    ``stop_value`` over ``nr_steps`` training calls after ``start_step``;
    each training call advances the ``step`` buffer.  The identity in
    ``eval()``."""

    def __init__(self, block_size: int, start_value: float, stop_value: float, nr_steps: int, start_step: int = 0,
                 dims: int = 2, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.block_size = block_size
        self.start_value, self.stop_value = start_value, stop_value
        self.nr_steps, self.start_step = nr_steps, start_step
        self.dims = dims
        self.generator = generator
        self.register_buffer("step", torch.zeros((), dtype=torch.int32))

    def drop_prob(self) -> torch.Tensor:
        """The rate of the next training call, a float32 scalar tensor."""
        ramp = ((self.step - self.start_step).float() / self.nr_steps).clamp(0.0, 1.0)
        return self.start_value + (self.stop_value - self.start_value) * ramp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        if x.ndim != 4:
            raise ValueError("Expected an NCHW input")
        drop_prob = self.drop_prob()
        self.step.add_(1)
        return _drop_blocks(x, drop_prob, self.block_size, self.generator)
