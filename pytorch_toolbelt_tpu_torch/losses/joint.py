"""Weighted loss composition (counterpart of ``pytorch_toolbelt_tpu/losses/joint.py``)."""

from typing import Callable, Sequence

import torch
from torch import nn

__all__ = ["WeightedLoss", "JointLoss", "sum_of_losses"]


class WeightedLoss(nn.Module):
    """Wrapper that multiplies a loss by a constant weight."""

    def __init__(self, loss: Callable, weight: float = 1.0):
        super().__init__()
        self.loss = loss
        self.weight = weight

    def forward(self, *args, **kwargs) -> torch.Tensor:
        return self.loss(*args, **kwargs) * self.weight


class JointLoss(nn.Module):
    """Weighted sum of two losses, e.g. ``JointLoss(DiceLoss(...), BinaryFocalLoss(), 1.0, 0.5)``."""

    def __init__(self, first: Callable, second: Callable, first_weight: float = 1.0, second_weight: float = 1.0):
        super().__init__()
        self.first = first
        self.second = second
        self.first_weight = first_weight
        self.second_weight = second_weight

    def forward(self, *args, **kwargs) -> torch.Tensor:
        return self.first(*args, **kwargs) * self.first_weight + self.second(*args, **kwargs) * self.second_weight


def sum_of_losses(losses: Sequence[Callable], weights: Sequence[float]) -> Callable:
    """N-ary generalization of JointLoss."""
    losses = tuple(losses)
    weights = tuple(weights)
    if len(losses) != len(weights):
        raise ValueError("losses and weights must have the same length")

    def total(*args, **kwargs):
        return sum(w * l(*args, **kwargs) for l, w in zip(losses, weights))

    return total
