"""Focal loss modules (counterpart of ``pytorch_toolbelt_tpu/losses/focal.py``)."""

import warnings
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .functional import focal_loss_with_logits, softmax_focal_loss_with_logits

__all__ = ["BinaryFocalLoss", "CrossEntropyFocalLoss", "FocalLoss"]


def _weights(class_weights: Optional[Sequence[float]]):
    return None if class_weights is None else tuple(float(w) for w in class_weights)


class BinaryFocalLoss(nn.Module):
    """Focal loss for binary / multilabel problems, classes on axis 1.

    If targets have one dimension fewer than inputs, they are one-hot encoded
    onto axis 1 (ignored pixels keep ``ignore_index`` in every channel).
    """

    def __init__(
        self,
        alpha: Optional[float] = None,
        gamma: float = 2.0,
        ignore_index: Optional[int] = None,
        reduction: str = "mean",
        normalized: bool = False,
        reduced_threshold: Optional[float] = None,
        activation: str = "sigmoid",
        softmax_axis: Optional[int] = None,
        class_weights: Optional[Sequence[float]] = None,
    ):
        super().__init__()
        self.alpha = alpha
        self.gamma = gamma
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.normalized = normalized
        self.reduced_threshold = reduced_threshold
        self.activation = activation
        self.softmax_axis = softmax_axis
        self.class_weights = _weights(class_weights)

    def _one_hot_targets(self, targets: torch.Tensor, num_classes: int) -> torch.Tensor:
        if self.ignore_index is None:
            return F.one_hot(targets.long(), num_classes).movedim(-1, 1).float()
        ignored = targets == self.ignore_index
        oh = F.one_hot(torch.where(ignored, 0, targets).long(), num_classes).movedim(-1, 1).float()
        return oh.masked_fill(ignored.unsqueeze(1), float(self.ignore_index))

    def forward(self, inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        if targets.dim() + 1 == inputs.dim():
            targets = self._one_hot_targets(targets, inputs.shape[1])
        return focal_loss_with_logits(
            inputs,
            targets,
            gamma=self.gamma,
            alpha=self.alpha,
            reduction=self.reduction,
            normalized=self.normalized,
            reduced_threshold=self.reduced_threshold,
            ignore_index=self.ignore_index,
            activation=self.activation,
            softmax_axis=self.softmax_axis,
            class_weights=self.class_weights,
            class_axis=1,
        )


class CrossEntropyFocalLoss(nn.Module):
    """Multi-class focal loss via softmax: inputs [B, C, *spatial] logits,
    targets [B, *spatial] integer labels."""

    def __init__(
        self,
        gamma: float = 2.0,
        reduction: str = "mean",
        normalized: bool = False,
        reduced_threshold: Optional[float] = None,
        ignore_index: int = -100,
        class_weights: Optional[Sequence[float]] = None,
    ):
        super().__init__()
        self.gamma = gamma
        self.reduction = reduction
        self.normalized = normalized
        self.reduced_threshold = reduced_threshold
        self.ignore_index = ignore_index
        self.class_weights = _weights(class_weights)

    def forward(self, inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        return softmax_focal_loss_with_logits(
            inputs,
            targets,
            gamma=self.gamma,
            reduction=self.reduction,
            normalized=self.normalized,
            reduced_threshold=self.reduced_threshold,
            ignore_index=self.ignore_index,
            class_weights=self.class_weights,
        )


def FocalLoss(*args, **kwargs):
    """Deprecated alias of CrossEntropyFocalLoss."""
    warnings.warn(
        "FocalLoss is deprecated. Please use CrossEntropyFocalLoss instead.",
        DeprecationWarning,
        stacklevel=2,
    )
    return CrossEntropyFocalLoss(*args, **kwargs)
