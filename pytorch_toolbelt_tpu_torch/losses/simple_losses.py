"""Smaller loss modules (counterpart of ``pytorch_toolbelt_tpu/losses/simple_losses.py``).

Class axes follow pytorch-toolbelt: axis 1 for per-pixel and per-sample class
scores.
"""

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .functional import (
    balanced_binary_cross_entropy_with_logits,
    binary_cross_entropy_with_logits,
    label_smoothed_nll_loss,
    log_cosh_loss,
    reduce_loss,
    soft_micro_f1,
    wing_loss,
)

__all__ = [
    "SoftBCEWithLogitsLoss",
    "SoftCrossEntropyLoss",
    "BalancedBCEWithLogitsLoss",
    "BinarySoftF1Loss",
    "SoftF1Loss",
    "WingLoss",
    "LogCoshLoss",
    "FocalCosineLoss",
    "QualityFocalLoss",
]


class SoftBCEWithLogitsLoss(nn.Module):
    """BCE-with-logits with label smoothing and ignore_index.  ``weight`` and
    ``pos_weight`` broadcast against the input's trailing axes, as in
    ``F.binary_cross_entropy_with_logits``."""

    def __init__(
        self,
        weight: Optional[Sequence[float]] = None,
        ignore_index: Optional[int] = -100,
        reduction: str = "mean",
        smooth_factor: Optional[float] = None,
        pos_weight: Optional[Sequence[float]] = None,
    ):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.smooth_factor = smooth_factor
        self.pos_weight = pos_weight

    def forward(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if self.smooth_factor is not None:
            soft_targets = (1 - target) * self.smooth_factor + target * (1 - self.smooth_factor)
        else:
            soft_targets = target
        soft_targets = soft_targets.to(input.dtype)

        if self.pos_weight is not None:
            pw = torch.as_tensor(self.pos_weight, dtype=input.dtype, device=input.device)
            loss = -(pw * soft_targets * F.logsigmoid(input) + (1 - soft_targets) * F.logsigmoid(-input))
        else:
            loss = binary_cross_entropy_with_logits(input, soft_targets)

        if self.weight is not None:
            loss = loss * torch.as_tensor(self.weight, dtype=loss.dtype, device=loss.device)

        if self.ignore_index is not None:
            loss = loss * (target != self.ignore_index).to(loss.dtype)

        return reduce_loss(loss, self.reduction)


class SoftCrossEntropyLoss(nn.Module):
    """Label-smoothed cross entropy over the class axis ``axis`` (1: NCHW)."""

    def __init__(self, reduction: str = "mean", smooth_factor: float = 0.0, ignore_index: Optional[int] = -100,
                 axis: int = 1):
        super().__init__()
        self.reduction = reduction
        self.smooth_factor = smooth_factor
        self.ignore_index = ignore_index
        self.axis = axis

    def forward(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        log_prob = F.log_softmax(input, dim=self.axis)
        return label_smoothed_nll_loss(
            log_prob,
            target,
            epsilon=self.smooth_factor,
            ignore_index=self.ignore_index,
            reduction=self.reduction,
            axis=self.axis,
        )


class BalancedBCEWithLogitsLoss(nn.Module):
    """Balanced BCE."""

    def __init__(self, gamma: float = 1.0, reduction: str = "mean", ignore_index: Optional[int] = None):
        super().__init__()
        self.gamma = gamma
        self.reduction = reduction
        self.ignore_index = ignore_index

    def forward(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return balanced_binary_cross_entropy_with_logits(
            output, target, gamma=self.gamma, ignore_index=self.ignore_index, reduction=self.reduction
        )


class BinarySoftF1Loss(nn.Module):
    """1 - soft micro-F1 on sigmoid probabilities; ``ignore_index`` masks
    contributions (masked entries add nothing to tp/fp/fn)."""

    def __init__(self, ignore_index: Optional[int] = None, eps: float = 1e-6):
        super().__init__()
        self.ignore_index = ignore_index
        self.eps = eps

    def forward(self, preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        targets = targets.reshape(-1)
        preds = preds.reshape(-1)
        probs = torch.sigmoid(preds).clamp(self.eps, 1 - self.eps)
        if self.ignore_index is not None:
            keep = (targets != self.ignore_index).to(probs.dtype)
            probs = probs * keep
            targets = targets * keep
        return soft_micro_f1(probs.reshape(-1, 1), targets.reshape(-1, 1).to(probs.dtype))


class SoftF1Loss(nn.Module):
    """Multiclass soft-F1 loss on softmax probabilities: preds [B, C] (class
    axis 1), targets [B] integer labels."""

    def __init__(self, ignore_index: Optional[int] = None, eps: float = 1e-6):
        super().__init__()
        self.ignore_index = ignore_index
        self.eps = eps

    def forward(self, preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        num_classes = preds.shape[1]
        probs = torch.softmax(preds, dim=1).clamp(self.eps, 1 - self.eps).movedim(1, -1)
        targets = targets.long()
        keep = None
        if self.ignore_index is not None:
            # whole rows whose label is ignored contribute nothing to tp/fp/fn
            keep = (targets != self.ignore_index).to(probs.dtype)[..., None]
            targets = torch.where(targets == self.ignore_index, 0, targets)
        targets_oh = F.one_hot(targets, num_classes).to(probs.dtype)
        if keep is not None:
            probs = probs * keep
            targets_oh = targets_oh * keep
        return soft_micro_f1(probs, targets_oh)


class WingLoss(nn.Module):
    """Wing loss for landmarks."""

    def __init__(self, width: float = 5, curvature: float = 0.5, reduction: str = "mean"):
        super().__init__()
        self.width = width
        self.curvature = curvature
        self.reduction = reduction

    def forward(self, prediction: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return wing_loss(prediction, target, self.width, self.curvature, self.reduction)


class LogCoshLoss(nn.Module):
    """Mean log-cosh regression loss."""

    def forward(self, y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
        return log_cosh_loss(y_pred, y_true)


class FocalCosineLoss(nn.Module):
    """Cosine-embedding + focal CE mix (arXiv:2007.07805).  Inputs [B, C]
    logits, targets [B] int."""

    def __init__(self, alpha: float = 1.0, gamma: float = 2.0, xent: float = 0.1, reduction: str = "mean"):
        super().__init__()
        self.alpha = alpha
        self.gamma = gamma
        self.xent = xent
        self.reduction = reduction

    def forward(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        target = target.long()
        target_oh = F.one_hot(target, input.shape[-1]).to(input.dtype)

        # cosine embedding loss with y = 1: 1 - cos_sim(input, one_hot)
        denom = torch.linalg.vector_norm(input, dim=-1) * torch.linalg.vector_norm(target_oh, dim=-1)
        cosine_loss = 1.0 - torch.sum(input * target_oh, dim=-1) / denom.clamp_min(1e-8)
        if self.reduction == "mean":
            cosine_loss = cosine_loss.mean()
        elif self.reduction == "sum":
            cosine_loss = cosine_loss.sum()

        # cross entropy over L2-normalized logits
        normalized = input / torch.linalg.vector_norm(input, dim=-1, keepdim=True).clamp_min(1e-12)
        cent_loss = -F.log_softmax(normalized, dim=-1).gather(-1, target[..., None]).squeeze(-1)
        pt = torch.exp(-cent_loss)
        focal_loss = self.alpha * torch.pow(1 - pt, self.gamma) * cent_loss
        if self.reduction == "mean":
            focal_loss = focal_loss.mean()

        return cosine_loss + self.xent * focal_loss


class QualityFocalLoss(nn.Module):
    """Quality focal loss (arXiv:2006.04388)."""

    def __init__(self, beta: float = 2.0, reduction: str = "mean"):
        super().__init__()
        self.beta = beta
        self.reduction = reduction

    def forward(self, predictions: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        predictions = predictions.float()
        targets = targets.float()
        bce = binary_cross_entropy_with_logits(predictions, targets)
        focal_term = torch.pow((torch.sigmoid(predictions) - targets).abs(), self.beta)
        loss = focal_term * bce
        if self.reduction == "mean":
            return loss.mean()
        if self.reduction == "sum":
            return loss.sum()
        if self.reduction == "normalized":
            return loss.sum() / focal_term.sum()
        return loss
