"""Dice loss (counterpart of ``pytorch_toolbelt_tpu/losses/dice.py``)."""

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import fused
from ._modes import BINARY_MODE, MULTICLASS_MODE, MULTILABEL_MODE, flatten_for_iou
from .functional import soft_dice_score

__all__ = ["DiceLoss", "BINARY_MODE", "MULTICLASS_MODE", "MULTILABEL_MODE"]


class DiceLoss(nn.Module):
    """Soft Dice loss for binary / multiclass / multilabel segmentation.

    NCHW: multiclass ``y_pred`` is [B, C, *spatial], ``y_true`` is
    [B, *spatial] int.  Classes with no ground-truth pixels contribute zero.
    """

    def __init__(
        self,
        mode: str,
        classes: Optional[Sequence[int]] = None,
        log_loss: bool = False,
        from_logits: bool = True,
        smooth: float = 0.0,
        ignore_index: Optional[int] = None,
        eps: float = 1e-7,
    ):
        super().__init__()
        if mode not in {BINARY_MODE, MULTICLASS_MODE, MULTILABEL_MODE}:
            raise ValueError(f"Unsupported mode {mode}")
        if classes is not None:
            if mode == BINARY_MODE:
                raise ValueError("Masking classes is not supported with mode=binary")
            classes = tuple(int(c) for c in classes)
        self.mode = mode
        self.classes = classes
        self.log_loss = log_loss
        self.from_logits = from_logits
        self.smooth = smooth
        self.ignore_index = ignore_index
        self.eps = eps

    def forward(self, y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
        if self.from_logits and fused.ENABLED:
            args = (float(self.smooth), float(self.eps), bool(self.log_loss), self.ignore_index, self.classes)
            if self.mode == MULTICLASS_MODE:
                return fused.fused_multiclass_dice(y_pred, y_true, *args)
            if self.mode == BINARY_MODE:
                bs = y_pred.shape[0]
                y_pred = y_pred.reshape(bs, 1, -1)
                y_true = y_true.reshape(bs, 1, -1)
            return fused.fused_sigmoid_dice(y_pred, y_true, *args)
        if self.from_logits:
            # log-exp route keeps gradients alive at extreme logits
            if self.mode == MULTICLASS_MODE:
                y_pred = F.log_softmax(y_pred, dim=1).exp()
            else:
                y_pred = F.logsigmoid(y_pred).exp()

        y_pred, y_true = flatten_for_iou(y_pred, y_true, self.mode, self.ignore_index)
        dims = (0, 2)  # reduce batch and positions, keep per-class scores

        scores = soft_dice_score(y_pred, y_true.to(y_pred.dtype), self.smooth, self.eps, dims)
        if self.log_loss:
            loss = -torch.log(scores.clamp_min(self.eps))
        else:
            loss = 1.0 - scores

        # zero contribution of channels with no true pixels
        loss = loss * (y_true.sum(dims) > 0).to(loss.dtype)

        if self.classes is not None:
            loss = loss[list(self.classes)]

        return loss.mean()
