"""Shared mode constants + flattening for Dice/Jaccard-style losses."""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

BINARY_MODE = "binary"
MULTICLASS_MODE = "multiclass"
MULTILABEL_MODE = "multilabel"

__all__ = ["BINARY_MODE", "MULTICLASS_MODE", "MULTILABEL_MODE", "flatten_for_iou"]


def flatten_for_iou(
    y_pred: torch.Tensor,
    y_true: torch.Tensor,
    mode: str,
    ignore_index: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bring predictions/targets to [B, C, N] float form for soft IoU scores
    (the reference DiceLoss.forward's flatten/one-hot/masking, NCHW).

    * binary:     y_pred any shape, y_true same shape -> [B, 1, N]
    * multiclass: y_pred [B, C, *spatial], y_true [B, *spatial] int -> one-hot
    * multilabel: y_pred [B, C, *spatial], y_true same shape
    """
    bs = y_pred.shape[0]

    if mode == BINARY_MODE:
        y_pred = y_pred.reshape(bs, 1, -1)
        y_true = y_true.reshape(bs, 1, -1).to(y_pred.dtype)
        if ignore_index is not None:
            mask = (y_true != ignore_index).to(y_pred.dtype)
            y_pred = y_pred * mask
            y_true = y_true * mask
        return y_pred, y_true

    num_classes = y_pred.shape[1]

    if mode == MULTICLASS_MODE:
        y_pred = y_pred.reshape(bs, num_classes, -1)
        y_true = y_true.reshape(bs, -1).long()
        if ignore_index is not None:
            mask = y_true != ignore_index
            y_pred = y_pred * mask[:, None]
            y_true_oh = F.one_hot(torch.where(mask, y_true, 0), num_classes).to(y_pred.dtype)
            y_true_oh = y_true_oh * mask[..., None]
        else:
            y_true_oh = F.one_hot(y_true, num_classes).to(y_pred.dtype)
        return y_pred, y_true_oh.permute(0, 2, 1)

    if mode == MULTILABEL_MODE:
        y_pred = y_pred.reshape(bs, num_classes, -1)
        y_true = y_true.reshape(bs, num_classes, -1).to(y_pred.dtype)
        if ignore_index is not None:
            mask = (y_true != ignore_index).to(y_pred.dtype)
            y_pred = y_pred * mask
            y_true = y_true * mask
        return y_pred, y_true

    raise ValueError(f"Unsupported mode {mode}")
