"""Loss functionals (counterpart of ``pytorch_toolbelt_tpu/losses/functional.py``).

The class axis is 1 (NCHW), as in pytorch-toolbelt; the JAX package keeps
it last, and the parity tests transpose.  Every loss computes in float32
whatever the input dtype, and ``ignore_index`` is handled by masking.
"""

import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F

__all__ = [
    "binary_cross_entropy_with_logits",
    "focal_loss_with_logits",
    "softmax_focal_loss_with_logits",
    "soft_jaccard_score",
    "soft_dice_score",
    "wing_loss",
    "label_smoothed_nll_loss",
    "log_cosh_loss",
    "balanced_binary_cross_entropy_with_logits",
    "soft_micro_f1",
    "reduce_loss",
]

Reduction = Optional[Union[str, Callable]]


def reduce_loss(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    """Apply 'none' | 'mean' | 'sum' | 'batchwise_mean' reduction."""
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "batchwise_mean":
        return loss.sum(dim=0)
    return loss


def binary_cross_entropy_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise BCE on logits (no reduction):
    softplus(x) - x * t.  Its gradient is sigmoid(x) - t everywhere; the
    max/log1p-exp form's autograd gradient is wrong at x == 0 exactly."""
    return F.softplus(logits) - logits * targets


def _class_weights_view(class_weights, ndim: int, axis: int, like: torch.Tensor) -> torch.Tensor:
    shape = [1] * ndim
    shape[axis % ndim] = -1
    return torch.as_tensor(class_weights, dtype=like.dtype, device=like.device).reshape(shape)


def focal_loss_with_logits(
    output: torch.Tensor,
    target: torch.Tensor,
    gamma: float = 2.0,
    alpha: Optional[float] = 0.25,
    reduction: str = "mean",
    normalized: bool = False,
    reduced_threshold: Optional[float] = None,
    eps: float = 1e-6,
    ignore_index: Optional[int] = None,
    activation: str = "sigmoid",
    softmax_axis: Optional[int] = None,
    class_weights: Optional[Sequence[float]] = None,
    class_axis: int = 1,
) -> torch.Tensor:
    """Binary focal loss on logits: normalized focal loss (arXiv:1909.07829),
    reduced focal loss (arXiv:1903.01347), alpha balancing, per-class weights
    along ``class_axis`` and ``ignore_index``.  ``target`` has ``output``'s
    shape.  ``softmax_axis=None`` with ``activation='softmax'`` normalises
    over all elements, as ``jax.nn.softmax(axis=None)`` does."""
    output = output.float()
    target_f = target.float()

    if activation == "sigmoid":
        p = torch.sigmoid(output)
    elif softmax_axis is None:
        p = torch.softmax(output.reshape(-1), 0).reshape(output.shape)
    else:
        p = torch.softmax(output, dim=softmax_axis)

    ce_loss = binary_cross_entropy_with_logits(output, target_f)
    pt = p * target_f + (1 - p) * (1 - target_f)

    if reduced_threshold is None:
        focal_term = torch.pow(1.0 - pt, gamma)
    else:
        focal_term = torch.pow((1.0 - pt) / (1 - reduced_threshold), gamma)
        focal_term = torch.where(pt < reduced_threshold, torch.ones_like(focal_term), focal_term)

    loss = focal_term * ce_loss

    if alpha is not None:
        loss = loss * (alpha * target_f + (1 - alpha) * (1 - target_f))

    if class_weights is not None:
        loss = loss * _class_weights_view(class_weights, loss.ndim, class_axis, loss)

    if ignore_index is not None:
        ignore_mask = target == ignore_index
        loss = loss.masked_fill(ignore_mask, 0.0)
        if normalized:
            focal_term = focal_term.masked_fill(ignore_mask, 0.0)

    if normalized:
        loss = loss / focal_term.sum().clamp_min(eps)

    return reduce_loss(loss, reduction)


def softmax_focal_loss_with_logits(
    output: torch.Tensor,
    target: torch.Tensor,
    class_weights: Optional[Sequence[float]] = None,
    gamma: float = 2.0,
    reduction: str = "mean",
    normalized: bool = False,
    reduced_threshold: Optional[float] = None,
    eps: float = 1e-6,
    ignore_index: int = -100,
) -> torch.Tensor:
    """Softmax (multiclass) focal loss.  ``output`` [B, C, *spatial] logits,
    ``target`` [B, *spatial] integer labels."""
    from . import fused

    if fused.ENABLED and not normalized and reduced_threshold is None and reduction in ("mean", "sum"):
        # analytic-gradient path: same value and gradient, no autograd graph
        cw = None if class_weights is None else tuple(float(w) for w in torch.as_tensor(class_weights).reshape(-1))
        return fused.fused_softmax_focal(output, target, float(gamma), cw, int(ignore_index), reduction)
    output = output.float()
    num_classes = output.shape[1]

    ignore_mask = target == ignore_index
    targets_oh = F.one_hot(torch.where(ignore_mask, 0, target).long(), num_classes).movedim(-1, 1).float()

    probs = torch.softmax(output, dim=1)
    # pt = probability of the WRONG assignment
    pt = (1 - targets_oh) * probs + targets_oh * (1 - probs)

    loss = binary_cross_entropy_with_logits(output, targets_oh)

    if reduced_threshold is None:
        focal_term = torch.pow(pt, gamma)
    else:
        focal_term = torch.pow(pt / reduced_threshold, gamma)
        focal_term = torch.where(pt < reduced_threshold, torch.ones_like(focal_term), focal_term)

    loss = focal_term * loss
    if class_weights is not None:
        loss = loss * _class_weights_view(class_weights, loss.ndim, 1, loss)

    loss = loss.sum(dim=1) * (~ignore_mask)

    if normalized:
        loss = loss / focal_term.sum().clamp_min(eps)

    return reduce_loss(loss, reduction)


def soft_jaccard_score(
    output: torch.Tensor,
    target: torch.Tensor,
    smooth: float = 0.0,
    eps: float = 1e-7,
    dims=None,
) -> torch.Tensor:
    """Soft IoU score."""
    if output.shape != target.shape:
        raise ValueError(f"output and target shapes differ: {tuple(output.shape)} vs {tuple(target.shape)}")
    if dims is not None:
        intersection = torch.sum(output * target, dim=dims)
        cardinality = torch.sum(output + target, dim=dims)
    else:
        intersection = torch.sum(output * target)
        cardinality = torch.sum(output + target)
    union = cardinality - intersection
    return (intersection + smooth) / (union + smooth).clamp_min(eps)


def soft_dice_score(
    output: torch.Tensor,
    target: torch.Tensor,
    smooth: float = 0.0,
    eps: float = 1e-7,
    dims=None,
) -> torch.Tensor:
    """Soft Dice score."""
    if output.shape != target.shape:
        raise ValueError(f"output and target shapes differ: {tuple(output.shape)} vs {tuple(target.shape)}")
    if dims is not None:
        intersection = torch.sum(output * target, dim=dims)
        cardinality = torch.sum(output + target, dim=dims)
    else:
        intersection = torch.sum(output * target)
        cardinality = torch.sum(output + target)
    return (2.0 * intersection + smooth) / (cardinality + smooth).clamp_min(eps)


def wing_loss(
    output: torch.Tensor,
    target: torch.Tensor,
    width: float = 5,
    curvature: float = 0.5,
    reduction: str = "mean",
) -> torch.Tensor:
    """Wing loss for landmark regression (arXiv:1711.06753)."""
    diff_abs = (target - output).abs()
    c = width - width * math.log(1 + width / curvature)
    loss = torch.where(diff_abs < width, width * torch.log1p(diff_abs / curvature), diff_abs - c)
    return reduce_loss(loss, reduction)


def label_smoothed_nll_loss(
    lprobs: torch.Tensor,
    target: torch.Tensor,
    epsilon: float,
    ignore_index: Optional[int] = None,
    reduction: str = "mean",
    axis: int = -1,
) -> torch.Tensor:
    """Label-smoothed NLL on log-probabilities with the class dimension at
    ``axis``; ``target`` has ``lprobs``' shape without that axis."""
    num_classes = lprobs.shape[axis]
    lprobs = lprobs.movedim(axis, -1)
    target = target.long()

    if ignore_index is not None:
        pad_mask = target == ignore_index
        target_masked = torch.where(pad_mask, 0, target)
        nll_loss = -lprobs.gather(-1, target_masked[..., None]).squeeze(-1)
        smooth_loss = -lprobs.sum(dim=-1)
        nll_loss = nll_loss.masked_fill(pad_mask, 0.0)
        smooth_loss = smooth_loss.masked_fill(pad_mask, 0.0)
    else:
        nll_loss = -lprobs.gather(-1, target[..., None]).squeeze(-1)
        smooth_loss = -lprobs.sum(dim=-1)

    if reduction == "sum":
        nll_loss = nll_loss.sum()
        smooth_loss = smooth_loss.sum()
    if reduction == "mean":
        nll_loss = nll_loss.mean()
        smooth_loss = smooth_loss.mean()

    eps_i = epsilon / num_classes
    return (1.0 - epsilon) * nll_loss + eps_i * smooth_loss


def log_cosh_loss(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """Numerically stable mean log-cosh."""
    x = y_pred - y_true
    return torch.mean(x + F.softplus(-2.0 * x) - math.log(2.0))


def balanced_binary_cross_entropy_with_logits(
    logits: torch.Tensor,
    targets: torch.Tensor,
    gamma: float = 1.0,
    ignore_index: Optional[int] = None,
    reduction: str = "mean",
) -> torch.Tensor:
    """Balanced BCE (arXiv:1504.06375 formula 2): pos/neg weights from the
    batch's label statistics raised to ``gamma``."""
    pos_targets = torch.sum(targets == 1)
    neg_targets = torch.sum(targets == 0)
    num_targets = pos_targets + neg_targets
    pos_weight = torch.pow(neg_targets / (num_targets + 1e-7), gamma)
    neg_weight = 1.0 - pos_weight

    pos_term = torch.pow(pos_weight, gamma) * targets * F.logsigmoid(logits)
    neg_term = torch.pow(neg_weight, gamma) * (1 - targets) * F.logsigmoid(-logits)
    loss = -(pos_term + neg_term)

    if ignore_index is not None:
        loss = loss.masked_fill(targets == ignore_index, 0.0)

    return reduce_loss(loss, reduction)


def soft_micro_f1(preds: torch.Tensor, targets: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Mean (1 - soft-F1) over classes; probabilities in, scalar out.
    Shapes: [num_samples, num_classes]."""
    tp = torch.sum(preds * targets, dim=0)
    fp = torch.sum(preds * (1 - targets), dim=0)
    fn = torch.sum((1 - preds) * targets, dim=0)
    soft_f1 = 2 * tp / (2 * tp + fn + fp + eps)
    return (1 - soft_f1).mean()
