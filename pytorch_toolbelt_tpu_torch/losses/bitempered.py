"""Bi-Tempered logistic loss (arXiv:1906.03361).

Counterpart of ``pytorch_toolbelt_tpu/losses/bitempered.py``.  The
normalisation constant of the tempered softmax is found iteratively (fixed
point for t > 1, binary search for t < 1).  Both backward passes are
analytic, as in the JAX package's two custom VJPs: the escort-distribution
gradient of the normalisation, and the whole loss's gradient from the
activations, the labels and the per-row constants.

Layouts follow pytorch-toolbelt: :func:`bi_tempered_logistic_loss` and
:class:`BiTemperedLogisticLoss` take classes LAST ([..., num_classes]);
:class:`BinaryBiTemperedLogisticLoss` takes [B, 1, *spatial].

The JAX backward evaluates ``p ** (t2 - t1)`` at ``p == 0``, which is inf
when t2 < t1 and turns the gradient of a class with a zero label into NaN.
That term only ever stands multiplied by the label, so the port drops it
where the label is 0 and the gradient stays finite.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "log_t",
    "exp_t",
    "tempered_softmax",
    "bi_tempered_logistic_loss",
    "BiTemperedLogisticLoss",
    "BinaryBiTemperedLogisticLoss",
]


def log_t(u: torch.Tensor, t: float) -> torch.Tensor:
    if t == 1.0:
        return torch.log(u)
    return (torch.pow(u, 1.0 - t) - 1.0) / (1.0 - t)


def exp_t(u: torch.Tensor, t: float) -> torch.Tensor:
    if t == 1.0:
        return torch.exp(u)
    return torch.pow(torch.relu(1.0 + (1.0 - t) * u), 1.0 / (1.0 - t))


def _normalization_fixed_point(activations: torch.Tensor, t: float, num_iters: int) -> torch.Tensor:
    """Fixed-point iteration for t > 1."""
    mu = activations.amax(dim=-1, keepdim=True)
    normalized0 = activations - mu
    normalized = normalized0
    for _ in range(num_iters):
        logt_partition = exp_t(normalized, t).sum(dim=-1, keepdim=True)
        normalized = normalized0 * torch.pow(logt_partition, 1.0 - t)
    logt_partition = exp_t(normalized, t).sum(dim=-1, keepdim=True)
    return -log_t(1.0 / logt_partition, t) + mu


def _normalization_binary_search(activations: torch.Tensor, t: float, num_iters: int) -> torch.Tensor:
    """Binary search for t < 1."""
    mu = activations.amax(dim=-1, keepdim=True)
    normalized = activations - mu
    effective_dim = (normalized > -1.0 / (1.0 - t)).sum(dim=-1, keepdim=True).to(activations.dtype)
    lower = torch.zeros_like(mu)
    upper = -log_t(1.0 / effective_dim, t) * torch.ones_like(lower)
    for _ in range(num_iters):
        logt_partition = (upper + lower) / 2.0
        sum_probs = exp_t(normalized - logt_partition, t).sum(dim=-1, keepdim=True)
        update = (sum_probs < 1.0).to(activations.dtype)
        lower, upper = (
            lower * update + (1.0 - update) * logt_partition,
            upper * (1.0 - update) + update * logt_partition,
        )
    return (upper + lower) / 2.0 + mu


def _normalization(activations: torch.Tensor, t: float, num_iters: int) -> torch.Tensor:
    if t < 1.0:
        return _normalization_binary_search(activations, t, num_iters)
    return _normalization_fixed_point(activations, t, num_iters)


class _ComputeNormalization(torch.autograd.Function):
    @staticmethod
    def forward(ctx, activations, t: float, num_iters: int):
        constants = _normalization(activations, t, num_iters)
        ctx.save_for_backward(activations, constants)
        ctx.t = t
        return constants

    @staticmethod
    def backward(ctx, grad_output):
        activations, constants = ctx.saved_tensors
        escorts = torch.pow(exp_t(activations - constants, ctx.t), ctx.t)
        escorts = escorts / escorts.sum(dim=-1, keepdim=True)
        return escorts * grad_output, None, None


def compute_normalization(activations: torch.Tensor, t: float, num_iters: int = 5) -> torch.Tensor:
    return _ComputeNormalization.apply(activations, t, num_iters)


def tempered_softmax(activations: torch.Tensor, t: float, num_iters: int = 5) -> torch.Tensor:
    if t == 1.0:
        return torch.softmax(activations, dim=-1)
    return exp_t(activations - compute_normalization(activations, t, num_iters), t)


def _loss_rows(labels_onehot, probabilities, t1):
    loss_values = (
        labels_onehot * log_t(labels_onehot + 1e-10, t1)
        - labels_onehot * log_t(probabilities, t1)
        - torch.pow(labels_onehot, 2.0 - t1) / (2.0 - t1)
        + torch.pow(probabilities, 2.0 - t1) / (2.0 - t1)
    )
    return loss_values.sum(dim=-1)


class _BiTemperedRows(torch.autograd.Function):
    """Per-row bi-tempered loss with a hand-derived backward:

        dL/da_i = u_i - e_i * S,   u_j = p_j^{1-t1+t2} - y_j p_j^{t2-t1},
        e_i = p_i^{t2} / sum_k p_k^{t2}  (the escort distribution),  S = sum_j u_j

    and, for the labels, dL/dy = log_t1(y+eps) + y (y+eps)^-t1 - log_t1(p) - y^(1-t1).
    """

    @staticmethod
    def forward(ctx, activations, labels_onehot, t1: float, t2: float, num_iters: int):
        if t2 == 1.0:
            constants = torch.logsumexp(activations, dim=-1, keepdim=True)
        else:
            constants = _normalization(activations, t2, num_iters)
        ctx.save_for_backward(activations, labels_onehot, constants)
        ctx.temps = (t1, t2)
        return _loss_rows(labels_onehot, exp_t(activations - constants, t2), t1)

    @staticmethod
    def backward(ctx, grad_rows):
        activations, labels_onehot, constants = ctx.saved_tensors
        t1, t2 = ctx.temps
        p = exp_t(activations - constants, t2)
        # y * p^(t2 - t1): zero where y == 0, even where p == 0 and t2 < t1
        label_term = torch.where(labels_onehot != 0, labels_onehot * torch.pow(p, t2 - t1), 0.0)
        u = torch.pow(p, 1.0 - t1 + t2) - label_term
        pt2 = torch.pow(p, t2)
        escorts = pt2 / pt2.sum(dim=-1, keepdim=True)
        grad = u - escorts * u.sum(dim=-1, keepdim=True)
        grad_labels = None
        if ctx.needs_input_grad[1]:
            ye = labels_onehot + 1e-10
            grad_labels = grad_rows[..., None] * (
                log_t(ye, t1) + labels_onehot * torch.pow(ye, -t1) - log_t(p, t1) - torch.pow(labels_onehot, 1.0 - t1)
            )
        return grad_rows[..., None] * grad, grad_labels, None, None, None


def bi_tempered_logistic_loss(
    activations: torch.Tensor,
    labels: torch.Tensor,
    t1: float,
    t2: float,
    label_smoothing: float = 0.0,
    num_iters: int = 5,
    reduction: str = "mean",
) -> torch.Tensor:
    """Bi-Tempered logistic loss.

    Args:
        activations: [..., num_classes] logits.
        labels: either one-hot of activations' shape, or integer labels with
            one dimension fewer.
    """
    if labels.dim() < activations.dim():
        labels_onehot = F.one_hot(labels.long(), activations.shape[-1]).to(activations.dtype)
    else:
        labels_onehot = labels.to(activations.dtype)

    if label_smoothing > 0:
        num_classes = labels_onehot.shape[-1]
        labels_onehot = (
            1 - label_smoothing * num_classes / (num_classes - 1)
        ) * labels_onehot + label_smoothing / (num_classes - 1)

    loss_values = _BiTemperedRows.apply(activations, labels_onehot, t1, t2, num_iters)

    if reduction == "sum":
        return loss_values.sum()
    if reduction == "mean":
        return loss_values.mean()
    return loss_values


class BiTemperedLogisticLoss(nn.Module):
    """Classes last: predictions [..., C], targets [...] int. ``ignore_index`` masks by target."""

    def __init__(self, t1: float, t2: float, smoothing: float = 0.0, ignore_index: Optional[int] = None,
                 reduction: str = "mean"):
        super().__init__()
        self.t1 = t1
        self.t2 = t2
        self.smoothing = smoothing
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, predictions: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        labels = targets
        if self.ignore_index is not None:
            labels = torch.where(targets == self.ignore_index, 0, targets)
        loss = bi_tempered_logistic_loss(
            predictions, labels, t1=self.t1, t2=self.t2, label_smoothing=self.smoothing, reduction="none"
        )
        if self.ignore_index is not None:
            loss = loss * (targets != self.ignore_index)
        if self.reduction == "mean":
            return loss.mean()
        if self.reduction == "sum":
            return loss.sum()
        return loss


class BinaryBiTemperedLogisticLoss(nn.Module):
    """Binary variant: predictions and targets [B, 1, *spatial]."""

    def __init__(self, t1: float, t2: float, smoothing: float = 0.0, ignore_index: Optional[int] = None,
                 reduction: str = "mean"):
        super().__init__()
        self.t1 = t1
        self.t2 = t2
        self.smoothing = smoothing
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, predictions: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        if predictions.shape[1] != 1 or targets.shape[1] != 1:
            raise ValueError("Channel dimension for predictions and targets must be equal to 1")
        loss = bi_tempered_logistic_loss(
            torch.cat([-predictions, predictions], dim=1).movedim(1, -1),
            torch.cat([1 - targets, targets], dim=1).movedim(1, -1),
            t1=self.t1,
            t2=self.t2,
            label_smoothing=self.smoothing,
            reduction="none",
        ).unsqueeze(1)
        if self.ignore_index is not None:
            loss = loss.masked_fill(targets == self.ignore_index, 0.0)
        if self.reduction == "mean":
            return loss.mean()
        if self.reduction == "sum":
            return loss.sum()
        return loss
