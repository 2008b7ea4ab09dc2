"""Lovasz hinge / Lovasz-Softmax losses (Berman 2018).

Counterpart of ``pytorch_toolbelt_tpu/losses/lovasz.py``, NCHW.  Every row
of errors -- one per class, per image with ``per_image=True`` -- is sorted in
one batched two-operand sort, ascending on ``-errors``, whose payload packs
(fg flag, position).  The backward applies the inverse permutation with a
scatter to the saved positions; the JAX package sorts a second time there,
because the TPU has no element-granular scatter.  On CUDA the sort runs the
hand-written K4 kernel
(:func:`~pytorch_toolbelt_tpu_torch.ops.bitonic_sort_chunked`, a radix sort),
or K5 (:func:`~pytorch_toolbelt_tpu_torch.ops.split_sort`) when
``SPLIT_SORT`` is set; on CPU it runs the plain ``torch.sort`` version.

Ignored pixels are pushed to the END of the descending error order with a
sentinel key and masked out of the cumulative sums, which gives the values
of the reference's boolean filtering with static shapes.  The permutation is
integer-valued, so gradients flow only through the gathered errors, as the
reference's detached ``perm``.  ``classes='present'`` computes every class
and masks the absent ones out of the average.
"""

from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..ops.sort import bitonic_sort_chunked, split_sort

__all__ = ["BinaryLovaszLoss", "LovaszLoss", "binary_lovasz_hinge", "lovasz_softmax"]

_SENTINEL = -1e30  # invalid pixels sort below any finite error
_FG_BIT = 30       # foreground flag packed above the 30-bit position field

# Route the sort through the K5 port (chunk sort, then merge) instead of
# the K4 port (radix sort).  Both are stable and give identical results.
SPLIT_SORT = False


def _sort2(keys: torch.Tensor, payload: torch.Tensor):
    """Ascending two-operand sort of each row of [R, P] ``keys``."""
    sort = split_sort if SPLIT_SORT else bitonic_sort_chunked
    return sort(keys.contiguous(), payload.contiguous())


def _lovasz_grad_terms(gt_sorted: torch.Tensor, valid_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovasz extension w.r.t. sorted errors (Alg. 1), along
    the last axis, with a validity mask folded into the cumulative sums."""
    gts = gt_sorted.sum(dim=-1, keepdim=True)
    intersection = gts - torch.cumsum(gt_sorted, dim=-1)
    union = gts + torch.cumsum((1.0 - gt_sorted) * valid_sorted, dim=-1)
    jaccard = torch.where(union > 0, 1.0 - intersection / union.clamp_min(1e-12), 0.0)
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]], dim=-1)


class _LovaszDot(torch.autograd.Function):
    """Per-row Lovasz dot product: sort errors descending, dot with the
    (detached) Lovasz-extension gradient.  [R, P] -> [R].  One sort, in the
    forward; the backward scatters the sorted-domain weights back to their
    pixels."""

    @staticmethod
    def forward(ctx, errors_masked, fg, hinge: bool):
        p = errors_masked.shape[-1]
        if p >= (1 << _FG_BIT):
            raise ValueError(f"Lovasz sort supports up to 2^{_FG_BIT} pixels per row, got {p}")
        iota = torch.arange(p, dtype=torch.int32, device=errors_masked.device).expand(errors_masked.shape)
        packed = torch.where(fg > 0.5, iota | (1 << _FG_BIT), iota)
        neg_sorted, packed_sorted = _sort2(-errors_masked, packed)
        errors_sorted = -neg_sorted
        fg_sorted = (packed_sorted >> _FG_BIT).to(errors_masked.dtype)
        perm = packed_sorted & ((1 << _FG_BIT) - 1)

        valid_sorted = (errors_sorted > _SENTINEL * 0.5).to(errors_masked.dtype)
        w = _lovasz_grad_terms(fg_sorted, valid_sorted)
        # w_eff folds validity (and the hinge's relu mask) into the sorted-domain
        # weights, so the backward is a pure permutation
        w_eff = w * valid_sorted
        if hinge:
            w_eff = w_eff * (errors_sorted > 0)
        e_act = torch.relu(errors_sorted) if hinge else errors_sorted
        row_loss = (torch.where(valid_sorted > 0, e_act, 0.0) * w).sum(dim=-1)
        ctx.save_for_backward(perm, w_eff)
        return row_loss

    @staticmethod
    def backward(ctx, ct):
        perm, w_eff = ctx.saved_tensors
        w_unsorted = torch.empty_like(w_eff).scatter_(-1, perm.long(), w_eff)  # the inverse permutation
        return ct[..., None] * w_unsorted, None, None


def _hinge_rows(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    labels = torch.where(valid, labels, 0).float()
    errors = 1.0 - logits * (2.0 * labels - 1.0)
    errors_masked = torch.where(valid, errors, _SENTINEL)
    return _LovaszDot.apply(errors_masked, labels, True)


def binary_lovasz_hinge(
    logits: torch.Tensor,
    labels: torch.Tensor,
    per_image: bool = False,
    ignore_index: Optional[Union[int, float]] = None,
) -> torch.Tensor:
    """Binary Lovasz hinge loss on logits.

    Args:
        logits: [B, *spatial] float logits ([B, 1, H, W] works too).
        labels: binary ground truth (0 or 1, plus ignore_index) of the same size.
    """
    bs = logits.shape[0]
    logits = logits.reshape(bs, -1).float()
    labels = labels.reshape(bs, -1)
    valid = torch.ones_like(labels, dtype=torch.bool) if ignore_index is None else labels != ignore_index
    if per_image:
        return _hinge_rows(logits, labels, valid).mean()
    return _hinge_rows(logits.reshape(1, -1), labels.reshape(1, -1), valid.reshape(1, -1))[0]


def lovasz_softmax(
    probas: torch.Tensor,
    labels: torch.Tensor,
    classes: Union[str, Sequence[int]] = "present",
    per_image: bool = False,
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    """Multi-class Lovasz-Softmax loss.

    Args:
        probas: [B, C, *spatial] class probabilities (NCHW), or [B, *spatial]
            sigmoid output taken as C = 1.
        labels: [B, *spatial] integer ground truth.
        classes: 'all' | 'present' | explicit list of class ids to average.
    """
    if probas.dim() == labels.dim():
        probas = probas.unsqueeze(1)  # sigmoid output -> C = 1
    bs, num_classes = probas.shape[:2]
    if classes in ("all", "present"):
        class_list = list(range(num_classes))
    else:
        class_list = [int(c) for c in classes]
        if num_classes == 1 and len(class_list) > 1:
            raise ValueError("Sigmoid output possible only with 1 class")

    probas = probas.reshape(bs, num_classes, -1).float()  # [B, C, P]
    labels = labels.reshape(bs, 1, -1)
    valid = torch.ones_like(labels, dtype=torch.bool) if ignore_index is None else labels != ignore_index
    class_ids = torch.tensor(class_list, dtype=labels.dtype, device=labels.device)[:, None]  # [K, 1]
    if num_classes == 1:
        class_pred = probas.expand(bs, len(class_list), probas.shape[-1])
    elif class_list != list(range(num_classes)):
        class_pred = probas[:, class_list]
    else:
        class_pred = probas
    if not per_image:
        # one [K, B*P] problem, pixels batch-major as in the JAX package
        class_pred = class_pred.transpose(0, 1).reshape(1, len(class_list), -1)
        labels, valid = labels.reshape(1, 1, -1), valid.reshape(1, 1, -1)
    k = len(class_list)

    fg = ((labels == class_ids) & valid).float()  # [B', K, P]
    errors = (fg - class_pred).abs()
    errors_masked = torch.where(valid, errors, _SENTINEL)  # sorts last
    losses = _LovaszDot.apply(errors_masked.reshape(-1, errors.shape[-1]), fg.reshape(-1, fg.shape[-1]), False)
    losses = losses.reshape(-1, k)  # [B', K]
    if classes == "present":
        present = (fg.sum(dim=-1) > 0).float()
        per_row = (losses * present).sum(dim=-1) / present.sum(dim=-1).clamp_min(1.0)
    else:
        per_row = losses.mean(dim=-1)
    return per_row.mean()


class BinaryLovaszLoss(nn.Module):
    def __init__(self, per_image: bool = False, ignore_index: Optional[Union[int, float]] = None):
        super().__init__()
        self.per_image = per_image
        self.ignore_index = ignore_index

    def forward(self, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return binary_lovasz_hinge(logits, target, per_image=self.per_image, ignore_index=self.ignore_index)


class LovaszLoss(nn.Module):
    def __init__(self, per_image: bool = False, ignore: Optional[int] = None,
                 classes: Union[str, Sequence[int]] = "present"):
        super().__init__()
        self.per_image = per_image
        self.ignore = ignore
        self.classes = classes

    def forward(self, probas: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return lovasz_softmax(probas, target, classes=self.classes, per_image=self.per_image,
                              ignore_index=self.ignore)
