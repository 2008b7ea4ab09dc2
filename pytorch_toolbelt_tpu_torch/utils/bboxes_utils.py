"""Detection box matching metrics (counterpart of
``pytorch_toolbelt_tpu/utils/bboxes_utils.py``, whose host code it copies;
parity target: pytorch_toolbelt/utils/bboxes_utils.py:31-290) — pure numpy
(+scipy for Hungarian), no torch dependency."""

from collections import namedtuple
from typing import Optional

import numpy as np

__all__ = ["box_iou", "match_bboxes", "match_bboxes_hungarian", "BBoxesMatchResult"]

BBoxesMatchResult = namedtuple(
    "BBoxesMatchResult",
    [
        "true_positives",  # [num_classes]
        "false_positives",  # [num_classes]
        "false_negatives",  # [num_classes]
        # [num_classes+1, num_classes+1], last class = "no detection";
        # notation confusion_matrix[gt, pred]
        "confusion_matrix",
        # [K, 2] (pred_index, true_index) pairs of true positives
        "true_positive_indexes",
    ],
)


def box_iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xyxy boxes: [N, 4] x [M, 4] -> [N, M]."""
    area1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    area2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    lt = np.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = np.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _empty_result(num_classes):
    return (
        np.zeros(num_classes, dtype=int),
        np.zeros(num_classes, dtype=int),
        np.zeros(num_classes, dtype=int),
        np.zeros((num_classes + 1, num_classes + 1), dtype=int),
    )


def _degenerate_cases(pred_labels, true_labels, num_classes):
    """Handle empty pred/true sets; returns a result or None."""
    tp, fp, fn, cm = _empty_result(num_classes)
    none_class = num_classes
    if len(pred_labels) == 0 and len(true_labels) == 0:
        pass
    elif len(pred_labels) == 0:
        for true_class in true_labels:
            fn[true_class] += 1
            cm[true_class, none_class] += 1
    elif len(true_labels) == 0:
        for pred_class in pred_labels:
            fp[pred_class] += 1
            cm[none_class, pred_class] += 1
    else:
        return None
    return BBoxesMatchResult(tp, fp, fn, cm, np.zeros((0, 2), dtype=int))


def match_bboxes(
    pred_boxes: np.ndarray,
    pred_labels: np.ndarray,
    pred_scores: np.ndarray,
    true_boxes: np.ndarray,
    true_labels: np.ndarray,
    num_classes: int,
    iou_threshold: float = 0.5,
) -> BBoxesMatchResult:
    """Greedy confidence-ordered matching: most confident prediction wins
    each ground-truth box; class mismatch on a matched pair counts 1 FP +
    1 FN (reference bboxes_utils.py:31-168)."""
    if len(pred_labels) != len(pred_boxes) or len(pred_labels) != len(pred_scores):
        raise ValueError(
            f"Inconsistent lengths of predicted bboxes:{len(pred_boxes)} labels:{len(pred_labels)} "
            f"and their scores: {len(pred_scores)}"
        )
    if len(true_boxes) != len(true_labels):
        raise ValueError(
            f"Inconsistent lengths of ground-truth bboxes:{len(true_boxes)} and their labels:{len(true_labels)}"
        )

    degenerate = _degenerate_cases(pred_labels, true_labels, num_classes)
    if degenerate is not None:
        return degenerate

    tp, fp, fn, cm = _empty_result(num_classes)
    none_class = num_classes

    order = np.argsort(-pred_scores)
    rorder = np.argsort(order)
    pred_boxes = pred_boxes[order]
    pred_labels_sorted = pred_labels[order]

    iou_matrix = box_iou(pred_boxes.astype(np.float64), true_boxes.astype(np.float64))

    remaining_preds = np.ones(len(pred_boxes), dtype=bool)
    remaining_trues = np.ones(len(true_boxes), dtype=bool)
    tp_indexes = []

    for ci in range(len(true_boxes)):
        candidates = np.flatnonzero(iou_matrix[:, ci] >= iou_threshold)
        if len(candidates):
            ri = candidates[0]
            iou_matrix[ri, :] = 0
            remaining_preds[ri] = False
            remaining_trues[ci] = False
            pred_class = pred_labels_sorted[ri]
            true_class = true_labels[ci]
            if pred_class == true_class:
                tp[true_class] += 1
                tp_indexes.append((rorder[ri], ci))
            else:
                fp[pred_class] += 1
                fn[true_class] += 1
            cm[true_class, pred_class] += 1

    for pred_class in pred_labels_sorted[remaining_preds]:
        fp[pred_class] += 1
        cm[none_class, pred_class] += 1
    for true_class in true_labels[remaining_trues]:
        fn[true_class] += 1
        cm[true_class, none_class] += 1

    return BBoxesMatchResult(tp, fp, fn, cm, np.array(tp_indexes, dtype=int).reshape(-1, 2))


def match_bboxes_hungarian(
    pred_boxes: np.ndarray,
    pred_labels: np.ndarray,
    true_boxes: np.ndarray,
    true_labels: np.ndarray,
    num_classes: int,
    iou_threshold: float = 0.5,
) -> BBoxesMatchResult:
    """Optimal assignment matching via scipy linear_sum_assignment
    (reference bboxes_utils.py:171-290)."""
    from scipy.optimize import linear_sum_assignment

    if len(pred_labels) != len(pred_boxes):
        raise ValueError(
            f"Inconsistent lengths of predicted bboxes:{len(pred_boxes)} labels:{len(pred_labels)}"
        )
    if len(true_boxes) != len(true_labels):
        raise ValueError(
            f"Inconsistent lengths of ground-truth bboxes:{len(true_boxes)} and their labels:{len(true_labels)}"
        )

    degenerate = _degenerate_cases(pred_labels, true_labels, num_classes)
    if degenerate is not None:
        return degenerate

    tp, fp, fn, cm = _empty_result(num_classes)
    none_class = num_classes

    iou_matrix = box_iou(pred_boxes.astype(np.float64), true_boxes.astype(np.float64))
    row_ind, col_ind = linear_sum_assignment(iou_matrix, maximize=True)

    remaining_preds = np.ones(len(pred_boxes), dtype=bool)
    remaining_trues = np.ones(len(true_boxes), dtype=bool)
    tp_indexes = []

    for ri, ci in zip(row_ind, col_ind):
        pred_class = pred_labels[ri]
        true_class = true_labels[ci]
        if iou_matrix[ri, ci] >= iou_threshold:
            remaining_preds[ri] = False
            remaining_trues[ci] = False
            if pred_class == true_class:
                tp[true_class] += 1
                tp_indexes.append((ri, ci))
            else:
                fp[pred_class] += 1
                fn[true_class] += 1
            cm[true_class, pred_class] += 1

    for pred_class in pred_labels[remaining_preds]:
        fp[pred_class] += 1
        cm[none_class, pred_class] += 1
    for true_class in true_labels[remaining_trues]:
        fn[true_class] += 1
        cm[true_class, none_class] += 1

    return BBoxesMatchResult(tp, fp, fn, cm, np.array(tp_indexes, dtype=int).reshape(-1, 2))
