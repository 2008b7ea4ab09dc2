"""Segmentation and classification losses (counterpart of ``pytorch_toolbelt_tpu.losses``), NCHW."""

from ._modes import BINARY_MODE, MULTICLASS_MODE, MULTILABEL_MODE
from .bitempered import (
    BinaryBiTemperedLogisticLoss,
    BiTemperedLogisticLoss,
    bi_tempered_logistic_loss,
    exp_t,
    log_t,
    tempered_softmax,
)
from .dice import DiceLoss
from .focal import BinaryFocalLoss, CrossEntropyFocalLoss, FocalLoss
from .functional import (
    balanced_binary_cross_entropy_with_logits,
    binary_cross_entropy_with_logits,
    focal_loss_with_logits,
    label_smoothed_nll_loss,
    log_cosh_loss,
    soft_dice_score,
    soft_jaccard_score,
    soft_micro_f1,
    softmax_focal_loss_with_logits,
    wing_loss,
)
from .jaccard import JaccardLoss
from .joint import JointLoss, WeightedLoss, sum_of_losses
from .lovasz import BinaryLovaszLoss, LovaszLoss, binary_lovasz_hinge, lovasz_softmax
from .simple_losses import (
    BalancedBCEWithLogitsLoss,
    BinarySoftF1Loss,
    FocalCosineLoss,
    LogCoshLoss,
    QualityFocalLoss,
    SoftBCEWithLogitsLoss,
    SoftCrossEntropyLoss,
    SoftF1Loss,
    WingLoss,
)

__all__ = [
    "BINARY_MODE",
    "MULTICLASS_MODE",
    "MULTILABEL_MODE",
    "BalancedBCEWithLogitsLoss",
    "BinaryBiTemperedLogisticLoss",
    "BinaryFocalLoss",
    "BinaryLovaszLoss",
    "BinarySoftF1Loss",
    "BiTemperedLogisticLoss",
    "CrossEntropyFocalLoss",
    "DiceLoss",
    "FocalCosineLoss",
    "FocalLoss",
    "JaccardLoss",
    "JointLoss",
    "LogCoshLoss",
    "LovaszLoss",
    "QualityFocalLoss",
    "SoftBCEWithLogitsLoss",
    "SoftCrossEntropyLoss",
    "SoftF1Loss",
    "WeightedLoss",
    "WingLoss",
    "balanced_binary_cross_entropy_with_logits",
    "bi_tempered_logistic_loss",
    "binary_cross_entropy_with_logits",
    "binary_lovasz_hinge",
    "exp_t",
    "focal_loss_with_logits",
    "label_smoothed_nll_loss",
    "log_cosh_loss",
    "log_t",
    "lovasz_softmax",
    "soft_dice_score",
    "soft_jaccard_score",
    "soft_micro_f1",
    "softmax_focal_loss_with_logits",
    "sum_of_losses",
    "tempered_softmax",
    "wing_loss",
]
