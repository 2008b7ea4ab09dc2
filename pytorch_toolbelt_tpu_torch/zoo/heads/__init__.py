from .classification import (
    FullyConnectedClassificationHead,
    GeneralizedMeanPoolingClassificationHead,
    GenericPoolingClassificationHead,
    GlobalAveragePoolingClassificationHead,
    GlobalMaxAvgPoolingClassificationHead,
    GlobalMaxAvgSumPoolingClassificationHead,
    GlobalMaxPoolingClassificationHead,
)
from .deep_supervision import DeepSupervisionHead
from .hypercolumn import HypercolumnHead
from .progressive_shuffle import ProgressiveShuffleHead
from .resize import ResizeHead
from .segformer import SegFormerHead

__all__ = [
    "DeepSupervisionHead",
    "FullyConnectedClassificationHead",
    "GeneralizedMeanPoolingClassificationHead",
    "GenericPoolingClassificationHead",
    "GlobalAveragePoolingClassificationHead",
    "GlobalMaxAvgPoolingClassificationHead",
    "GlobalMaxAvgSumPoolingClassificationHead",
    "GlobalMaxPoolingClassificationHead",
    "HypercolumnHead",
    "ProgressiveShuffleHead",
    "ResizeHead",
    "SegFormerHead",
]
