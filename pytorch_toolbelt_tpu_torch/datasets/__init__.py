from .common import *  # noqa: F401,F403
from .collate import default_collate, get_collate_for_dataset
from .mean_std import DatasetMeanStdCalculator
from .prefetch import prefetch_to_device
from .segmentation import (
    block_reduce_dominant_label,
    compute_weight_mask,
    mask_to_bce_target,
    mask_to_ce_target,
    read_binary_mask,
)
from .wrappers import RandomSubsetDataset, RandomSubsetWithMaskDataset
