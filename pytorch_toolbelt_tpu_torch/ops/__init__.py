"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version."""

from .conv_kernels import conv3x3, conv3x3_reference, fold_batchnorm, pack_conv3x3_weights
from .quantized import QConvWeight, pack_qconv2d_weights, q_add, q_add_reference, q_upsample, q_upsample_cat
from .quantized import q_upsample_cat_reference
from .quantized import q_upsample_reference, qconv2d, qconv2d_reference, upsample_taps
from .sort import bitonic_sort_chunked, sort_reference, split_sort
from .tile_merge import accumulate_tiles, accumulate_tiles_reference, detect_regular_grid, grid_merge
from .tile_merge import grid_merge_reference

__all__ = [
    "QConvWeight",
    "accumulate_tiles",
    "accumulate_tiles_reference",
    "bitonic_sort_chunked",
    "conv3x3",
    "conv3x3_reference",
    "detect_regular_grid",
    "fold_batchnorm",
    "grid_merge",
    "grid_merge_reference",
    "pack_conv3x3_weights",
    "pack_qconv2d_weights",
    "q_add",
    "q_add_reference",
    "q_upsample",
    "q_upsample_cat",
    "q_upsample_cat_reference",
    "q_upsample_reference",
    "qconv2d",
    "qconv2d_reference",
    "sort_reference",
    "split_sort",
    "upsample_taps",
]
