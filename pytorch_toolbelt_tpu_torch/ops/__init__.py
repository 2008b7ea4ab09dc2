"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version."""

from .conv_kernels import conv3x3, conv3x3_reference, fold_batchnorm, pack_conv3x3_weights
from .tile_merge import detect_regular_grid, grid_merge, grid_merge_reference

__all__ = [
    "conv3x3",
    "conv3x3_reference",
    "detect_regular_grid",
    "fold_batchnorm",
    "grid_merge",
    "grid_merge_reference",
    "pack_conv3x3_weights",
]
