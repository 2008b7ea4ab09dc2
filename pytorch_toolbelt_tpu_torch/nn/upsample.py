"""Upsample layers (counterpart of ``pytorch_toolbelt_tpu/nn/upsample.py``).

Only the bilinear layer is ported; the factory raises for the other types.
Every resize layer takes ``forward(x, output_size=None)`` with NCHW input;
without ``output_size`` it scales by ``scale_factor``.
"""

from enum import Enum
from typing import Optional, Tuple, Union

import torch
from torch import nn

from .functional import resize_bilinear

__all__ = ["BilinearInterpolationLayer", "UpsampleLayerType", "instantiate_upsample_block"]


class UpsampleLayerType(Enum):
    NEAREST = "nearest"
    BILINEAR = "bilinear"
    PIXEL_SHUFFLE = "pixel_shuffle"
    PIXEL_SHUFFLE_LINEAR = "pixel_shuffle_linear"
    DECONVOLUTION = "deconv"
    RESIDUAL_DECONV = "residual_deconv"


class BilinearInterpolationLayer(nn.Module):
    def __init__(self, scale_factor: int = 2, align_corners: bool = True):
        super().__init__()
        self.scale_factor = scale_factor
        self.align_corners = align_corners

    def forward(self, x: torch.Tensor, output_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        if output_size is None:
            output_size = (x.shape[2] * self.scale_factor, x.shape[3] * self.scale_factor)
        return resize_bilinear(x, output_size, align_corners=self.align_corners)


def instantiate_upsample_block(block: Union[str, UpsampleLayerType], scale_factor: int = 2) -> nn.Module:
    """Upsample-layer factory; only ``bilinear`` is ported so far."""
    kind = UpsampleLayerType(block)
    if kind is UpsampleLayerType.BILINEAR:
        return BilinearInterpolationLayer(scale_factor=scale_factor)
    raise NotImplementedError(f"Upsample layer {kind.value!r} is not ported yet (ROADMAP.md queue 1)")
