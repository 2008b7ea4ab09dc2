"""Upsample layers and their factory (counterpart of
``pytorch_toolbelt_tpu/nn/upsample.py``).

Every resize layer takes ``forward(x, output_size=None)`` with NCHW input;
without ``output_size`` it scales by ``scale_factor``.  The pixel-shuffle
and deconvolution layers ignore ``output_size``, as in JAX.  The layers with
weights take ``in_channels``, which flax infers.

Two conventions of the JAX package that torch's defaults do not share:

* ``PixelShuffle`` divides the channels by n = 2**scale_factor (the
  reference's quirk; n = scale_factor**2 at scales 2 and 4) and first maps
  them with a 1x1 conv to a multiple of n where they do not divide.
* The deconvolutions are flax's ``ConvTranspose(3x3, stride 2, "SAME")``:
  the full transposed convolution (2H + 1 rows) with its last row and
  column cut, which is not ``nn.ConvTranspose2d(3, 2, padding=1,
  output_padding=1)``.  The weight is the flax kernel flipped in space
  (``zoo.porting`` does it).
"""

import inspect
from enum import Enum
from typing import Optional, Tuple, Type, Union

import torch
import torch.nn.functional as F
from torch import nn

from .functional import resize_bilinear, resize_nearest
from .initialization import icnr_init

__all__ = [
    "AbstractResizeLayer",
    "BilinearAdditiveUpsample2d",
    "BilinearInterpolationLayer",
    "DeconvolutionUpsample2d",
    "NearestNeighborResizeLayer",
    "PixelShuffle",
    "PixelShuffleWithLinear",
    "ResidualDeconvolutionUpsample2d",
    "UpsampleLayerType",
    "instantiate_upsample_block",
    "upsample_out_channels",
]


class UpsampleLayerType(Enum):
    NEAREST = "nearest"
    BILINEAR = "bilinear"
    PIXEL_SHUFFLE = "pixel_shuffle"
    PIXEL_SHUFFLE_LINEAR = "pixel_shuffle_linear"
    DECONVOLUTION = "deconv"
    RESIDUAL_DECONV = "residual_deconv"


class AbstractResizeLayer(nn.Module):
    """Base class of the resize layers (one forward signature)."""

    def __init__(self, scale_factor: int = 2):
        super().__init__()
        self.scale_factor = scale_factor

    def _target_size(self, x: torch.Tensor, output_size: Optional[Tuple[int, int]]) -> Tuple[int, int]:
        if output_size is not None:
            return int(output_size[0]), int(output_size[1])
        return x.shape[2] * self.scale_factor, x.shape[3] * self.scale_factor


class NearestNeighborResizeLayer(AbstractResizeLayer):
    def forward(self, x: torch.Tensor, output_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        return resize_nearest(x, self._target_size(x, output_size))


class BilinearInterpolationLayer(AbstractResizeLayer):
    def __init__(self, scale_factor: int = 2, align_corners: bool = True):
        super().__init__(scale_factor)
        self.align_corners = align_corners

    def forward(self, x: torch.Tensor, output_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        return resize_bilinear(x, self._target_size(x, output_size), align_corners=self.align_corners)


class PixelShuffle(AbstractResizeLayer):
    """Depth-to-space by ``scale_factor``; in_channels // 2**scale_factor out."""

    def __init__(self, in_channels: int, scale_factor: int = 2):
        super().__init__(scale_factor)
        n = 2**scale_factor
        rounded = in_channels // n * n
        self.conv = nn.Conv2d(in_channels, rounded, 1, bias=False) if rounded != in_channels else None

    def forward(self, x: torch.Tensor, output_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        if self.conv is not None:
            x = self.conv(x)
        return F.pixel_shuffle(x, self.scale_factor)


class PixelShuffleWithLinear(AbstractResizeLayer):
    """A SAME conv to in_channels * s^2 channels (ICNR init), then
    depth-to-space by s: the channels are kept."""

    def __init__(self, in_channels: int, scale_factor: int = 2, kernel_size: int = 3):
        super().__init__(scale_factor)
        s = scale_factor
        self.conv = nn.Conv2d(in_channels, in_channels * s * s, kernel_size, padding=kernel_size // 2, bias=False)
        icnr_init(s)(self.conv.weight)

    def forward(self, x: torch.Tensor, output_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        return F.pixel_shuffle(self.conv(x), self.scale_factor)


class BilinearAdditiveUpsample2d(AbstractResizeLayer):
    """Bilinear upsample (corners aligned), then the mean of each group of
    n = 2**scale_factor consecutive channels (arXiv:1707.05847)."""

    def forward(self, x: torch.Tensor, output_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        n = 2**self.scale_factor
        b, c = x.shape[:2]
        if c % n != 0:
            raise ValueError(f"Number of input channels ({c}) must be divisible by n ({n})")
        x = resize_bilinear(x, self._target_size(x, output_size), align_corners=True)
        return x.reshape(b, c // n, n, *x.shape[2:]).mean(2)


def _check_scale_2(scale_factor: int) -> None:
    if scale_factor != 2:
        raise NotImplementedError("Scale factor other than 2 is not implemented")


def _deconv_same(conv: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
    """flax ConvTranspose(3x3, stride 2, SAME): [.., H, W] -> [.., 2H, 2W]."""
    return conv(x)[:, :, : 2 * x.shape[2], : 2 * x.shape[3]]


class DeconvolutionUpsample2d(AbstractResizeLayer):
    """3x3 stride-2 transposed conv, channels kept; scale 2 only."""

    def __init__(self, in_channels: int, scale_factor: int = 2):
        _check_scale_2(scale_factor)
        super().__init__(scale_factor)
        self.conv = nn.ConvTranspose2d(in_channels, in_channels, 3, stride=2)

    def forward(self, x: torch.Tensor, output_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        return _deconv_same(self.conv, x)


class ResidualDeconvolutionUpsample2d(AbstractResizeLayer):
    """A 3x3 stride-2 transposed conv to in_channels // 4 channels plus the
    bilinear-additive upsample of the input; scale 2 only."""

    def __init__(self, in_channels: int, scale_factor: int = 2):
        _check_scale_2(scale_factor)
        super().__init__(scale_factor)
        self.residual = BilinearAdditiveUpsample2d(scale_factor)
        self.conv = nn.ConvTranspose2d(in_channels, in_channels // (scale_factor * scale_factor), 3, stride=2)

    def forward(self, x: torch.Tensor, output_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        return _deconv_same(self.conv, x) + self.residual(x)


_LAYERS = {
    UpsampleLayerType.NEAREST: NearestNeighborResizeLayer,
    UpsampleLayerType.BILINEAR: BilinearInterpolationLayer,
    UpsampleLayerType.PIXEL_SHUFFLE: PixelShuffle,
    UpsampleLayerType.PIXEL_SHUFFLE_LINEAR: PixelShuffleWithLinear,
    UpsampleLayerType.DECONVOLUTION: DeconvolutionUpsample2d,
    UpsampleLayerType.RESIDUAL_DECONV: ResidualDeconvolutionUpsample2d,
}


def _layer_class(block: Union[str, UpsampleLayerType, Type[AbstractResizeLayer]]) -> Type[AbstractResizeLayer]:
    if isinstance(block, str):
        block = UpsampleLayerType(block)
    if isinstance(block, UpsampleLayerType):
        block = _LAYERS[block]
    return block


def upsample_out_channels(
    block: Union[str, UpsampleLayerType, Type[AbstractResizeLayer]], in_channels: int, scale_factor: int
) -> int:
    """The channels a resize layer outputs for ``in_channels`` inputs."""
    block = _layer_class(block)
    if block in (NearestNeighborResizeLayer, BilinearInterpolationLayer, DeconvolutionUpsample2d,
                 PixelShuffleWithLinear):
        return in_channels
    if block in (PixelShuffle, BilinearAdditiveUpsample2d):
        return in_channels // (2**scale_factor)
    if block is ResidualDeconvolutionUpsample2d:
        return in_channels // (scale_factor * scale_factor)
    raise ValueError(f"Unknown upsample block {block}")


def instantiate_upsample_block(
    block: Union[str, UpsampleLayerType, Type[AbstractResizeLayer]],
    scale_factor: int = 2,
    in_channels: Optional[int] = None,
    **kwargs,
) -> AbstractResizeLayer:
    """Upsample-layer factory.  ``in_channels`` is required by the layers
    with weights (pixel shuffle, deconvolutions) and not passed to the
    others."""
    block = _layer_class(block)
    if "in_channels" in inspect.signature(block).parameters:
        if in_channels is None:
            raise ValueError(f"{block.__name__} needs in_channels")
        kwargs["in_channels"] = in_channels
    return block(scale_factor=scale_factor, **kwargs)
