"""Depthwise-separable convolutions (counterpart of
``pytorch_toolbelt_tpu/nn/dsconv.py``).  Each takes the input's channels,
which flax infers.

The depthwise conv is padded as flax's ``SAME`` (``Conv2dSame``): at stride
2 an even input is padded (0, 1), where torch's ``padding=k // 2`` pads
(1, 1).
"""

import torch
from torch import nn

from .activations import instantiate_activation_block
from .normalization import NORM_BATCH, Normalization
from .simple import Conv2dSame

__all__ = ["DepthwiseSeparableConv2d", "DepthwiseSeparableConv2dBlock"]


class DepthwiseSeparableConv2d(nn.Module):
    """A depthwise k x k conv (one filter per input channel, with the
    stride and dilation), then a pointwise 1x1 conv in ``groups`` groups."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1,
                 dilation: int = 1, groups: int = 1, bias: bool = True):
        super().__init__()
        self.depthwise = Conv2dSame(in_channels, in_channels, kernel_size, stride=stride, dilation=dilation,
                                    groups=in_channels, bias=bias)
        self.pointwise = nn.Conv2d(in_channels, out_channels, 1, groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class DepthwiseSeparableConv2dBlock(nn.Module):
    """Depthwise-separable conv (no bias) -> norm -> activation."""

    def __init__(self, in_channels: int, out_channels: int, activation: str, kernel_size: int = 3, stride: int = 1,
                 dilation: int = 1, normalization: str = NORM_BATCH):
        super().__init__()
        self.conv = DepthwiseSeparableConv2d(in_channels, out_channels, kernel_size=kernel_size, stride=stride,
                                             dilation=dilation, bias=False)
        self.norm = Normalization(normalization, out_channels)
        self.act = instantiate_activation_block(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(self.conv(x)))
