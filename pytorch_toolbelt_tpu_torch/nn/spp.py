"""Atrous Spatial Pyramid Pooling (counterpart of ``pytorch_toolbelt_tpu/nn/spp.py``).
Each module takes the input's channels, which flax infers.

As in the JAX package, only ASPP's dilation-1 branch takes ``activation``:
the pooling branch and the atrous branches use ReLU, and the branches are
concatenated in the order flax creates them (dilation 1, pooling, then one
per rate).
"""

from typing import Tuple

import torch
from torch import nn

from .activations import ACT_RELU, instantiate_activation_block
from .dsconv import DepthwiseSeparableConv2d
from .normalization import NORM_BATCH, Normalization
from .simple import Conv2dSame

__all__ = ["ASPP", "ASPPModule", "ASPPPooling", "SeparableASPPModule"]


class ASPPModule(nn.Module):
    """Dilated k x k conv (no bias) -> batch norm -> activation."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, dilation: int = 1,
                 activation: str = ACT_RELU):
        super().__init__()
        self.conv = Conv2dSame(in_channels, out_channels, kernel_size, dilation=dilation, bias=False)
        self.norm = Normalization(NORM_BATCH, out_channels)
        self.act = instantiate_activation_block(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(self.conv(x)))


class SeparableASPPModule(nn.Module):
    """Dilated depthwise-separable conv (no bias) -> batch norm -> activation."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, dilation: int = 1,
                 activation: str = ACT_RELU):
        super().__init__()
        self.conv = DepthwiseSeparableConv2d(in_channels, out_channels, kernel_size=kernel_size, dilation=dilation,
                                             bias=False)
        self.norm = Normalization(NORM_BATCH, out_channels)
        self.act = instantiate_activation_block(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(self.conv(x)))


class ASPPPooling(nn.Module):
    """Image-pooling branch: global average -> 1x1 conv -> norm -> activation,
    broadcast back to the map's size (a bilinear resize of a 1x1 map)."""

    def __init__(self, in_channels: int, out_channels: int, activation: str = ACT_RELU):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.norm = Normalization(NORM_BATCH, out_channels)
        self.act = instantiate_activation_block(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.act(self.norm(self.conv(x.mean(dim=(2, 3), keepdim=True))))
        return p.expand(-1, -1, x.shape[2], x.shape[3])


class ASPP(nn.Module):
    """Dilated branches and the pooling branch, concatenated, then a 1x1
    projection -> norm -> activation -> dropout."""

    def __init__(self, in_channels: int, out_channels: int, atrous_rates: Tuple[int, ...] = (12, 24, 36),
                 dropout: float = 0.5, activation: str = ACT_RELU, separable: bool = False):
        super().__init__()
        module_cls = SeparableASPPModule if separable else ASPPModule
        self.branches = nn.ModuleList(
            [module_cls(in_channels, out_channels, kernel_size=3, dilation=1, activation=activation),
             ASPPPooling(in_channels, out_channels)]
            + [module_cls(in_channels, out_channels, kernel_size=3, dilation=rate) for rate in atrous_rates]
        )
        self.project = nn.Conv2d(out_channels * len(self.branches), out_channels, 1, bias=False)
        self.norm = Normalization(NORM_BATCH, out_channels)
        self.act = instantiate_activation_block(activation)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([branch(x) for branch in self.branches], dim=1)
        return self.dropout(self.act(self.norm(self.project(x))))
