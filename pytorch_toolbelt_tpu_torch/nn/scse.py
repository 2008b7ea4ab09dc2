"""Squeeze & Excitation gates (arXiv:1803.02579; counterpart of
``pytorch_toolbelt_tpu/nn/scse.py``).  Each takes the input's channels,
which flax infers."""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "ChannelGate2d",
    "ChannelSpatialGate2d",
    "ChannelSpatialGate2dV2",
    "SpatialGate2d",
    "SpatialGate2dV2",
]


class ChannelGate2d(nn.Module):
    """Channel squeeze: a 1x1 conv to one gate map that scales every channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.squeeze = nn.Conv2d(channels, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.squeeze(x))


class SpatialGate2d(nn.Module):
    """Spatial squeeze (classic SE): global average -> 1x1 conv -> relu ->
    1x1 conv -> sigmoid, which scales the channels.  Give one of
    ``reduction`` and ``squeeze_channels``."""

    def __init__(self, channels: int, reduction: Optional[int] = None, squeeze_channels: Optional[int] = None):
        super().__init__()
        if (reduction is None) == (squeeze_channels is None):
            raise ValueError("One of 'reduction' and 'squeeze_channels' must be set")
        squeeze = squeeze_channels or max(1, channels // reduction)
        self.squeeze = nn.Conv2d(channels, squeeze, 1)
        self.expand = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = self.expand(F.relu(self.squeeze(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(gate)


class ChannelSpatialGate2d(nn.Module):
    """Concurrent scSE: the sum of the channel and the spatial gate."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        self.channel_gate = ChannelGate2d(channels)
        self.spatial_gate = SpatialGate2d(channels, reduction=reduction)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.channel_gate(x) + self.spatial_gate(x)


class SpatialGate2dV2(nn.Module):
    """Spatial gate with a 7x7 conv of dilation 3 in its bottleneck, at every
    pixel: 1x1 conv -> dilated 7x7 -> relu -> 1x1 conv -> sigmoid."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        squeeze = max(1, channels // reduction)
        self.squeeze = nn.Conv2d(channels, squeeze, 1)
        self.conv = nn.Conv2d(squeeze, squeeze, 7, padding=9, dilation=3)
        self.expand = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = self.expand(F.relu(self.conv(self.squeeze(x))))
        return x * torch.sigmoid(gate)


class ChannelSpatialGate2dV2(nn.Module):
    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        self.channel_gate = ChannelGate2d(channels)
        self.spatial_gate = SpatialGate2dV2(channels, reduction=reduction)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.channel_gate(x) + self.spatial_gate(x)
