"""Stacked Hourglass encoders (counterpart of
``pytorch_toolbelt_tpu/zoo/encoders/hourglass.py``): the stem's map at
stride 4, then one feature map per hourglass stack, all at stride 4.  The
supervised variant also returns the intermediate supervision masks.

As in the JAX package, the residual blocks are pre-activation (BN, act,
conv three times), with a 1x1 shortcut conv where the channels change,
created last; an hourglass pools 2x2 (floor) and comes back up by a nearest
resize to its skip branch's size (torch's legacy rule, src = floor(dst *
in / out)); the stem's 7x7 stride-2 conv is flax ``SAME`` (an even side
pads (2, 3)).  Children are registered in flax's creation order, class by
class: an :class:`HGBlock` of depth > 1 holds ``HGResidualBlock_0``,
``HGResidualBlock_1``, ``HGBlock_0``, ``HGResidualBlock_2``; of depth 1
four ``HGResidualBlock``s.  BatchNorm uses momentum 0.01, flax's default
of 0.99 in torch's convention.
"""

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.activations import ACT_RELU, instantiate_activation_block
from ...nn.functional import resize_nearest
from ...nn.simple import Conv2dSame
from .common import EncoderBase, _bn

__all__ = ["HGBlock", "HGResidualBlock", "StackedHGEncoder", "StackedSupervisedHGEncoder"]


class HGResidualBlock(nn.Module):
    """Pre-activation bottleneck: BN -> act -> 1x1 (out / 2) -> BN -> act ->
    3x3 -> BN -> act -> 1x1 (out), plus the input (through a 1x1 conv where
    the channels change)."""

    def __init__(self, in_channels: int, out_channels: int, activation: str = ACT_RELU):
        super().__init__()
        mid = out_channels // 2
        self.act = instantiate_activation_block(activation)
        self.bn1 = _bn(in_channels)
        self.conv1 = nn.Conv2d(in_channels, mid, 1, bias=False)
        self.bn2 = _bn(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, padding=1, bias=False)
        self.bn3 = _bn(mid)
        self.conv3 = nn.Conv2d(mid, out_channels, 1, bias=False)
        self.shortcut = nn.Conv2d(in_channels, out_channels, 1, bias=False) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(self.act(self.bn1(x)))
        y = self.conv2(self.act(self.bn2(y)))
        y = self.conv3(self.act(self.bn3(y)))
        return y + (x if self.shortcut is None else self.shortcut(x))


class HGBlock(nn.Module):
    """Recursive hourglass: a skip branch, plus (2x2 max pool -> residual ->
    the hourglass of depth - 1, or a residual at depth 1 -> residual ->
    nearest resize)."""

    def __init__(self, depth: int, features: int, activation: str = ACT_RELU):
        super().__init__()
        self.up1 = HGResidualBlock(features, features, activation)
        self.low1 = HGResidualBlock(features, features, activation)
        if depth > 1:
            self.low2 = HGBlock(depth - 1, features, activation)
        else:
            self.low2 = HGResidualBlock(features, features, activation)
        self.low3 = HGResidualBlock(features, features, activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up1 = self.up1(x)
        low = self.low3(self.low2(self.low1(F.max_pool2d(x, 2, 2))))
        return up1 + resize_nearest(low, up1.shape[2:])


class _HGStem(nn.Module):
    """7x7 stride-2 SAME conv -> BN -> act -> residual (128) -> 2x2 max pool
    -> residual (128) -> residual (features): stride 4."""

    def __init__(self, in_channels: int, features: int, activation: str = ACT_RELU):
        super().__init__()
        self.act = instantiate_activation_block(activation)
        self.conv = Conv2dSame(in_channels, 64, 7, stride=2, bias=False)
        self.bn = _bn(64)
        self.res1 = HGResidualBlock(64, 128, activation)
        self.res2 = HGResidualBlock(128, 128, activation)
        self.res3 = HGResidualBlock(128, features, activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.res1(self.act(self.bn(self.conv(x))))
        return self.res3(self.res2(F.max_pool2d(x, 2, 2)))


class _HGFeatures(nn.Module):
    """``blocks`` residuals -> 1x1 conv -> BN -> act."""

    def __init__(self, features: int, blocks: int = 4, activation: str = ACT_RELU):
        super().__init__()
        self.act = instantiate_activation_block(activation)
        self.blocks = nn.Sequential(*(HGResidualBlock(features, features, activation) for _ in range(blocks)))
        self.conv = nn.Conv2d(features, features, 1, bias=False)
        self.bn = _bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(self.blocks(x))))


class StackedHGEncoder(EncoderBase):
    """``stack_level`` hourglasses of ``depth``; each stack's features feed
    the next through a 1x1 conv added to its input.  ``in_channels`` is new
    here (flax infers it)."""

    def __init__(self, stack_level: int = 8, depth: int = 4, features: int = 256, activation: str = ACT_RELU,
                 in_channels: int = 3):
        super().__init__()
        self.stack_level, self.features = stack_level, features
        self.stem = _HGStem(in_channels, features, activation)
        self.hourglasses = nn.ModuleList(HGBlock(depth, features, activation) for _ in range(stack_level))
        self.heads = nn.ModuleList(_HGFeatures(features, 4, activation) for _ in range(stack_level))
        self.merges = nn.ModuleList(nn.Conv2d(features, features, 1) for _ in range(stack_level - 1))

    def get_output_spec(self) -> FeatureMapsSpec:
        n = self.stack_level + 1
        return FeatureMapsSpec((self.features,) * n, (4,) * n)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(x)
        outputs = [x]
        for i, (hourglass, head) in enumerate(zip(self.hourglasses, self.heads)):
            features = head(hourglass(x))
            outputs.append(features)
            if i < self.stack_level - 1:
                x = x + self.merges[i](features)
        return outputs


class StackedSupervisedHGEncoder(EncoderBase):
    """Stacked hourglass with intermediate supervision: after each stack but
    the last, a 1x1 conv to ``supervision_channels`` masks, a 1x1 conv of
    the masks back to the features and the merge conv, created in that
    order.  Returns (feature maps, supervision masks)."""

    def __init__(self, supervision_channels: int = 1, stack_level: int = 8, depth: int = 4, features: int = 256,
                 activation: str = ACT_RELU, in_channels: int = 3):
        super().__init__()
        self.stack_level, self.features = stack_level, features
        self.stem = _HGStem(in_channels, features, activation)
        self.hourglasses = nn.ModuleList(HGBlock(depth, features, activation) for _ in range(stack_level))
        self.heads = nn.ModuleList(_HGFeatures(features, 4, activation) for _ in range(stack_level))
        self.supervision = nn.ModuleList(
            nn.ModuleList([nn.Conv2d(features, supervision_channels, 1), nn.Conv2d(supervision_channels, features, 1),
                           nn.Conv2d(features, features, 1)])
            for _ in range(stack_level - 1)
        )

    def get_output_spec(self) -> FeatureMapsSpec:
        n = self.stack_level + 1
        return FeatureMapsSpec((self.features,) * n, (4,) * n)

    def forward(self, x: torch.Tensor) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        x = self.stem(x)
        outputs, supervision = [x], []
        for i, (hourglass, head) in enumerate(zip(self.hourglasses, self.heads)):
            features = head(hourglass(x))
            outputs.append(features)
            if i < self.stack_level - 1:
                to_mask, from_mask, merge = self.supervision[i]
                mask = to_mask(features)
                supervision.append(mask)
                x = x + merge(features) + from_mask(mask)
        return outputs, supervision
