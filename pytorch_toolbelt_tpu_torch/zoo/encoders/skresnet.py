"""Selective-Kernel ResNet encoders (arXiv:1903.06586; counterpart of
``pytorch_toolbelt_tpu/zoo/encoders/skresnet.py``).

The SK unit runs ``num_paths`` 3x3 convs of dilation 1, 2, ... (flax
``SAME``, grouped) and mixes them with a softmax over the paths per
channel, computed from the global average of their sum through two Dense
layers.  BatchNorm uses momentum 0.01, flax's default of 0.99 in torch's
convention.
"""

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.simple import Conv2dSame
from .common import EncoderBase, _bn, _take
from .resnet import _shortcut

__all__ = [
    "SKBasicBlock",
    "SKBottleneck",
    "SKResNetEncoder",
    "SelectiveKernelConv",
    "skresnet18_encoder",
    "skresnet34_encoder",
    "skresnet50_encoder",
    "skresnext50_encoder",
]


class SelectiveKernelConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1, num_paths: int = 2,
                 reduction: int = 16, groups: int = 1):
        super().__init__()
        self.num_paths, self.out_channels = num_paths, out_channels
        self.convs = nn.ModuleList(Conv2dSame(in_channels, out_channels, 3, stride=stride, dilation=k + 1,
                                              groups=groups, bias=False) for k in range(num_paths))
        self.bns = nn.ModuleList(_bn(out_channels) for _ in range(num_paths))
        squeeze = max(out_channels // reduction, 32)
        self.fc1 = nn.Linear(out_channels, squeeze)
        self.fc2 = nn.Linear(squeeze, out_channels * num_paths)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stacked = torch.stack([F.relu(bn(conv(x))) for conv, bn in zip(self.convs, self.bns)], dim=1)
        s = stacked.sum(dim=1).mean(dim=(2, 3))  # [B, C]
        logits = self.fc2(F.relu(self.fc1(s)))
        attn = logits.view(-1, self.num_paths, self.out_channels).softmax(dim=1)  # [B, P, C]
        return (stacked * attn[:, :, :, None, None]).sum(dim=1)


class SKBasicBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.sk = SelectiveKernelConv(in_channels, out_channels, stride=stride)
        self.conv2 = Conv2dSame(out_channels, out_channels, 3, bias=False)
        self.bn2 = _bn(out_channels)
        self.downsample = _shortcut(in_channels, out_channels, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv2(self.sk(x)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class SKBottleneck(nn.Module):
    """1x1 -> grouped SK unit (with the stride) -> 1x1 to ``out_channels``;
    the inner width is int(out / expansion * base_width / 64) * groups."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1, expansion: int = 4, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        width = int(out_channels // expansion * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2d(in_channels, width, 1, bias=False)
        self.bn1 = _bn(width)
        self.sk = SelectiveKernelConv(width, width, stride=stride, groups=groups)
        self.conv3 = nn.Conv2d(width, out_channels, 1, bias=False)
        self.bn3 = _bn(out_channels)
        self.downsample = _shortcut(in_channels, out_channels, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.sk(F.relu(self.bn1(self.conv1(x))))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class SKResNetEncoder(EncoderBase):
    """``in_channels`` is new here: flax infers it."""

    def __init__(self, stage_blocks: Sequence[int] = (2, 2, 2, 2), bottleneck: bool = False, groups: int = 1,
                 base_width: int = 64, layers: Optional[Tuple[int, ...]] = None, in_channels: int = 3):
        super().__init__()
        self.expansion = 4 if bottleneck else 1
        self.layers = None if layers is None else tuple(layers)
        self.conv1 = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        prev, stages = 64, []
        for stage, num_blocks in enumerate(stage_blocks):
            channels, blocks = 64 * (2**stage) * self.expansion, []
            for i in range(num_blocks):
                stride = 2 if stage > 0 and i == 0 else 1
                blocks.append(SKBottleneck(prev, channels, stride, groups=groups, base_width=base_width)
                              if bottleneck else SKBasicBlock(prev, channels, stride))
                prev = channels
            stages.append(nn.Sequential(*blocks))
        self.stages = nn.ModuleList(stages)

    def get_output_spec(self) -> FeatureMapsSpec:
        e = self.expansion
        channels, strides = (64, 64 * e, 128 * e, 256 * e, 512 * e), (2, 4, 8, 16, 32)
        if self.layers is not None:
            channels, strides = _take(channels, self.layers), _take(strides, self.layers)
        return FeatureMapsSpec(channels, strides)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        outputs = [x]
        x = F.max_pool2d(x, 3, 2, padding=1)
        for stage in self.stages:
            x = stage(x)
            outputs.append(x)
        if self.layers is not None:
            outputs = _take(outputs, self.layers)
        return outputs


def skresnet18_encoder(**kwargs) -> SKResNetEncoder:
    return SKResNetEncoder(stage_blocks=(2, 2, 2, 2), bottleneck=False, **kwargs)


def skresnet34_encoder(**kwargs) -> SKResNetEncoder:
    return SKResNetEncoder(stage_blocks=(3, 4, 6, 3), bottleneck=False, **kwargs)


def skresnet50_encoder(**kwargs) -> SKResNetEncoder:
    return SKResNetEncoder(stage_blocks=(3, 4, 6, 3), bottleneck=True, **kwargs)


def skresnext50_encoder(**kwargs) -> SKResNetEncoder:
    """SK-ResNeXt50 32x4d: grouped SK bottlenecks, cardinality 32, width 4."""
    return SKResNetEncoder(stage_blocks=(3, 4, 6, 3), bottleneck=True, groups=32, base_width=4, **kwargs)
