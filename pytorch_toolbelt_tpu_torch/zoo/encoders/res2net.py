"""Res2Net encoders (arXiv:1904.01169; counterpart of
``pytorch_toolbelt_tpu/zoo/encoders/res2net.py``).

A Bottleneck whose 3x3 stage splits its width into ``scale`` groups.  Where
the JAX package departs from the reference Res2Net, the port follows it:

* The *first* split passes through, average-pooled with window = stride
  (2x2, floor mode) at stride 2; the reference passes the last split
  through a 3x3 stride-2 average pool with padding 1.
* Split i > 0 runs a 3x3 conv, BN and ReLU; at stride 1 split i > 1 adds
  split i - 1's output before its conv, at stride 2 no split does.
* The 3x3 convs are flax ``SAME`` (``Conv2dSame``): at stride 2 an even
  input pads (0, 1).  A stride-2 block needs an even input, in the JAX
  package too: the pooled split floors where the convs round up.

BatchNorm uses momentum 0.01, flax's default of 0.99 in torch's convention.
"""

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.simple import Conv2dSame
from .common import EncoderBase, _bn, _take
from .resnet import _shortcut

__all__ = ["Res2NetBottleneck", "Res2NetEncoder", "res2net50_encoder", "res2net101_encoder", "res2next50_encoder"]


class Res2NetBottleneck(nn.Module):
    """1x1 to ``scale`` splits of ``width`` channels -> the hierarchical 3x3
    splits -> 1x1 to ``out_channels``, the expanded width."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1, scale: int = 4, base_width: int = 26,
                 groups: int = 1, expansion: int = 4):
        super().__init__()
        width = int(out_channels // expansion * (base_width / 64.0)) * groups
        self.stride, self.scale = stride, scale
        self.conv1 = nn.Conv2d(in_channels, width * scale, 1, bias=False)
        self.bn1 = _bn(width * scale)
        self.convs = nn.ModuleList(Conv2dSame(width, width, 3, stride=stride, groups=groups, bias=False)
                                   for _ in range(scale - 1))
        self.bns = nn.ModuleList(_bn(width) for _ in range(scale - 1))
        self.conv3 = nn.Conv2d(width * scale, out_channels, 1, bias=False)
        self.bn3 = _bn(out_channels)
        self.downsample = _shortcut(in_channels, out_channels, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        splits = torch.chunk(y, self.scale, dim=1)
        outs = [splits[0] if self.stride == 1 else F.avg_pool2d(splits[0], self.stride, self.stride)]
        prev = None
        for sp, conv, bn in zip(splits[1:], self.convs, self.bns):
            inp = sp if prev is None or self.stride != 1 else sp + prev
            prev = F.relu(bn(conv(inp)))
            outs.append(prev)
        y = self.bn3(self.conv3(torch.cat(outs, dim=1)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class Res2NetEncoder(EncoderBase):
    """``in_channels`` is new here: flax infers it."""

    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 6, 3), scale: int = 4, base_width: int = 26,
                 groups: int = 1, layers: Optional[Tuple[int, ...]] = None, in_channels: int = 3):
        super().__init__()
        self.layers = None if layers is None else tuple(layers)
        self.conv1 = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        prev, stages = 64, []
        for stage, num_blocks in enumerate(stage_blocks):
            channels, blocks = 256 * (2**stage), []
            for i in range(num_blocks):
                blocks.append(Res2NetBottleneck(prev, channels, 2 if stage > 0 and i == 0 else 1, scale=scale,
                                                base_width=base_width, groups=groups))
                prev = channels
            stages.append(nn.Sequential(*blocks))
        self.stages = nn.ModuleList(stages)

    def get_output_spec(self) -> FeatureMapsSpec:
        channels, strides = (64, 256, 512, 1024, 2048), (2, 4, 8, 16, 32)
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


def res2net50_encoder(**kwargs) -> Res2NetEncoder:
    return Res2NetEncoder(stage_blocks=(3, 4, 6, 3), **kwargs)


def res2net101_encoder(**kwargs) -> Res2NetEncoder:
    return Res2NetEncoder(stage_blocks=(3, 4, 23, 3), **kwargs)


def res2next50_encoder(**kwargs) -> Res2NetEncoder:
    return Res2NetEncoder(stage_blocks=(3, 4, 6, 3), base_width=4, groups=8, **kwargs)
