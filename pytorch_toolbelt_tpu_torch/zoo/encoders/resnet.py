"""ResNet-family encoders (counterpart of ``pytorch_toolbelt_tpu/zoo/encoders/resnet.py``):
BasicBlock (18/34) and Bottleneck (50/101/152) ResNets, their SE and
ResNeXt variants, and the ResNet-D family (deep stem, average-pool
shortcut).

Feature maps: [stem (stride 2), stage 1 (4), stage 2 (8), stage 3 (16),
stage 4 (32)].  Module names follow torchvision and timm (``conv1``,
``bn1``, ``layer1.0.conv1``, ``layer2.0.downsample.0``).  Where the JAX
package departs from them, the port follows the JAX package:

* Every 3x3 conv is flax's ``SAME`` (``Conv2dSame``): at stride 2 an even
  input is padded (0, 1), where torchvision pads (1, 1).
* ``avg_down`` pools 2x2 in floor mode, counting no padding; timm pools in
  ceil mode with ``count_include_pad=False``.
* The SE gate of a block runs before the shortcut is added, on
  max(1, channels // 16) squeezed channels.

BatchNorm uses momentum 0.01: flax's default of 0.99 in torch's convention.
"""

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.scse import SpatialGate2d
from ...nn.simple import Conv2dSame
from .common import EncoderBase, _bn

__all__ = [
    "ResNetEncoder",
    "resnet18_encoder",
    "resnet34_encoder",
    "resnet50_encoder",
    "resnet101_encoder",
    "resnet152_encoder",
    "seresnet50_encoder",
    "seresnet101_encoder",
    "seresnet152_encoder",
    "seresnext50_encoder",
    "seresnext101_encoder",
    "resnet26d_encoder",
    "resnet50d_encoder",
    "resnet101d_encoder",
    "resnet152d_encoder",
    "resnet200d_encoder",
    "seresnet152d_encoder",
    "swsl_resnext101_encoder",
]


class _SEModule(SpatialGate2d):
    """Classic SE gate (global average -> 1x1 conv -> relu -> 1x1 conv -> sigmoid)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__(channels, reduction=reduction)


def _conv3x3(in_channels: int, out_channels: int, stride: int = 1, groups: int = 1) -> Conv2dSame:
    return Conv2dSame(in_channels, out_channels, 3, stride=stride, groups=groups, bias=False)


def _shortcut(in_channels: int, out_channels: int, stride: int, avg_down: bool = False) -> Optional[nn.Sequential]:
    """The projection shortcut where the block changes the shape, else None."""
    if stride == 1 and in_channels == out_channels:
        return None
    if avg_down and stride > 1:
        return nn.Sequential(nn.AvgPool2d(2, 2), nn.Conv2d(in_channels, out_channels, 1, bias=False),
                             _bn(out_channels))
    return nn.Sequential(nn.Conv2d(in_channels, out_channels, 1, stride=stride, bias=False), _bn(out_channels))


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1, use_se: bool = False,
                 se_reduction: int = 16):
        super().__init__()
        self.conv1 = _conv3x3(in_channels, out_channels, stride)
        self.bn1 = _bn(out_channels)
        self.conv2 = _conv3x3(out_channels, out_channels)
        self.bn2 = _bn(out_channels)
        self.se = _SEModule(out_channels, se_reduction) if use_se else None
        self.downsample = _shortcut(in_channels, out_channels, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.se is not None:
            y = self.se(y)
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> grouped 3x3 (with the stride) -> 1x1 to ``out_channels``, the
    expanded width; the inner width is out / expansion * base_width / 64 *
    groups."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1, groups: int = 1, base_width: int = 64,
                 use_se: bool = False, se_reduction: int = 16, expansion: int = 4, avg_down: bool = False):
        super().__init__()
        width = int(out_channels / expansion * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2d(in_channels, width, 1, bias=False)
        self.bn1 = _bn(width)
        self.conv2 = _conv3x3(width, width, stride, groups)
        self.bn2 = _bn(width)
        self.conv3 = nn.Conv2d(width, out_channels, 1, bias=False)
        self.bn3 = _bn(out_channels)
        self.se = _SEModule(out_channels, se_reduction) if use_se else None
        self.downsample = _shortcut(in_channels, out_channels, stride, avg_down)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.se is not None:
            y = self.se(y)
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNetEncoder(EncoderBase):
    """Configurable ResNet / SE-ResNet / ResNeXt / ResNet-D encoder.
    ``in_channels`` is new here: flax infers it."""

    def __init__(
        self,
        stage_blocks: Sequence[int] = (2, 2, 2, 2),
        bottleneck: bool = False,
        groups: int = 1,
        base_width: int = 64,
        use_se: bool = False,
        stem_channels: int = 64,
        deep_stem: bool = False,
        avg_down: bool = False,
        layers: Optional[Tuple[int, ...]] = None,
        in_channels: int = 3,
    ):
        super().__init__()
        self.stage_blocks = tuple(stage_blocks)
        self.bottleneck = bottleneck
        self.stem_channels = stem_channels
        self.layers = None if layers is None else tuple(layers)

        if deep_stem:  # ResNet-D: 3x3/2 -> 3x3 -> 3x3
            mid = stem_channels // 2
            self.conv1 = nn.Sequential(
                _conv3x3(in_channels, mid, 2), _bn(mid), nn.ReLU(),
                _conv3x3(mid, mid), _bn(mid), nn.ReLU(),
                _conv3x3(mid, stem_channels),
            )
        else:
            self.conv1 = nn.Conv2d(in_channels, stem_channels, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(stem_channels)

        prev = stem_channels
        for stage, (num_blocks, channels) in enumerate(zip(self.stage_blocks, self._stage_channels()), start=1):
            blocks = []
            for i in range(num_blocks):
                stride = 2 if stage > 1 and i == 0 else 1
                if bottleneck:
                    blocks.append(Bottleneck(prev, channels, stride, groups=groups, base_width=base_width,
                                             use_se=use_se, avg_down=avg_down))
                else:
                    blocks.append(BasicBlock(prev, channels, stride, use_se=use_se))
                prev = channels
            self.add_module(f"layer{stage}", nn.Sequential(*blocks))

    def _stage_channels(self) -> Tuple[int, ...]:
        expansion = 4 if self.bottleneck else 1
        return tuple(64 * (2**i) * expansion for i in range(4))

    @property
    def stages(self) -> List[nn.Sequential]:
        return [getattr(self, f"layer{s}") for s in range(1, len(self.stage_blocks) + 1)]

    def get_output_spec(self) -> FeatureMapsSpec:
        channels = (self.stem_channels,) + self._stage_channels()
        strides = (2, 4, 8, 16, 32)
        if self.layers is not None:
            channels = tuple(channels[i] for i in self.layers)
            strides = tuple(strides[i] for i in self.layers)
        return FeatureMapsSpec(channels, strides)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        outputs = [x]
        x = F.max_pool2d(x, 3, 2, padding=1)
        for stage in self.stages:
            x = stage(x)
            outputs.append(x)
        if self.layers is not None:
            outputs = [outputs[i] for i in self.layers]
        return outputs


def resnet18_encoder(**kwargs) -> ResNetEncoder:
    return ResNetEncoder(stage_blocks=(2, 2, 2, 2), bottleneck=False, **kwargs)


def resnet34_encoder(**kwargs) -> ResNetEncoder:
    return ResNetEncoder(stage_blocks=(3, 4, 6, 3), bottleneck=False, **kwargs)


def resnet50_encoder(**kwargs) -> ResNetEncoder:
    return ResNetEncoder(stage_blocks=(3, 4, 6, 3), bottleneck=True, **kwargs)


def resnet101_encoder(**kwargs) -> ResNetEncoder:
    return ResNetEncoder(stage_blocks=(3, 4, 23, 3), bottleneck=True, **kwargs)


def resnet152_encoder(**kwargs) -> ResNetEncoder:
    return ResNetEncoder(stage_blocks=(3, 8, 36, 3), bottleneck=True, **kwargs)


def seresnet50_encoder(**kwargs) -> ResNetEncoder:
    return ResNetEncoder(stage_blocks=(3, 4, 6, 3), bottleneck=True, use_se=True, **kwargs)


def seresnet101_encoder(**kwargs) -> ResNetEncoder:
    return ResNetEncoder(stage_blocks=(3, 4, 23, 3), bottleneck=True, use_se=True, **kwargs)


def seresnet152_encoder(**kwargs) -> ResNetEncoder:
    return ResNetEncoder(stage_blocks=(3, 8, 36, 3), bottleneck=True, use_se=True, **kwargs)


def seresnext50_encoder(**kwargs) -> ResNetEncoder:
    return ResNetEncoder(stage_blocks=(3, 4, 6, 3), bottleneck=True, use_se=True, groups=32, base_width=4, **kwargs)


def seresnext101_encoder(**kwargs) -> ResNetEncoder:
    return ResNetEncoder(stage_blocks=(3, 4, 23, 3), bottleneck=True, use_se=True, groups=32, base_width=4, **kwargs)


def _resnet_d(stage_blocks, **kwargs) -> ResNetEncoder:
    return ResNetEncoder(stage_blocks=stage_blocks, bottleneck=True, deep_stem=True, avg_down=True, **kwargs)


def resnet26d_encoder(**kwargs) -> ResNetEncoder:
    return _resnet_d((2, 2, 2, 2), **kwargs)


def resnet50d_encoder(**kwargs) -> ResNetEncoder:
    return _resnet_d((3, 4, 6, 3), **kwargs)


def resnet101d_encoder(**kwargs) -> ResNetEncoder:
    return _resnet_d((3, 4, 23, 3), **kwargs)


def resnet152d_encoder(**kwargs) -> ResNetEncoder:
    return _resnet_d((3, 8, 36, 3), **kwargs)


def resnet200d_encoder(**kwargs) -> ResNetEncoder:
    return _resnet_d((3, 24, 36, 3), **kwargs)


def seresnet152d_encoder(**kwargs) -> ResNetEncoder:
    return _resnet_d((3, 8, 36, 3), use_se=True, **kwargs)


def swsl_resnext101_encoder(**kwargs) -> ResNetEncoder:
    """ResNeXt101 32x8d (the SWSL preset differs only in its pretrained weights)."""
    return ResNetEncoder(stage_blocks=(3, 4, 23, 3), bottleneck=True, groups=32, base_width=8, **kwargs)
