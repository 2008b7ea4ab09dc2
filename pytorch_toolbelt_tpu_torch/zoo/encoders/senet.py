"""SENet family encoders: SENet154, SE-ResNet 50/101/152, SE-ResNeXt 50/101
(counterpart of ``pytorch_toolbelt_tpu/zoo/encoders/senet.py``).

Module names follow the Cadene SENet that pytorch-toolbelt vendors
(``layer0.conv1``, ``layer1.0.se_module.fc1``, ``layer2.0.downsample.0``),
so its checkpoints' keys fit the state dict.  Architectural quirks kept as
the JAX package keeps them:

* Caffe-style SE-ResNet bottleneck: the stride sits on conv1 (1x1), not
  conv2.
* SENet154: triple-3x3 stem into 128 channels, grouped (64) 3x3 with
  planes*2 -> planes*4 channel flow, and 3x3/pad-1 downsample convs in
  stages 2-4.
* The stem feature is taken before the max pool (stride 2), which pools
  with ``ceil_mode=True``.

BatchNorm uses momentum 0.01: flax's default of 0.99 in torch's convention.
"""

import math
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from .common import EncoderBase, _bn

__all__ = [
    "SENetBottleneck",
    "SENetEncoder",
    "max_pool_ceil",
    "senet154_encoder",
    "se_resnet50_encoder",
    "se_resnet101_encoder",
    "se_resnet152_encoder",
    "se_resnext50_encoder",
    "se_resnext101_encoder",
]

def max_pool_ceil(x: torch.Tensor, window: int = 3, stride: int = 2) -> torch.Tensor:
    """2D max pool with ``ceil_mode=True`` (partial trailing windows included)."""
    return F.max_pool2d(x, window, stride, ceil_mode=True)


class SEModule(nn.Module):
    """GAP -> 1x1 conv (bias) -> relu -> 1x1 conv (bias) -> sigmoid, which
    scales the input's channels."""

    def __init__(self, channels: int, reduction: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = x.mean(dim=(2, 3), keepdim=True)
        g = self.fc2(F.relu(self.fc1(g)))
        return x * torch.sigmoid(g)


class SENetBottleneck(nn.Module):
    """One bottleneck of the Cadene SENet family; ``kind`` selects the channel
    flow and stride placement of SEBottleneck ('senet'), SEResNetBottleneck
    ('seresnet') or SEResNeXtBottleneck ('seresnext')."""

    def __init__(
        self,
        in_channels: int,
        kind: str,
        planes: int,
        groups: int,
        reduction: int,
        stride: int = 1,
        downsample_kernel: int = 0,  # 0 = identity shortcut
        base_width: int = 4,
    ):
        super().__init__()
        if kind == "senet":
            c1, c2 = planes * 2, planes * 4
            s1, s2, g = 1, stride, groups
        elif kind == "seresnet":
            c1, c2 = planes, planes
            s1, s2, g = stride, 1, 1  # Caffe style: stride on conv1
        elif kind == "seresnext":
            width = math.floor(planes * (base_width / 64)) * groups
            c1, c2 = width, width
            s1, s2, g = 1, stride, groups
        else:
            raise ValueError(f"Unknown SENet bottleneck kind {kind!r}")
        out_channels = planes * 4
        self.conv1 = nn.Conv2d(in_channels, c1, 1, stride=s1, bias=False)
        self.bn1 = _bn(c1)
        self.conv2 = nn.Conv2d(c1, c2, 3, stride=s2, padding=1, groups=g, bias=False)
        self.bn2 = _bn(c2)
        self.conv3 = nn.Conv2d(c2, out_channels, 1, bias=False)
        self.bn3 = _bn(out_channels)
        self.se_module = SEModule(out_channels, reduction)
        self.downsample = None
        if downsample_kernel:
            k = downsample_kernel
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, out_channels, k, stride=stride, padding=(k - 1) // 2, bias=False),
                _bn(out_channels),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(self.se_module(y) + residual)


class SENetEncoder(EncoderBase):
    """Feature maps at strides (2, 4, 8, 16, 32), channels
    (inplanes, 256, 512, 1024, 2048); ``layers`` picks a subset."""

    def __init__(
        self,
        kind: str = "seresnet",
        stage_blocks: Sequence[int] = (3, 4, 6, 3),
        groups: int = 1,
        reduction: int = 16,
        inplanes: int = 64,
        input_3x3: bool = False,
        downsample_kernel_size: int = 1,
        base_width: int = 4,
        layers: Optional[Tuple[int, ...]] = None,
        in_channels: int = 3,
    ):
        super().__init__()
        self.kind = kind
        self.stage_blocks = tuple(stage_blocks)
        self.inplanes = inplanes
        self.input_3x3 = input_3x3
        self.layers = None if layers is None else tuple(layers)

        if input_3x3:
            stem = [
                ("conv1", nn.Conv2d(in_channels, 64, 3, stride=2, padding=1, bias=False)), ("bn1", _bn(64)),
                ("relu1", nn.ReLU()),
                ("conv2", nn.Conv2d(64, 64, 3, padding=1, bias=False)), ("bn2", _bn(64)), ("relu2", nn.ReLU()),
                ("conv3", nn.Conv2d(64, inplanes, 3, padding=1, bias=False)), ("bn3", _bn(inplanes)),
                ("relu3", nn.ReLU()),
            ]
        else:
            stem = [
                ("conv1", nn.Conv2d(in_channels, inplanes, 7, stride=2, padding=3, bias=False)),
                ("bn1", _bn(inplanes)), ("relu1", nn.ReLU()),
            ]
        self.layer0 = nn.Sequential(OrderedDict(stem))

        prev = inplanes
        for stage, num_blocks in enumerate(self.stage_blocks, start=1):
            planes = 64 * 2 ** (stage - 1)
            stride = 1 if stage == 1 else 2
            dk = 1 if stage == 1 else downsample_kernel_size
            blocks = []
            for i in range(num_blocks):
                needs_ds = i == 0 and (stride != 1 or prev != planes * 4)
                blocks.append(SENetBottleneck(
                    prev, kind, planes, groups, reduction, stride=stride if i == 0 else 1,
                    downsample_kernel=dk if needs_ds else 0, base_width=base_width,
                ))
                prev = planes * 4
            self.add_module(f"layer{stage}", nn.Sequential(*blocks))

    @property
    def stages(self) -> List[nn.Sequential]:
        return [getattr(self, f"layer{s}") for s in range(1, len(self.stage_blocks) + 1)]

    def get_output_spec(self) -> FeatureMapsSpec:
        channels = (self.inplanes, 256, 512, 1024, 2048)
        strides = (2, 4, 8, 16, 32)
        if self.layers is not None:
            channels = tuple(channels[i] for i in self.layers)
            strides = tuple(strides[i] for i in self.layers)
        return FeatureMapsSpec(channels, strides)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.layer0(x)
        outputs = [x]  # stride 2, before the pool
        x = max_pool_ceil(x, 3, 2)
        for stage in self.stages:
            x = stage(x)
            outputs.append(x)
        if self.layers is not None:
            outputs = [outputs[i] for i in self.layers]
        return outputs


def senet154_encoder(**kwargs) -> SENetEncoder:
    """SENet154: triple-3x3 stem, 64 groups, 3x3 downsample convs."""
    return SENetEncoder(
        kind="senet", stage_blocks=(3, 8, 36, 3), groups=64, reduction=16,
        inplanes=128, input_3x3=True, downsample_kernel_size=3, **kwargs
    )


def se_resnet50_encoder(**kwargs) -> SENetEncoder:
    return SENetEncoder(kind="seresnet", stage_blocks=(3, 4, 6, 3), **kwargs)


def se_resnet101_encoder(**kwargs) -> SENetEncoder:
    return SENetEncoder(kind="seresnet", stage_blocks=(3, 4, 23, 3), **kwargs)


def se_resnet152_encoder(**kwargs) -> SENetEncoder:
    return SENetEncoder(kind="seresnet", stage_blocks=(3, 8, 36, 3), **kwargs)


def se_resnext50_encoder(**kwargs) -> SENetEncoder:
    return SENetEncoder(kind="seresnext", stage_blocks=(3, 4, 6, 3), groups=32, base_width=4, **kwargs)


def se_resnext101_encoder(**kwargs) -> SENetEncoder:
    return SENetEncoder(kind="seresnext", stage_blocks=(3, 4, 23, 3), groups=32, base_width=4, **kwargs)
