"""DenseNet encoders (counterpart of
``pytorch_toolbelt_tpu/zoo/encoders/densenet.py``): pre-activation dense
layers (BN, ReLU, 1x1 to ``bn_size * growth_rate``, BN, ReLU, 3x3 to
``growth_rate``, concatenated to the input) in four blocks, halved by
transitions (BN, ReLU, 1x1, 2x2 average pool in floor mode).

Returns [stem (stride 2), block 1 (4), block 2 (8), block 3 (16), block 4
(32)].  BatchNorm uses momentum 0.01, flax's default of 0.99 in torch's
convention.
"""

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from .common import EncoderBase, _bn, _take

__all__ = [
    "DenseBlock",
    "DenseLayer",
    "DenseNetEncoder",
    "Transition",
    "densenet121_encoder",
    "densenet161_encoder",
    "densenet169_encoder",
    "densenet201_encoder",
]


class DenseLayer(nn.Module):
    def __init__(self, in_channels: int, growth_rate: int, bn_size: int = 4):
        super().__init__()
        self.bn1 = _bn(in_channels)
        self.conv1 = nn.Conv2d(in_channels, bn_size * growth_rate, 1, bias=False)
        self.bn2 = _bn(bn_size * growth_rate)
        self.conv2 = nn.Conv2d(bn_size * growth_rate, growth_rate, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(self.bn1(x)))
        y = self.conv2(F.relu(self.bn2(y)))
        return torch.cat([x, y], dim=1)


class DenseBlock(nn.Module):
    def __init__(self, in_channels: int, num_layers: int, growth_rate: int):
        super().__init__()
        self.dense_layers = nn.Sequential(*(DenseLayer(in_channels + i * growth_rate, growth_rate)
                                            for i in range(num_layers)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense_layers(x)


class Transition(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.bn = _bn(in_channels)
        self.conv = nn.Conv2d(in_channels, out_channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv(F.relu(self.bn(x))), 2, 2)


class DenseNetEncoder(EncoderBase):
    """``in_channels`` is new here: flax infers it."""

    def __init__(self, block_config: Sequence[int] = (6, 12, 24, 16), growth_rate: int = 32,
                 num_init_features: int = 64, layers: Optional[Tuple[int, ...]] = None, in_channels: int = 3):
        super().__init__()
        self.layers = None if layers is None else tuple(layers)
        self.conv0 = nn.Conv2d(in_channels, num_init_features, 7, stride=2, padding=3, bias=False)
        self.bn0 = _bn(num_init_features)
        c, stages, self.feature_channels = num_init_features, [], (num_init_features,)
        for i, num_layers in enumerate(block_config):
            stage = [DenseBlock(c, num_layers, growth_rate)]
            c += num_layers * growth_rate
            self.feature_channels += (c,)
            if i != len(block_config) - 1:
                stage.append(Transition(c, c // 2))
                c //= 2
            stages.append(nn.ModuleList(stage))
        self.stages = nn.ModuleList(stages)

    def get_output_spec(self) -> FeatureMapsSpec:
        channels, strides = self.feature_channels, (2, 4, 8, 16, 32)
        if self.layers is not None:
            channels, strides = _take(channels, self.layers), _take(strides, self.layers)
        return FeatureMapsSpec(channels, strides)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn0(self.conv0(x)))
        outputs = [x]
        x = F.max_pool2d(x, 3, 2, padding=1)
        for stage in self.stages:
            x = stage[0](x)
            outputs.append(x)
            if len(stage) > 1:
                x = stage[1](x)
        if self.layers is not None:
            outputs = _take(outputs, self.layers)
        return outputs


def densenet121_encoder(**kwargs) -> DenseNetEncoder:
    return DenseNetEncoder(block_config=(6, 12, 24, 16), growth_rate=32, num_init_features=64, **kwargs)


def densenet161_encoder(**kwargs) -> DenseNetEncoder:
    return DenseNetEncoder(block_config=(6, 12, 36, 24), growth_rate=48, num_init_features=96, **kwargs)


def densenet169_encoder(**kwargs) -> DenseNetEncoder:
    return DenseNetEncoder(block_config=(6, 12, 32, 32), growth_rate=32, num_init_features=64, **kwargs)


def densenet201_encoder(**kwargs) -> DenseNetEncoder:
    return DenseNetEncoder(block_config=(6, 12, 48, 32), growth_rate=32, num_init_features=64, **kwargs)
