"""SqueezeNet 1.1 encoder (counterpart of
``pytorch_toolbelt_tpu/zoo/encoders/squeezenet.py``): feature maps
[64 @ 2, 128 @ 4, 256 @ 8, 512 @ 16].

As in the JAX package, the stem is a 3x3 stride-2 flax ``SAME`` conv with a
bias (an even input pads (0, 1)), each ``Fire`` concatenates its 1x1 and
3x3 expansions in that order, and the three 3x3 stride-2 max pools pad
(1, 1) with -inf.
"""

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.simple import Conv2dSame
from .common import EncoderBase, _take

__all__ = ["Fire", "SqueezeNetEncoder", "squeezenet_encoder"]


class Fire(nn.Module):
    """1x1 squeeze -> relu, then [relu(1x1 expand), relu(3x3 expand)]
    concatenated.  ``in_channels`` is new here (flax infers it)."""

    def __init__(self, in_channels: int, squeeze: int, expand1x1: int, expand3x3: int):
        super().__init__()
        self.squeeze = nn.Conv2d(in_channels, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand1x1, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand3x3, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)), F.relu(self.expand3x3(s))], dim=1)


# (squeeze, expand) of the Fire modules after each of the three max pools
_STAGES = (((16, 64), (16, 64)), ((32, 128), (32, 128)), ((48, 192), (48, 192), (64, 256), (64, 256)))


class SqueezeNetEncoder(EncoderBase):
    """SqueezeNet 1.1 feature extractor.  ``in_channels`` is new here."""

    def __init__(self, layers: Optional[Tuple[int, ...]] = None, in_channels: int = 3):
        super().__init__()
        self.layers = None if layers is None else tuple(layers)
        self.stem = Conv2dSame(in_channels, 64, 3, stride=2)
        self.stages = nn.ModuleList()
        prev = 64
        for stage in _STAGES:
            fires = nn.ModuleList()
            for squeeze, expand in stage:
                fires.append(Fire(prev, squeeze, expand, expand))
                prev = 2 * expand
            self.stages.append(fires)

    def get_output_spec(self) -> FeatureMapsSpec:
        channels, strides = (64, 128, 256, 512), (2, 4, 8, 16)
        if self.layers is not None:
            channels, strides = _take(channels, self.layers), _take(strides, self.layers)
        return FeatureMapsSpec(channels, strides)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.stem(x))
        outputs = [x]
        for fires in self.stages:
            x = F.max_pool2d(x, 3, 2, padding=1)
            for fire in fires:
                x = fire(x)
            outputs.append(x)
        return outputs if self.layers is None else _take(outputs, self.layers)


def squeezenet_encoder(**kwargs) -> SqueezeNetEncoder:
    return SqueezeNetEncoder(**kwargs)
