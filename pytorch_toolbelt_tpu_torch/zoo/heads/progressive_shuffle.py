"""Progressive pixel-shuffle head (counterpart of
``pytorch_toolbelt_tpu/zoo/heads/progressive_shuffle.py``).

JAX's ``rearrange(y, "b h w (c s1 s2) -> b (h s1) (w s2) c", s1=2, s2=2)``
on NHWC is ``F.pixel_shuffle(y, 2)`` on NCHW: both take channel
c * 4 + s1 * 2 + s2 to pixel (2 h + s1, 2 w + s2) of channel c.
"""

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.activations import ACT_RELU, instantiate_activation_block
from ...nn.normalization import NORM_BATCH, Normalization

__all__ = ["ProgressiveShuffleHead"]


def _divisible(channels: float, divisor: int) -> int:
    return int(math.ceil(channels / float(divisor))) * divisor


class ProgressiveShuffleHead(nn.Module):
    """log2(stride) x [conv3x3-norm-act-conv1x1-pixel shuffle] on the
    largest map, each stage dividing the channels by ``reduction_factor``
    (rounded up to a multiple of 8), then dropout + a final 3x3 conv.
    ``stages`` holds (conv3x3, norm, conv1x1) per stage."""

    def __init__(self, input_spec: FeatureMapsSpec, num_classes: int, activation: str = ACT_RELU,
                 dropout_rate: float = 0.0, output_name: Optional[str] = None, reduction_factor: int = 2,
                 normalization: str = NORM_BATCH):
        super().__init__()
        self.input_spec = input_spec
        self.num_classes = num_classes
        self.output_name = output_name
        self.index = input_spec.get_index_of_largest_feature_map()
        in_channels = input_spec.channels[self.index]
        self.act = instantiate_activation_block(activation)
        stages = []
        for _ in range(int(math.log2(input_spec.strides[self.index]))):
            out_channels = _divisible(in_channels / reduction_factor, 8)
            stages.append(nn.ModuleList([nn.Conv2d(in_channels, in_channels, 3, padding=1, bias=False),
                                         Normalization(normalization, in_channels),
                                         nn.Conv2d(in_channels, out_channels * 4, 1, bias=False)]))
            in_channels = out_channels
        self.stages = nn.ModuleList(stages)
        self.dropout = nn.Dropout(dropout_rate)
        self.final = nn.Conv2d(in_channels, num_classes, 3, padding=1)

    def get_output_spec(self) -> FeatureMapsSpec:
        return FeatureMapsSpec(channels=(self.num_classes,), strides=(1,))

    def forward(self, feature_maps: List[torch.Tensor], output_size=None):
        x = feature_maps[self.index]
        for conv, norm, expand in self.stages:
            x = F.pixel_shuffle(expand(self.act(norm(conv(x)))), 2)
        output = self.final(self.dropout(x))
        if self.output_name is not None:
            return {self.output_name: output}
        return output
