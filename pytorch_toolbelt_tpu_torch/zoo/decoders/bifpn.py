"""BiFPN decoder (arXiv:1911.09070; counterpart of
``pytorch_toolbelt_tpu/zoo/decoders/bifpn.py``).  The fusion weights ``w1``
[2, k] and ``w2`` [3, k] are raw parameters, put through ReLU and
normalized over their first axis (+ epsilon) at each call."""

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.activations import ACT_RELU, instantiate_activation_block
from ...nn.dsconv import DepthwiseSeparableConv2d
from ...nn.functional import resize_nearest
from ...nn.normalization import NORM_BATCH, Normalization

__all__ = ["BiFPNBlock", "BiFPNConvBlock", "BiFPNDecoder"]


class BiFPNConvBlock(nn.Module):
    """conv (3x3, or depthwise-separable) -> norm -> activation."""

    def __init__(self, in_channels: int, out_channels: int, activation: str = ACT_RELU,
                 normalization: str = NORM_BATCH, separable: bool = False):
        super().__init__()
        if separable:
            self.conv = DepthwiseSeparableConv2d(in_channels, out_channels, kernel_size=3, bias=False)
        else:
            self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.norm = Normalization(normalization, out_channels)
        self.act = instantiate_activation_block(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(self.conv(x)))


class BiFPNBlock(nn.Module):
    """One BiFPN layer: a top-down pathway, then a bottom-up one, with
    learned fusion weights.  ``blocks`` holds the top-down conv blocks
    (second-coarsest level first), then the bottom-up ones."""

    def __init__(self, feature_size: int, num_feature_maps: int, epsilon: float = 1e-4, activation: str = ACT_RELU,
                 normalization: str = NORM_BATCH, separable: bool = False):
        super().__init__()
        self.epsilon = epsilon
        num_blocks = num_feature_maps - 1
        self.w1 = nn.Parameter(torch.ones(2, num_blocks))
        self.w2 = nn.Parameter(torch.ones(3, num_blocks))
        self.blocks = nn.ModuleList(
            BiFPNConvBlock(feature_size, feature_size, activation, normalization, separable)
            for _ in range(2 * num_blocks)
        )

    def forward(self, inputs: List[torch.Tensor]) -> List[torch.Tensor]:
        num_blocks = len(inputs) - 1
        w1 = F.relu(self.w1)
        w1 = w1 / (w1.sum(dim=0) + self.epsilon)
        w2 = F.relu(self.w2)
        w2 = w2 / (w2.sum(dim=0) + self.epsilon)

        # top-down: coarse -> fine
        features = [inputs[-1]]
        for i, x in enumerate(inputs[-2::-1]):
            up = resize_nearest(features[-1], x.shape[2:])
            features.append(self.blocks[i](w1[0, i] * x + w1[1, i] * up))

        # bottom-up: fine -> coarse; outputs come out fine -> coarse
        outputs = [features[-1]]
        transition_reversed = features[:-1][::-1]
        for i in range(num_blocks):
            x = inputs[i + 1]
            down = resize_nearest(outputs[-1], x.shape[2:])
            fused = x * w2[0, i] + transition_reversed[i] * w2[1, i] + down * w2[2, i]
            outputs.append(self.blocks[num_blocks + i](fused))
        return outputs


class BiFPNDecoder(nn.Module):
    """Input 1x1 projections + stacked BiFPN blocks.  It does not
    synthesize extra p6/p7 levels, so it takes any number of input maps."""

    def __init__(self, input_spec: FeatureMapsSpec, out_channels: int = 128, num_layers: int = 2,
                 activation: str = ACT_RELU, normalization: str = NORM_BATCH, separable: bool = False):
        super().__init__()
        self.input_spec = input_spec
        self.out_channels = out_channels
        self.lateral = nn.ModuleList(nn.Conv2d(c, out_channels, 1) for c in input_spec.channels)
        self.layers = nn.ModuleList(
            BiFPNBlock(out_channels, len(input_spec), activation=activation, normalization=normalization,
                       separable=separable)
            for _ in range(num_layers)
        )

    def get_output_spec(self) -> FeatureMapsSpec:
        return FeatureMapsSpec(channels=(self.out_channels,) * len(self.input_spec), strides=self.input_spec.strides)

    def forward(self, feature_maps: List[torch.Tensor]) -> List[torch.Tensor]:
        features = [conv(fm) for conv, fm in zip(self.lateral, feature_maps)]
        for layer in self.layers:
            features = layer(features)
        return features
