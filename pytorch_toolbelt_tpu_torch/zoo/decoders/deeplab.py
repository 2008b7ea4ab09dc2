"""DeepLabV3 / V3+ decoders (counterpart of
``pytorch_toolbelt_tpu/zoo/decoders/deeplab.py``).

The JAX encoders have no dilated mode, so the ASPP runs on the stride-32
map where torchvision's and segmentation_models_pytorch's DeepLabV3+ run at
output stride 16; the port computes what the JAX package computes.
"""

from typing import List, Tuple

import torch
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.activations import ACT_RELU, instantiate_activation_block
from ...nn.functional import resize_bilinear
from ...nn.normalization import BN_MOMENTUM, BatchNorm2d
from ...nn.spp import ASPP

__all__ = ["DeeplabV3Decoder", "DeeplabV3PlusDecoder"]


class DeeplabV3Decoder(nn.Module):
    """ASPP over the coarsest map + conv head; single-output list
    (arXiv:1706.05587)."""

    def __init__(self, input_spec: FeatureMapsSpec, out_channels: int, aspp_channels: int = 256,
                 atrous_rates: Tuple[int, ...] = (12, 24, 36), dropout: float = 0.5, activation: str = ACT_RELU):
        super().__init__()
        self.input_spec = input_spec
        self.out_channels = out_channels
        self.aspp = ASPP(input_spec.channels[-1], aspp_channels, atrous_rates=atrous_rates, dropout=dropout,
                         activation=activation)
        self.conv = nn.Conv2d(aspp_channels, aspp_channels, 3, padding=1, bias=False)
        self.bn = BatchNorm2d(aspp_channels, momentum=BN_MOMENTUM)
        self.act = instantiate_activation_block(activation)
        self.final = nn.Conv2d(aspp_channels, out_channels, 1)

    def get_output_spec(self) -> FeatureMapsSpec:
        return FeatureMapsSpec(channels=(self.out_channels,), strides=(self.input_spec.strides[-1],))

    def forward(self, feature_maps: List[torch.Tensor]) -> List[torch.Tensor]:
        x = self.aspp(feature_maps[-1])
        return [self.final(self.act(self.bn(self.conv(x))))]


class DeeplabV3PlusDecoder(nn.Module):
    """Separable ASPP over the coarsest map, a 1x1 projection of the finest,
    the ASPP output resized to it, concatenated and fused by a 3x3 conv;
    returns [fine, coarse] maps (arXiv:1802.02611)."""

    def __init__(self, input_spec: FeatureMapsSpec, out_channels: int, aspp_channels: int = 256,
                 low_level_channels: int = 48, atrous_rates: Tuple[int, ...] = (12, 24, 36), dropout: float = 0.5,
                 activation: str = ACT_RELU):
        super().__init__()
        self.input_spec = input_spec
        self.out_channels = out_channels
        self.aspp_channels = aspp_channels
        self.act = instantiate_activation_block(activation)
        self.aspp = ASPP(input_spec.channels[-1], aspp_channels, atrous_rates=atrous_rates, dropout=dropout,
                         activation=activation, separable=True)
        self.low_conv = nn.Conv2d(input_spec.channels[0], low_level_channels, 1, bias=False)
        self.low_bn = BatchNorm2d(low_level_channels, momentum=BN_MOMENTUM)
        self.fuse_conv = nn.Conv2d(low_level_channels + aspp_channels, out_channels, 3, padding=1, bias=False)
        self.fuse_bn = BatchNorm2d(out_channels, momentum=BN_MOMENTUM)

    def get_output_spec(self) -> FeatureMapsSpec:
        return FeatureMapsSpec(channels=(self.out_channels, self.aspp_channels),
                               strides=(self.input_spec.strides[0], self.input_spec.strides[-1]))

    def forward(self, feature_maps: List[torch.Tensor]) -> List[torch.Tensor]:
        coarse = self.aspp(feature_maps[-1])
        low = self.act(self.low_bn(self.low_conv(feature_maps[0])))
        combined = torch.cat([low, resize_bilinear(coarse, low.shape[2:])], dim=1)
        fine = self.act(self.fuse_bn(self.fuse_conv(combined)))
        return [fine, coarse]
