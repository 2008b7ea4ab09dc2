"""Context Aggregation Network decoder (counterpart of
``pytorch_toolbelt_tpu/zoo/decoders/can.py``).  The blocks take their input
channels, which flax infers."""

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.dsconv import DepthwiseSeparableConv2d
from ...nn.functional import resize_bilinear
from ...nn.normalization import BN_MOMENTUM, BatchNorm2d

__all__ = ["AMM", "CANDecoder", "CFM", "RCM"]


class RCM(nn.Module):
    """Residual context module: 1x1 projection + conv-bn-relu-conv residual."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.project = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.conv1 = nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        self.bn = BatchNorm2d(out_channels, momentum=BN_MOMENTUM)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.project(x)
        return self.conv2(F.relu(self.bn(self.conv1(x)))) + x


class CFM(nn.Module):
    """Context fusion: for each kernel size, two depthwise-separable convs
    with batch norms (ReLU between), and a global-pooling branch (1x1 conv +
    norm, broadcast over the map), concatenated."""

    def __init__(self, in_channels: int, out_channels: int, kernel_sizes: Tuple[int, ...] = (3, 5, 7, 11)):
        super().__init__()
        self.gp_conv = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.gp_bn = BatchNorm2d(out_channels, momentum=BN_MOMENTUM)
        self.branches = nn.ModuleList(
            nn.Sequential(
                DepthwiseSeparableConv2d(in_channels, out_channels, kernel_size=ks, bias=False),
                BatchNorm2d(out_channels, momentum=BN_MOMENTUM),
                nn.ReLU(),
                DepthwiseSeparableConv2d(out_channels, out_channels, kernel_size=ks, bias=False),
                BatchNorm2d(out_channels, momentum=BN_MOMENTUM),
            )
            for ks in kernel_sizes
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gp = self.gp_bn(self.gp_conv(x.mean(dim=(2, 3), keepdim=True)))
        return torch.cat([branch(x) for branch in self.branches] + [gp.expand(-1, -1, x.shape[2], x.shape[3])], dim=1)


class AMM(nn.Module):
    """Attention mixing: upsample the decoder map, concat with the encoder
    map, depthwise-separable conv + bn + relu, gate by its global average,
    residual add to the encoder map."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = DepthwiseSeparableConv2d(in_channels, out_channels, kernel_size=3, bias=False)
        self.bn = BatchNorm2d(out_channels, momentum=BN_MOMENTUM)

    def forward(self, encoder: torch.Tensor, decoder: torch.Tensor) -> torch.Tensor:
        decoder = resize_bilinear(decoder, encoder.shape[2:])
        x = F.relu(self.bn(self.conv(torch.cat([encoder, decoder], dim=1))))
        return encoder + x.mean(dim=(2, 3), keepdim=True) * x


class CANDecoder(nn.Module):
    """Context Aggregation Network: RCM projections, CFM center, AMM + RCM
    top-down refinement.  Returns fine -> coarse maps.  The modules are
    registered in flax's creation order: one RCM per input map, the CFM and
    its RCM, then (AMM, RCM) per refinement step, coarse to fine."""

    def __init__(self, input_spec: FeatureMapsSpec, out_channels: int = 256):
        super().__init__()
        self.input_spec = input_spec
        self.out_channels = out_channels
        self.rcm_in = nn.ModuleList(RCM(c, out_channels) for c in input_spec.channels)
        self.cfm = CFM(out_channels, out_channels)
        self.rcm_center = RCM(out_channels * (len(self.cfm.branches) + 1), out_channels)
        self.refine = nn.ModuleList(
            nn.ModuleList([AMM(2 * out_channels, out_channels), RCM(out_channels, out_channels)])
            for _ in range(len(input_spec) - 1)
        )

    def get_output_spec(self) -> FeatureMapsSpec:
        return FeatureMapsSpec(channels=(self.out_channels,) * len(self.input_spec), strides=self.input_spec.strides)

    def forward(self, feature_maps: List[torch.Tensor]) -> List[torch.Tensor]:
        features = [rcm(fm) for rcm, fm in zip(self.rcm_in, feature_maps)]
        x = self.rcm_center(self.cfm(features[-1]))
        outputs = [x]
        for (amm, rcm), encoder in zip(self.refine, features[-2::-1]):
            x = rcm(amm(encoder, x))
            outputs.append(x)
        return outputs[::-1]
