"""Pyramid Pooling Module decoder (PSPNet, arXiv:1612.01105; counterpart of
``pytorch_toolbelt_tpu/zoo/decoders/ppm.py``).

Each branch pools the coarsest map adaptively to bins x bins
(``F.adaptive_avg_pool2d``), as the JAX docstring and the reference's
``nn.AdaptiveAvgPool2d`` say.  The JAX code runs ``avg_pool`` with window
and stride ``h // bins`` instead, which is the same only where ``bins``
divides the map (ROADMAP queue 3, F10).
"""

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.activations import ACT_RELU, instantiate_activation_block
from ...nn.functional import resize_bilinear
from ...nn.normalization import BN_MOMENTUM, BatchNorm2d

__all__ = ["PPMDecoder"]


class PPMDecoder(nn.Module):
    """Pool the coarsest map at several bin sizes, project, upsample,
    concat with the input, fuse.  Single-output list at the coarsest stride.
    ``stages`` holds one (1x1 conv, norm) pair per bin size."""

    def __init__(self, input_spec: FeatureMapsSpec, out_channels: int = 512, pool_sizes: Tuple[int, ...] = (1, 2, 3, 6),
                 activation: str = ACT_RELU, dropout: float = 0.1):
        super().__init__()
        self.input_spec = input_spec
        self.out_channels = out_channels
        self.pool_sizes = tuple(pool_sizes)
        in_channels = input_spec.channels[-1]
        branch_channels = out_channels // len(self.pool_sizes)
        self.act = instantiate_activation_block(activation)
        self.stages = nn.ModuleList(
            nn.Sequential(nn.Conv2d(in_channels, branch_channels, 1, bias=False),
                          BatchNorm2d(branch_channels, momentum=BN_MOMENTUM))
            for _ in self.pool_sizes
        )
        self.fuse_conv = nn.Conv2d(in_channels + branch_channels * len(self.pool_sizes), out_channels, 3, padding=1,
                                   bias=False)
        self.fuse_bn = BatchNorm2d(out_channels, momentum=BN_MOMENTUM)
        self.dropout = nn.Dropout(dropout)

    def get_output_spec(self) -> FeatureMapsSpec:
        return FeatureMapsSpec(channels=(self.out_channels,), strides=(self.input_spec.strides[-1],))

    def forward(self, feature_maps: List[torch.Tensor]) -> List[torch.Tensor]:
        x = feature_maps[-1]
        branches = [x]
        for bins, stage in zip(self.pool_sizes, self.stages):
            pooled = self.act(stage(F.adaptive_avg_pool2d(x, bins)))
            branches.append(resize_bilinear(pooled, x.shape[2:]))
        fused = self.act(self.fuse_bn(self.fuse_conv(torch.cat(branches, dim=1))))
        return [self.dropout(fused)]
