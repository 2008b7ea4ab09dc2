"""Hypercolumn head (arXiv:1411.5752; counterpart of
``pytorch_toolbelt_tpu/zoo/heads/hypercolumn.py``)."""

from typing import List, Optional, Tuple

import torch
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.activations import ACT_RELU, instantiate_activation_block
from ...nn.fpn import FPNFuse
from ...nn.functional import resize_2d
from ...nn.normalization import NORM_BATCH, Normalization

__all__ = ["HypercolumnHead"]


class HypercolumnHead(nn.Module):
    """Concat of all maps resized to the finest -> 1x1 projection
    (conv-norm-act-dropout) -> 3x3 conv -> resize to ``output_size``."""

    def __init__(self, input_spec: FeatureMapsSpec, num_classes: int, mid_channels: int = 128,
                 activation: str = ACT_RELU, normalization: str = NORM_BATCH, output_name: Optional[str] = None,
                 dropout_rate: float = 0.0, interpolation_mode: str = "bilinear",
                 interpolation_align_corners: bool = False):
        super().__init__()
        self.input_spec = input_spec
        self.num_classes = num_classes
        self.output_name = output_name
        self.interpolation_mode = interpolation_mode
        self.interpolation_align_corners = interpolation_align_corners
        self.fuse = FPNFuse(mode=interpolation_mode, align_corners=interpolation_align_corners)
        self.project = nn.Conv2d(sum(input_spec.channels), mid_channels, 1)
        self.norm = Normalization(normalization, mid_channels)
        self.act = instantiate_activation_block(activation)
        self.dropout = nn.Dropout(dropout_rate)
        self.final = nn.Conv2d(mid_channels, num_classes, 3, padding=1)

    def get_output_spec(self) -> FeatureMapsSpec:
        return FeatureMapsSpec(channels=(self.num_classes,), strides=(1,))

    def forward(self, feature_maps: List[torch.Tensor], output_size: Tuple[int, int]):
        x = self.dropout(self.act(self.norm(self.project(self.fuse(feature_maps)))))
        output = resize_2d(self.final(x), output_size, mode=self.interpolation_mode,
                           align_corners=self.interpolation_align_corners)
        if self.output_name is not None:
            return {self.output_name: output}
        return output
