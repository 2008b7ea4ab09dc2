"""Resize head (counterpart of ``pytorch_toolbelt_tpu/zoo/heads/resize.py``)."""

from typing import List, Optional, Tuple

import torch
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.functional import resize_2d

__all__ = ["ResizeHead"]


class ResizeHead(nn.Module):
    """Dropout + conv on the largest feature map, then resize to
    ``output_size``.  Returns {output_name: logits} if output_name is set."""

    def __init__(
        self,
        input_spec: FeatureMapsSpec,
        num_classes: int,
        output_name: Optional[str] = None,
        kernel_size: int = 3,
        dropout_rate: float = 0.0,
        interpolation_mode: str = "bilinear",
        interpolation_align_corners: bool = False,
    ):
        super().__init__()
        self.input_spec = input_spec
        self.num_classes = num_classes
        self.output_name = output_name
        self.interpolation_mode = interpolation_mode
        self.interpolation_align_corners = interpolation_align_corners
        in_channels = input_spec.channels[input_spec.get_index_of_largest_feature_map()]
        self.dropout = nn.Dropout(dropout_rate)
        self.conv = nn.Conv2d(in_channels, num_classes, kernel_size, padding=kernel_size // 2, bias=True)

    def get_output_spec(self) -> FeatureMapsSpec:
        return FeatureMapsSpec(channels=(self.num_classes,), strides=(1,))

    def forward(self, feature_maps: List[torch.Tensor], output_size: Tuple[int, int]):
        x = feature_maps[self.input_spec.get_index_of_largest_feature_map()]
        x = self.conv(self.dropout(x))
        output = resize_2d(
            x, output_size, mode=self.interpolation_mode, align_corners=self.interpolation_align_corners
        )
        if self.output_name is not None:
            return {self.output_name: output}
        return output
