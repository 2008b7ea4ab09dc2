"""Deep supervision head (counterpart of
``pytorch_toolbelt_tpu/zoo/heads/deep_supervision.py``)."""

from typing import List, Optional

import torch
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...datasets.common import name_for_stride

__all__ = ["DeepSupervisionHead"]


class DeepSupervisionHead(nn.Module):
    """A 1x1 conv per level; a dict keyed by ``name_for_stride`` when
    ``output_name_prefix`` is set, otherwise a list."""

    def __init__(self, input_spec: FeatureMapsSpec, num_classes: int, output_name_prefix: Optional[str] = None):
        super().__init__()
        self.input_spec = input_spec
        self.num_classes = num_classes
        self.output_name_prefix = output_name_prefix
        self.convs = nn.ModuleList(nn.Conv2d(c, num_classes, 1) for c in input_spec.channels)

    def get_output_spec(self) -> FeatureMapsSpec:
        return FeatureMapsSpec(channels=(self.num_classes,) * len(self.input_spec), strides=self.input_spec.strides)

    def forward(self, feature_maps: List[torch.Tensor], output_size=None):
        outputs = [conv(fm) for conv, fm in zip(self.convs, feature_maps)]
        if self.output_name_prefix is None:
            return outputs
        return {name_for_stride(self.output_name_prefix, stride): out
                for out, stride in zip(outputs, self.input_spec.strides)}
