"""FPN decoder (counterpart of ``pytorch_toolbelt_tpu/zoo/decoders/fpn.py``)."""

from typing import List, Union

import torch
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.upsample import UpsampleLayerType, instantiate_upsample_block

__all__ = ["FPNDecoder"]


class FPNDecoder(nn.Module):
    """Lateral 1x1 projections + top-down sum + per-level prediction block.

    Returns fine -> coarse maps, all with ``out_channels`` channels.
    ``lateral`` holds the 1x1 convs fine -> coarse; ``predict`` and
    ``upsamples`` hold one entry per fused level in the order they run,
    the second-coarsest level first.
    """

    def __init__(
        self,
        input_spec: FeatureMapsSpec,
        out_channels: int = 256,
        prediction_kernel: int = 3,  # 1 for conv1x1-style outputs, 0 for identity
        upsample_block: Union[str, UpsampleLayerType] = UpsampleLayerType.BILINEAR,
    ):
        super().__init__()
        self.input_spec = input_spec
        self.out_channels = out_channels
        self.lateral = nn.ModuleList(nn.Conv2d(c, out_channels, 1) for c in input_spec.channels)
        upsamples, predict = [], []
        for index in range(len(input_spec) - 2, -1, -1):
            scale = input_spec.strides[index + 1] // input_spec.strides[index]
            upsamples.append(instantiate_upsample_block(upsample_block, scale_factor=scale))
            k = prediction_kernel
            predict.append(nn.Conv2d(out_channels, out_channels, k, padding=k // 2) if k > 0 else nn.Identity())
        self.upsamples = nn.ModuleList(upsamples)
        self.predict = nn.ModuleList(predict)

    def get_output_spec(self) -> FeatureMapsSpec:
        return FeatureMapsSpec(channels=(self.out_channels,) * len(self.input_spec), strides=self.input_spec.strides)

    def forward(self, feature_maps: List[torch.Tensor]) -> List[torch.Tensor]:
        lateral_maps = [conv(fm) for conv, fm in zip(self.lateral, feature_maps)]
        outputs = [lateral_maps[-1]]
        for target, upsample, predict in zip(lateral_maps[-2::-1], self.upsamples, self.predict):
            outputs.append(predict(target + upsample(outputs[-1], output_size=target.shape[2:])))
        return outputs[::-1]
