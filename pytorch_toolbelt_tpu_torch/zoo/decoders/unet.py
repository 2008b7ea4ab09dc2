"""U-Net decoder (counterpart of ``pytorch_toolbelt_tpu/zoo/decoders/unet.py``).

Coarse -> fine loop: upsample the previous output to the skip's size,
concatenate, run the stage's block(s).  Returns feature maps fine -> coarse.

``stages`` holds the blocks in creation order, coarsest stage first, which
is the order flax numbers them (``UnetBlock_0`` is the coarsest stage's).
"""

from typing import List, Sequence, Tuple, Union

import torch
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.activations import ACT_RELU
from ...nn.normalization import NORM_BATCH
from ...nn.unet import UnetBlock
from ...nn.upsample import UpsampleLayerType, instantiate_upsample_block

__all__ = ["UNetDecoder"]


class UNetDecoder(nn.Module):
    def __init__(
        self,
        input_spec: FeatureMapsSpec,
        out_channels: Sequence[int],
        block_type: str = "unet",
        upsample_block: Union[str, UpsampleLayerType] = UpsampleLayerType.BILINEAR,
        activation: str = ACT_RELU,
        normalization: str = NORM_BATCH,
        num_blocks_per_stage: Union[int, Tuple[int, ...]] = 1,
    ):
        super().__init__()
        num_stages = len(input_spec) - 1
        if len(out_channels) != num_stages:
            raise ValueError(f"out_channels must have length of {num_stages}")
        if block_type != "unet":
            raise NotImplementedError(f"block_type {block_type!r} is not ported yet")
        if isinstance(num_blocks_per_stage, int):
            num_blocks_per_stage = (num_blocks_per_stage,) * num_stages
        if len(num_blocks_per_stage) != num_stages:
            raise ValueError(f"num_blocks_per_stage must have length of {num_stages}")
        self.input_spec = input_spec
        self.out_channels = tuple(out_channels)

        stages, upsamples = [], []
        prev = input_spec.channels[-1]
        for index in range(num_stages):
            block_index = num_stages - index - 1  # coarse -> fine
            scale = input_spec.strides[block_index + 1] // input_spec.strides[block_index]
            upsamples.append(instantiate_upsample_block(upsample_block, scale_factor=scale))
            in_ch = prev + input_spec.channels[block_index]
            blocks = []
            for _ in range(num_blocks_per_stage[block_index]):
                blocks.append(
                    UnetBlock(in_ch, out_channels[block_index], activation=activation, normalization=normalization)
                )
                in_ch = out_channels[block_index]
            stages.append(nn.Sequential(*blocks))
            prev = out_channels[block_index]
        self.stages = nn.ModuleList(stages)
        self.upsamples = nn.ModuleList(upsamples)

    def get_output_spec(self) -> FeatureMapsSpec:
        return FeatureMapsSpec(channels=self.out_channels, strides=self.input_spec.strides[:-1])

    def forward(self, feature_maps: List[torch.Tensor]) -> List[torch.Tensor]:
        x = feature_maps[-1]
        outputs = []
        for index, (upsample, stage) in enumerate(zip(self.upsamples, self.stages)):
            skip = feature_maps[len(self.stages) - index - 1]
            x = upsample(x, output_size=skip.shape[2:])
            x = stage(torch.cat([x, skip], dim=1))
            outputs.append(x)
        return outputs[::-1]
