"""Vanilla U-Net encoder (counterpart of ``pytorch_toolbelt_tpu/zoo/encoders/unet.py``)."""

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.activations import ACT_RELU
from ...nn.normalization import NORM_BATCH
from ...nn.unet import UnetBlock
from .common import EncoderBase

__all__ = ["UnetEncoder"]


class UnetEncoder(EncoderBase):
    """Double-conv downsampling stack with a channel growth factor.

    ``residual=True`` needs ``UnetResidualBlock``, which is not ported yet.
    """

    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 32,
        num_layers: int = 4,
        growth_factor: int = 2,
        activation: str = ACT_RELU,
        normalization: str = NORM_BATCH,
        residual: bool = False,
        pool: str = "max",
    ):
        super().__init__()
        if residual:
            raise NotImplementedError("UnetEncoder(residual=True) needs UnetResidualBlock, not ported yet")
        if pool not in ("max", "avg"):
            raise ValueError(f"pool must be 'max' or 'avg', got {pool!r}")
        self.out_channels = out_channels
        self.num_layers = num_layers
        self.growth_factor = growth_factor
        self.pool = pool
        blocks = []
        prev = in_channels
        for ch in self.feature_channels():
            blocks.append(UnetBlock(prev, ch, activation=activation, normalization=normalization))
            prev = ch
        self.blocks = nn.ModuleList(blocks)

    def feature_channels(self) -> Tuple[int, ...]:
        return tuple(self.out_channels * (self.growth_factor**i) for i in range(self.num_layers))

    def get_output_spec(self) -> FeatureMapsSpec:
        return FeatureMapsSpec(
            channels=self.feature_channels(),
            strides=tuple(2**i for i in range(self.num_layers)),
        )

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        pool = F.max_pool2d if self.pool == "max" else F.avg_pool2d
        outputs = []
        for layer, block in enumerate(self.blocks):
            if layer > 0:
                x = pool(x, 2)
            x = block(x)
            outputs.append(x)
        return outputs
