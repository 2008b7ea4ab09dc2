"""U-Net conv block (counterpart of ``pytorch_toolbelt_tpu/nn/unet.py``).

``UnetResidualBlock`` needs ``DropPath`` and is not ported yet.
"""

import torch
from torch import nn

from .activations import ACT_RELU, instantiate_activation_block
from .normalization import NORM_BATCH, Normalization

__all__ = ["UnetBlock"]


class UnetBlock(nn.Module):
    """Two 3x3 convs, each followed by norm + activation."""

    def __init__(self, in_channels: int, out_channels: int, activation: str = ACT_RELU,
                 normalization: str = NORM_BATCH):
        super().__init__()
        self.out_channels = out_channels
        self.activation = activation
        self.normalization = normalization
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.norm1 = Normalization(normalization, out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        self.norm2 = Normalization(normalization, out_channels)
        self.act = instantiate_activation_block(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(self.norm1(self.conv1(x)))
        return self.act(self.norm2(self.conv2(x)))
