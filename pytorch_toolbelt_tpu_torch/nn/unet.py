"""U-Net conv blocks (counterpart of ``pytorch_toolbelt_tpu/nn/unet.py``).

Each block creates one activation and applies it at every place; with
``prelu`` that is one registered module, so every use shares its weight,
as flax's uses share one ``PReLU_0/alpha``.
"""

import torch
from torch import nn

from .activations import ACT_RELU, instantiate_activation_block
from .drop_path import DropPath
from .normalization import NORM_BATCH, Normalization

__all__ = ["UnetBlock", "UnetResidualBlock"]


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


class UnetResidualBlock(nn.Module):
    """act(norm(conv3x3(act(norm(conv3x3(x))))) + shortcut(x)), the branch
    through ``DropPath`` when ``drop_path_rate > 0``.  The shortcut is a 1x1
    conv where the channels change, else the identity."""

    def __init__(self, in_channels: int, out_channels: int, activation: str = ACT_RELU,
                 normalization: str = NORM_BATCH, drop_path_rate: float = 0.0):
        super().__init__()
        self.out_channels = out_channels
        self.activation = activation
        self.normalization = normalization
        self.shortcut = (nn.Conv2d(in_channels, out_channels, 1, bias=False)
                         if in_channels != out_channels else None)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.norm1 = Normalization(normalization, out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        self.norm2 = Normalization(normalization, out_channels)
        self.drop_path = DropPath(drop_path_rate) if drop_path_rate > 0.0 else None
        self.act = instantiate_activation_block(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.shortcut is None else self.shortcut(x)
        y = self.act(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        if self.drop_path is not None:
            y = self.drop_path(y)
        return self.act(y + residual)
