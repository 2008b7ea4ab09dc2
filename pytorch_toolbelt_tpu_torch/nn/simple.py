"""Conv factories and Identity (counterpart of ``pytorch_toolbelt_tpu/nn/simple.py``),
and ``Conv2dSame``, flax's ``padding="SAME"`` for a torch conv."""

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Conv2dSame", "Identity", "conv1x1", "conv3x3"]


class Identity(nn.Module):
    """Pass-through module; accepts and ignores extra arguments."""

    def forward(self, x, *args, **kwargs):
        return x


def _same_padding(size: int, kernel: int, stride: int = 1, dilation: int = 1) -> Tuple[int, int]:
    """(low, high) padding of one axis under flax/XLA ``SAME``: the output has
    ceil(size / stride) samples and the low side gets the smaller half.  At
    stride 2 an even input is padded (0, 1) where torch's usual
    ``padding=k // 2`` pads (1, 1)."""
    total = max((math.ceil(size / stride) - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Conv2d):
    """``nn.Conv2d`` padded as flax's ``padding="SAME"``, from the input's size
    at each call.  Where the padding is symmetric it is the conv's own; else
    the input is padded first."""

    def __init__(self, *args, **kwargs):
        if kwargs.pop("padding", 0) != 0:
            raise ValueError("Conv2dSame computes its own padding")
        super().__init__(*args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (top, bottom), (left, right) = (
            _same_padding(x.shape[2 + i], self.kernel_size[i], self.stride[i], self.dilation[i]) for i in range(2)
        )
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, self.bias, self.stride, (top, left), self.dilation, self.groups)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, self.dilation, self.groups)


def _zero_bias(conv: nn.Conv2d) -> nn.Conv2d:
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)
    return conv


def conv1x1(in_channels: int, out_channels: int, groups: int = 1, bias: bool = True) -> nn.Conv2d:
    """1x1 conv with a zero-initialised bias, as flax initialises it."""
    return _zero_bias(nn.Conv2d(in_channels, out_channels, 1, groups=groups, bias=bias))


def conv3x3(in_channels: int, out_channels: int, stride: int = 1, groups: int = 1, bias: bool = True) -> nn.Conv2d:
    """3x3 SAME conv with a zero-initialised bias."""
    return _zero_bias(Conv2dSame(in_channels, out_channels, 3, stride=stride, groups=groups, bias=bias))
