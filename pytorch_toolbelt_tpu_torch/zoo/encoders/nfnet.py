"""Normalizer-Free encoders: NFNet-F0..F7 (arXiv:2102.06171) and NF-RegNet
B0..B5 (counterpart of ``pytorch_toolbelt_tpu/zoo/encoders/nfnet.py``):
scaled weight-standardized convs, alpha / beta residual scaling and SE
gates, with no normalization layer.

Conventions kept from the JAX package:

* :class:`WSConv` standardizes its kernel at every call, over (kh, kw,
  in / groups) for each output channel, with the **population** variance:
  ``(w - mean) * rsqrt(max(var * fan_in, 1e-4)) * gain``; it pads as flax
  ``SAME`` (at stride 2 an even side pads (0, 1));
* the activation is the **tanh** GELU times gamma = 1.7015043497085571;
* a block's ``skip_gain`` is a 0-d parameter initialized to **zero**, so at
  initialization a block is its shortcut;
* a stride-2 block's shortcut is the 2x2 average pool of the pre-activated
  input, then a ``WSConv`` where the channels change; that conv is created
  first (``WSConv_0``).

The weight bridge maps a ``WSConv``'s ``kernel`` (HWIO -> OIHW), ``bias``
and ``gain``, and a block's ``skip_gain``, as they are.
"""

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.simple import _same_padding
from .common import EncoderBase, _take

__all__ = [
    "NFBlock",
    "NFNetEncoder",
    "WSConv",
    "nf_regnet_b0_encoder",
    "nf_regnet_b1_encoder",
    "nf_regnet_b2_encoder",
    "nf_regnet_b3_encoder",
    "nf_regnet_b4_encoder",
    "nf_regnet_b5_encoder",
    "nfnet_f0_encoder",
    "nfnet_f1_encoder",
    "nfnet_f2_encoder",
    "nfnet_f3_encoder",
    "nfnet_f4_encoder",
    "nfnet_f5_encoder",
    "nfnet_f6_encoder",
    "nfnet_f7_encoder",
]

_GELU_GAMMA = 1.7015043497085571  # variance-preserving gain of the GELU


def _scaled_gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh") * _GELU_GAMMA


class WSConv(nn.Module):
    """Scaled weight-standardized conv.  ``weight`` is OIHW (flax's ``kernel``
    transposed), initialized He-normal as flax's; ``bias`` zeros, ``gain``
    ones.  ``in_channels`` is new here (flax infers it)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Tuple[int, int] = (3, 3), stride: int = 1,
                 groups: int = 1):
        super().__init__()
        kh, kw = kernel_size
        self.kernel_size, self.stride, self.groups = (kh, kw), stride, groups
        self.fan_in = kh * kw * (in_channels // groups)
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels // groups, kh, kw) * math.sqrt(2.0 / self.fan_in))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.gain = nn.Parameter(torch.ones(out_channels))

    def standardized_weight(self) -> torch.Tensor:
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), keepdim=True, correction=0)
        scale = torch.rsqrt(torch.clamp(var * self.fan_in, min=1e-4)) * self.gain.reshape(-1, 1, 1, 1)
        return (w - mean) * scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (top, bottom), (left, right) = (
            _same_padding(x.shape[2 + i], self.kernel_size[i], self.stride) for i in range(2)
        )
        if top == bottom and left == right:
            return F.conv2d(x, self.standardized_weight(), self.bias, self.stride, (top, left), 1, self.groups)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.standardized_weight(), self.bias, self.stride, 0, 1, self.groups)


class NFBlock(nn.Module):
    """Pre-activation normalizer-free bottleneck: ``out = gelu(x) * beta``;
    1x1 -> gelu -> grouped 3x3 (stride) -> gelu -> grouped 3x3 -> gelu ->
    1x1, an SE gate (mean -> conv -> relu -> conv -> 2 sigmoid), and
    ``shortcut + y * skip_gain * alpha``."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1, alpha: float = 0.2, beta: float = 1.0,
                 group_size: int = 128, se_ratio: float = 0.5):
        super().__init__()
        self.stride, self.alpha, self.beta = stride, alpha, beta
        width = out_channels // 2
        groups = max(1, width // group_size)
        width = groups * group_size if width >= group_size else width
        self.shortcut = WSConv(in_channels, out_channels, (1, 1)) if in_channels != out_channels else None
        self.conv1 = WSConv(in_channels, width, (1, 1))
        self.conv2 = WSConv(width, width, (3, 3), stride=stride, groups=groups)
        self.conv3 = WSConv(width, width, (3, 3), groups=groups)
        self.conv4 = WSConv(width, out_channels, (1, 1))
        squeezed = max(1, int(out_channels * se_ratio))
        self.se_reduce = nn.Conv2d(out_channels, squeezed, 1)
        self.se_expand = nn.Conv2d(squeezed, out_channels, 1)
        self.skip_gain = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = _scaled_gelu(x) * self.beta
        shortcut = x
        if self.stride > 1:
            shortcut = F.avg_pool2d(out, 2, 2)
        if self.shortcut is not None:
            shortcut = self.shortcut(shortcut if self.stride > 1 else out)
        y = _scaled_gelu(self.conv1(out))
        y = _scaled_gelu(self.conv2(y))
        y = _scaled_gelu(self.conv3(y))
        y = self.conv4(y)
        se = self.se_expand(F.relu(self.se_reduce(y.mean(dim=(2, 3), keepdim=True))))
        y = y * torch.sigmoid(se) * 2.0
        return shortcut + y * self.skip_gain * self.alpha


class NFNetEncoder(EncoderBase):
    """Stem of four ``WSConv``s to stride 4 (16, 32, 64, 128 channels), then
    the stages; feature maps at strides 4, 4, 8, 16, 32.  beta is
    1 / sqrt(expected variance), which grows by alpha^2 a block and is reset
    after each stage's first block.  ``in_channels`` is new here."""

    def __init__(self, stage_blocks: Tuple[int, ...] = (1, 2, 6, 3),
                 stage_channels: Tuple[int, ...] = (256, 512, 1536, 1536), alpha: float = 0.2,
                 layers: Optional[Tuple[int, ...]] = None, in_channels: int = 3):
        super().__init__()
        self.stage_channels = tuple(stage_channels)
        self.layers = None if layers is None else tuple(layers)
        self.stem = nn.ModuleList([WSConv(in_channels, 16, stride=2), WSConv(16, 32), WSConv(32, 64),
                                   WSConv(64, 128, stride=2)])
        self.stages = nn.ModuleList()
        prev, expected_var = 128, 1.0
        for stage, (num_blocks, channels) in enumerate(zip(stage_blocks, self.stage_channels)):
            blocks = nn.ModuleList()
            for i in range(num_blocks):
                stride = 2 if stage > 0 and i == 0 else 1
                blocks.append(NFBlock(prev, channels, stride=stride, alpha=alpha, beta=1.0 / expected_var**0.5))
                prev = channels
                if i == 0:
                    expected_var = 1.0  # reset at the transition
                expected_var += alpha**2
            self.stages.append(blocks)

    def get_output_spec(self) -> FeatureMapsSpec:
        channels, strides = (128,) + self.stage_channels, (4, 4, 8, 16, 32)
        if self.layers is not None:
            channels, strides = _take(channels, self.layers), _take(strides, self.layers)
        return FeatureMapsSpec(channels, strides)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        for conv in self.stem[:3]:
            x = _scaled_gelu(conv(x))
        x = self.stem[3](x)
        outputs = [x]
        for blocks in self.stages:
            for block in blocks:
                x = block(x)
            outputs.append(x)
        return outputs if self.layers is None else _take(outputs, self.layers)


# NFNet F-series depths are F0's (1, 2, 6, 3) times N + 1 (arXiv:2102.06171 table 1)


def _nfnet_f(n: int, **kwargs) -> NFNetEncoder:
    return NFNetEncoder(**{**dict(stage_blocks=tuple(b * (n + 1) for b in (1, 2, 6, 3))), **kwargs})


def nfnet_f0_encoder(**kwargs) -> NFNetEncoder:
    return _nfnet_f(0, **kwargs)


def nfnet_f1_encoder(**kwargs) -> NFNetEncoder:
    return _nfnet_f(1, **kwargs)


def nfnet_f2_encoder(**kwargs) -> NFNetEncoder:
    return _nfnet_f(2, **kwargs)


def nfnet_f3_encoder(**kwargs) -> NFNetEncoder:
    return _nfnet_f(3, **kwargs)


def nfnet_f4_encoder(**kwargs) -> NFNetEncoder:
    return _nfnet_f(4, **kwargs)


def nfnet_f5_encoder(**kwargs) -> NFNetEncoder:
    return _nfnet_f(5, **kwargs)


def nfnet_f6_encoder(**kwargs) -> NFNetEncoder:
    return _nfnet_f(6, **kwargs)


def nfnet_f7_encoder(**kwargs) -> NFNetEncoder:
    return _nfnet_f(7, **kwargs)


# NF-RegNet B-series: timm's nf_regnet_b0..b5 depth and width progression


def _nf_regnet(stage_blocks, stage_channels, **kwargs) -> NFNetEncoder:
    return NFNetEncoder(**{**dict(stage_blocks=stage_blocks, stage_channels=stage_channels), **kwargs})


def nf_regnet_b0_encoder(**kwargs) -> NFNetEncoder:
    return _nf_regnet((1, 3, 6, 6), (48, 104, 208, 440), **kwargs)


def nf_regnet_b1_encoder(**kwargs) -> NFNetEncoder:
    return _nf_regnet((2, 4, 7, 7), (48, 104, 208, 440), **kwargs)


def nf_regnet_b2_encoder(**kwargs) -> NFNetEncoder:
    return _nf_regnet((2, 4, 8, 8), (56, 112, 232, 488), **kwargs)


def nf_regnet_b3_encoder(**kwargs) -> NFNetEncoder:
    return _nf_regnet((2, 5, 9, 9), (56, 128, 248, 528), **kwargs)


def nf_regnet_b4_encoder(**kwargs) -> NFNetEncoder:
    return _nf_regnet((2, 6, 11, 11), (64, 144, 288, 610), **kwargs)


def nf_regnet_b5_encoder(**kwargs) -> NFNetEncoder:
    return _nf_regnet((3, 7, 14, 14), (80, 168, 336, 704), **kwargs)
