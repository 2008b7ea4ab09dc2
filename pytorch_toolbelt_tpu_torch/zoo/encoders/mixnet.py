"""MixNet encoders (arXiv:1907.09595; counterpart of
``pytorch_toolbelt_tpu/zoo/encoders/mixnet.py``).

``MixConv`` splits the channels into groups, each convolved depthwise with
its own kernel size (3/5/7/9), inside an MBConv-style block.  The first
group takes the remainder of the split.  The stem and the depthwise convs
are flax ``SAME`` convs (``Conv2dSame``).
"""

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.simple import Conv2dSame
from .common import EncoderBase, _bn, _take
from .efficientnet import _run_blocks, _squeeze_excite

__all__ = ["MixBlock", "MixConv", "MixNetEncoder", "mixnet_m_encoder", "mixnet_s_encoder", "mixnet_xl_encoder"]


class MixConv(nn.Module):
    """Depthwise conv with one kernel size per channel group.  ``channels``
    is new here (flax infers it)."""

    def __init__(self, channels: int, kernel_sizes: Sequence[int], stride: int = 1):
        super().__init__()
        split = [channels // len(kernel_sizes)] * len(kernel_sizes)
        split[0] += channels - sum(split)
        self.split = split
        self.convs = nn.ModuleList(Conv2dSame(c, c, k, stride=stride, groups=c, bias=False)
                                   for k, c in zip(kernel_sizes, split))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([conv(part) for conv, part in zip(self.convs, torch.split(x, self.split, dim=1))], dim=1)


class MixBlock(nn.Module):
    """[1x1 expand -> BN -> SiLU] -> MixConv -> BN -> SiLU -> [SE] -> 1x1
    project -> BN, plus the input where the shape allows.  ``in_channels``
    is new here."""

    def __init__(self, in_channels: int, out_channels: int, stride: int, expand_ratio: int,
                 kernel_sizes: Sequence[int] = (3, 5, 7), use_se: bool = True, se_ratio: float = 0.25):
        super().__init__()
        hidden = in_channels * expand_ratio
        self.use_residual = stride == 1 and in_channels == out_channels
        if expand_ratio != 1:
            self.expand = nn.Sequential(nn.Conv2d(in_channels, hidden, 1, bias=False), _bn(hidden))
        else:
            self.expand = None
        self.mixconv = MixConv(hidden, kernel_sizes, stride)
        self.bn = _bn(hidden)
        if use_se:
            squeezed = max(1, int(in_channels * se_ratio))
            self.se_reduce = nn.Conv2d(hidden, squeezed, 1)
            self.se_expand = nn.Conv2d(squeezed, hidden, 1)
        else:
            self.se_reduce = self.se_expand = None
        self.project = nn.Conv2d(hidden, out_channels, 1, bias=False)
        self.project_bn = _bn(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x if self.expand is None else F.silu(self.expand(x))
        y = F.silu(self.bn(self.mixconv(y)))
        if self.se_reduce is not None:
            y = _squeeze_excite(y, self.se_reduce, self.se_expand)
        y = self.project_bn(self.project(y))
        return y + x if self.use_residual else y


# (expand, channels, blocks, stride, kernel_sizes): a MixNet-S-like baseline
_S_CONFIG = [
    (1, 16, 1, 1, (3,)),
    (6, 24, 2, 2, (3,)),
    (6, 40, 3, 2, (3, 5, 7)),
    (6, 80, 3, 2, (3, 5, 7)),
    (6, 120, 3, 1, (3, 5, 7, 9)),
    (6, 200, 3, 2, (3, 5, 7, 9)),
]


class MixNetEncoder(EncoderBase):
    """Stem (3x3 SAME stride 2, BN, SiLU) and the scaled MixNet-S stages;
    feature maps before each downsample and at the end: strides 2, 4, 8, 16,
    32.  ``in_channels`` is new here (flax infers it)."""

    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0, stem_channels: int = 16,
                 layers: Optional[Tuple[int, ...]] = None, in_channels: int = 3):
        super().__init__()
        self.width_mult = width_mult
        self.layers = None if layers is None else tuple(layers)
        prev = self._c(stem_channels)
        self.stem = nn.Sequential(Conv2dSame(in_channels, prev, 3, stride=2, bias=False), _bn(prev))
        self.blocks = nn.ModuleList()
        self.snapshot_before = []  # indexes of the blocks whose input is a feature map
        for t, c, n, s, ks in _S_CONFIG:
            for i in range(int(math.ceil(n * depth_mult))):
                stride = s if i == 0 else 1
                if stride == 2:
                    self.snapshot_before.append(len(self.blocks))
                self.blocks.append(MixBlock(prev, self._c(c), stride, t, ks))
                prev = self._c(c)

    def _c(self, c: float) -> int:
        return max(8, int(c * self.width_mult + 4) // 8 * 8)

    def get_output_spec(self) -> FeatureMapsSpec:
        channels, last = [], self._c(_S_CONFIG[0][1])
        for _, c, _, s, _ in _S_CONFIG:
            if s == 2:
                channels.append(last)
            last = self._c(c)
        channels.append(last)
        strides = (2, 4, 8, 16, 32)
        if self.layers is not None:
            channels, strides = _take(channels, self.layers), _take(strides, self.layers)
        return FeatureMapsSpec(channels, strides)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return _run_blocks(F.silu(self.stem(x)), self.blocks, self.snapshot_before, self.layers)


def mixnet_s_encoder(**kwargs) -> MixNetEncoder:
    return MixNetEncoder(width_mult=1.0, **kwargs)


def mixnet_m_encoder(**kwargs) -> MixNetEncoder:
    return MixNetEncoder(width_mult=1.2, **kwargs)


def mixnet_xl_encoder(**kwargs) -> MixNetEncoder:
    return MixNetEncoder(width_mult=1.6, depth_mult=1.2, **kwargs)
