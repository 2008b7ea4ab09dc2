"""EfficientNetV2 encoders (arXiv:2104.00298; counterpart of
``pytorch_toolbelt_tpu/zoo/encoders/efficientnet_v2.py``).

The early stages are FusedMBConv blocks (a full kxk expansion conv in place
of 1x1 + depthwise), the later ones the ``MBConv`` of ``efficientnet``.  The
stem and the kxk convs are flax ``SAME`` convs (``Conv2dSame``).
"""

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.simple import Conv2dSame
from .common import EncoderBase, _bn, _take
from .efficientnet import MBConv, _run_blocks

__all__ = [
    "EfficientNetV2Encoder",
    "FusedMBConv",
    "efficientnet_v2_l_encoder",
    "efficientnet_v2_m_encoder",
    "efficientnet_v2_s_encoder",
]


class FusedMBConv(nn.Module):
    """kxk conv (SAME, stride) to ``expand_ratio`` times the input -> BN ->
    SiLU -> 1x1 project -> BN; at ratio 1 one kxk conv -> BN -> SiLU.  Plus
    the input where the shape allows.  ``in_channels`` is new here."""

    def __init__(self, in_channels: int, out_channels: int, stride: int, expand_ratio: int, kernel_size: int = 3):
        super().__init__()
        self.use_residual = stride == 1 and in_channels == out_channels
        first = in_channels * expand_ratio if expand_ratio != 1 else out_channels
        self.conv = Conv2dSame(in_channels, first, kernel_size, stride=stride, bias=False)
        self.bn = _bn(first)
        if expand_ratio != 1:
            self.project = nn.Sequential(nn.Conv2d(first, out_channels, 1, bias=False), _bn(out_channels))
        else:
            self.project = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.silu(self.bn(self.conv(x)))
        if self.project is not None:
            y = self.project(y)
        return y + x if self.use_residual else y


# (block_type, expand, channels, num_blocks, stride): the V2-S, -M and -L tables
_V2_S = [
    ("fused", 1, 24, 2, 1),
    ("fused", 4, 48, 4, 2),
    ("fused", 4, 64, 4, 2),
    ("mb", 4, 128, 6, 2),
    ("mb", 6, 160, 9, 1),
    ("mb", 6, 256, 15, 2),
]
_V2_M = [
    ("fused", 1, 24, 3, 1),
    ("fused", 4, 48, 5, 2),
    ("fused", 4, 80, 5, 2),
    ("mb", 4, 160, 7, 2),
    ("mb", 6, 176, 14, 1),
    ("mb", 6, 304, 18, 2),
    ("mb", 6, 512, 5, 1),
]
_V2_L = [
    ("fused", 1, 32, 4, 1),
    ("fused", 4, 64, 7, 2),
    ("fused", 4, 96, 7, 2),
    ("mb", 4, 192, 10, 2),
    ("mb", 6, 224, 19, 1),
    ("mb", 6, 384, 25, 2),
    ("mb", 6, 640, 7, 1),
]


class EfficientNetV2Encoder(EncoderBase):
    """Stem (3x3 SAME stride 2 to the first stage's width, BN, SiLU) and the
    stages of the named table, or of ``config_override`` (rows of (kind,
    expand, channels, blocks, stride)); feature maps before each downsample
    and at the end.  ``in_channels`` is new here (flax infers it)."""

    def __init__(self, config_name: str = "s", config_override: Optional[Sequence[Tuple]] = None,
                 layers: Optional[Tuple[int, ...]] = None, in_channels: int = 3):
        super().__init__()
        self.config = tuple(config_override) if config_override is not None else tuple(
            {"s": _V2_S, "m": _V2_M, "l": _V2_L}[config_name])
        self.layers = None if layers is None else tuple(layers)
        prev = self.config[0][2]
        self.stem = nn.Sequential(Conv2dSame(in_channels, prev, 3, stride=2, bias=False), _bn(prev))
        self.blocks = nn.ModuleList()
        self.snapshot_before = []  # indexes of the blocks whose input is a feature map
        for kind, t, c, n, s in self.config:
            for i in range(n):
                stride = s if i == 0 else 1
                if stride == 2:
                    self.snapshot_before.append(len(self.blocks))
                block = FusedMBConv(prev, c, stride, t) if kind == "fused" else MBConv(prev, c, stride, t, 3)
                self.blocks.append(block)
                prev = c

    def get_output_spec(self) -> FeatureMapsSpec:
        channels, last = [], self.config[0][2]
        for _, _, c, _, s in self.config:
            if s == 2:
                channels.append(last)
            last = c
        channels.append(last)
        strides = (2, 4, 8, 16, 32)
        if self.layers is not None:
            channels, strides = _take(channels, self.layers), _take(strides, self.layers)
        return FeatureMapsSpec(channels, strides)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return _run_blocks(F.silu(self.stem(x)), self.blocks, self.snapshot_before, self.layers)


def efficientnet_v2_s_encoder(**kwargs) -> EfficientNetV2Encoder:
    return EfficientNetV2Encoder(config_name="s", **kwargs)


def efficientnet_v2_m_encoder(**kwargs) -> EfficientNetV2Encoder:
    return EfficientNetV2Encoder(config_name="m", **kwargs)


def efficientnet_v2_l_encoder(**kwargs) -> EfficientNetV2Encoder:
    return EfficientNetV2Encoder(config_name="l", **kwargs)
