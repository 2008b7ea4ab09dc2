"""EfficientNet B0-B7 encoders (arXiv:1905.11946; counterpart of
``pytorch_toolbelt_tpu/zoo/encoders/efficientnet.py``): MBConv blocks with
SiLU and an SE gate whose width is a quarter of the block's input.

The stem and the depthwise convs are flax ``SAME`` convs (``Conv2dSame``):
at stride 2 an even input pads (0, 1) for a 3x3 and (1, 2) for a 5x5.
BatchNorm uses momentum 0.01, flax's default of 0.99 in torch's convention.
"""

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.simple import Conv2dSame
from .common import EncoderBase, _bn, _take

__all__ = [
    "EfficientNetEncoder",
    "MBConv",
    "efficientnet_b0_encoder",
    "efficientnet_b1_encoder",
    "efficientnet_b2_encoder",
    "efficientnet_b3_encoder",
    "efficientnet_b4_encoder",
    "efficientnet_b5_encoder",
    "efficientnet_b6_encoder",
    "efficientnet_b7_encoder",
]

# (expand, channels, num_blocks, stride, kernel): the EfficientNet-B0 baseline
_B0_CONFIG = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]

# (width_mult, depth_mult)
_SCALING = {
    "b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2), "b3": (1.2, 1.4),
    "b4": (1.4, 1.8), "b5": (1.6, 2.2), "b6": (1.8, 2.6), "b7": (2.0, 3.1),
}


def _round_channels(c: float, width_mult: float, divisor: int = 8) -> int:
    c *= width_mult
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return int(new_c)


def _round_repeats(r: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * r))


def _squeeze_excite(x: torch.Tensor, reduce: nn.Conv2d, expand: nn.Conv2d, act=F.silu, gate=torch.sigmoid):
    """``x * gate(expand(act(reduce(mean of x over space))))``; the two 1x1
    convs are the calling block's own children, as in flax."""
    return x * gate(expand(act(reduce(x.mean(dim=(2, 3), keepdim=True)))))


class MBConv(nn.Module):
    """[1x1 expand -> BN -> SiLU] -> kxk depthwise (SAME, stride) -> BN ->
    SiLU -> SE -> 1x1 project -> BN, plus the input where the shape allows.
    ``in_channels`` is new here (flax infers it).  Children in flax's
    creation order: Conv_0..4 (expand, depthwise, SE reduce, SE expand,
    project; no expand at ratio 1) and BatchNorm_0..2."""

    def __init__(self, in_channels: int, out_channels: int, stride: int, expand_ratio: int, kernel_size: int,
                 se_ratio: float = 0.25):
        super().__init__()
        hidden = in_channels * expand_ratio
        self.use_residual = stride == 1 and in_channels == out_channels
        if expand_ratio != 1:
            self.expand = nn.Sequential(nn.Conv2d(in_channels, hidden, 1, bias=False), _bn(hidden))
        else:
            self.expand = None
        self.depthwise = Conv2dSame(hidden, hidden, kernel_size, stride=stride, groups=hidden, bias=False)
        self.bn = _bn(hidden)
        squeezed = max(1, int(in_channels * se_ratio))
        self.se_reduce = nn.Conv2d(hidden, squeezed, 1)
        self.se_expand = nn.Conv2d(squeezed, hidden, 1)
        self.project = nn.Conv2d(hidden, out_channels, 1, bias=False)
        self.project_bn = _bn(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x if self.expand is None else F.silu(self.expand(x))
        y = _squeeze_excite(F.silu(self.bn(self.depthwise(y))), self.se_reduce, self.se_expand)
        y = self.project_bn(self.project(y))
        return y + x if self.use_residual else y


class EfficientNetEncoder(EncoderBase):
    """Stem (3x3 SAME stride 2, BN, SiLU) and the scaled B0 stages; feature
    maps before each downsample and at the end: strides 2, 4, 8, 16, 32.
    ``in_channels`` is new here (flax infers it)."""

    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0, layers: Optional[Tuple[int, ...]] = None,
                 in_channels: int = 3):
        super().__init__()
        self.width_mult = width_mult
        self.layers = None if layers is None else tuple(layers)
        stem = _round_channels(32, width_mult)
        self.stem = nn.Sequential(Conv2dSame(in_channels, stem, 3, stride=2, bias=False), _bn(stem))
        self.blocks = nn.ModuleList()
        self.snapshot_before = []  # indexes of the blocks whose input is a feature map
        prev = stem
        for t, c, n, s, k in _B0_CONFIG:
            out = _round_channels(c, width_mult)
            for i in range(_round_repeats(n, depth_mult)):
                stride = s if i == 0 else 1
                if stride == 2:
                    self.snapshot_before.append(len(self.blocks))
                self.blocks.append(MBConv(prev, out, stride, t, k))
                prev = out

    def get_output_spec(self) -> FeatureMapsSpec:
        w = self.width_mult
        channels = tuple(_round_channels(c, w) for c in (16, 24, 40, 112, 320))
        strides = (2, 4, 8, 16, 32)
        if self.layers is not None:
            channels, strides = _take(channels, self.layers), _take(strides, self.layers)
        return FeatureMapsSpec(channels, strides)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return _run_blocks(F.silu(self.stem(x)), self.blocks, self.snapshot_before, self.layers)


def _run_blocks(x: torch.Tensor, blocks, snapshot_before, layers) -> List[torch.Tensor]:
    """Run ``blocks`` in turn; the input of each block listed in
    ``snapshot_before`` and the last output are the feature maps."""
    outputs = []
    for i, block in enumerate(blocks):
        if i in snapshot_before:
            outputs.append(x)
        x = block(x)
    outputs.append(x)
    return outputs if layers is None else _take(outputs, layers)


def _make(scale: str, **kwargs) -> EfficientNetEncoder:
    w, d = _SCALING[scale]
    return EfficientNetEncoder(width_mult=w, depth_mult=d, **kwargs)


def efficientnet_b0_encoder(**kwargs) -> EfficientNetEncoder:
    return _make("b0", **kwargs)


def efficientnet_b1_encoder(**kwargs) -> EfficientNetEncoder:
    return _make("b1", **kwargs)


def efficientnet_b2_encoder(**kwargs) -> EfficientNetEncoder:
    return _make("b2", **kwargs)


def efficientnet_b3_encoder(**kwargs) -> EfficientNetEncoder:
    return _make("b3", **kwargs)


def efficientnet_b4_encoder(**kwargs) -> EfficientNetEncoder:
    return _make("b4", **kwargs)


def efficientnet_b5_encoder(**kwargs) -> EfficientNetEncoder:
    return _make("b5", **kwargs)


def efficientnet_b6_encoder(**kwargs) -> EfficientNetEncoder:
    return _make("b6", **kwargs)


def efficientnet_b7_encoder(**kwargs) -> EfficientNetEncoder:
    return _make("b7", **kwargs)
