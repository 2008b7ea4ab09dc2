"""MobileNet V2 / V3 encoders (counterpart of
``pytorch_toolbelt_tpu/zoo/encoders/mobilenet.py``).

Unlike the EfficientNet family, the inverted residuals and the stems pad
symmetrically, (k - 1) / 2 on each side (torch's convention, as the JAX
package does on purpose): at stride 2 that differs from flax ``SAME``, so
these are plain ``nn.Conv2d``.  BatchNorm uses momentum 0.01, flax's
default of 0.99 in torch's convention.
"""

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.activations import get_activation_fn, hard_sigmoid, hard_swish
from .common import EncoderBase, _bn, _take
from .efficientnet import _run_blocks, _squeeze_excite

__all__ = [
    "InvertedResidual",
    "MobileNetV2Encoder",
    "MobileNetV3Encoder",
    "mobilenet_v3_large_encoder",
    "mobilenet_v3_small_encoder",
]


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class InvertedResidual(nn.Module):
    """[1x1 expand -> BN -> act] -> kxk depthwise (symmetric padding, stride)
    -> BN -> act -> [SE: relu, hard-sigmoid gate] -> 1x1 project -> BN, plus
    the input where the shape allows.  ``act`` is hard-swish with ``use_hs``,
    else relu6, unless ``activation`` names one.  The hidden width is
    ``_make_divisible(in * expand_ratio)``, or ``round(in * expand_ratio)``
    without ``divisible_hidden`` (the reference's vendored V2).
    ``in_channels`` is new here (flax infers it)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int, expand_ratio: float, kernel_size: int = 3,
                 use_se: bool = False, use_hs: bool = False, divisible_hidden: bool = True,
                 activation: Optional[str] = None):
        super().__init__()
        if divisible_hidden:
            hidden = _make_divisible(in_channels * expand_ratio)
        else:
            hidden = int(round(in_channels * expand_ratio))
        if activation is not None:
            self.act = get_activation_fn(activation)
        else:
            self.act = hard_swish if use_hs else F.relu6
        self.use_residual = stride == 1 and in_channels == out_channels
        if expand_ratio != 1:
            self.expand = nn.Sequential(nn.Conv2d(in_channels, hidden, 1, bias=False), _bn(hidden))
        else:
            self.expand = None
        self.depthwise = nn.Conv2d(hidden, hidden, kernel_size, stride=stride, padding=(kernel_size - 1) // 2,
                                   groups=hidden, bias=False)
        self.bn = _bn(hidden)
        if use_se:
            squeezed = _make_divisible(hidden // 4)
            self.se_reduce = nn.Conv2d(hidden, squeezed, 1)
            self.se_expand = nn.Conv2d(squeezed, hidden, 1)
        else:
            self.se_reduce = self.se_expand = None
        self.project = nn.Conv2d(hidden, out_channels, 1, bias=False)
        self.project_bn = _bn(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x if self.expand is None else self.act(self.expand(x))
        y = self.act(self.bn(self.depthwise(y)))
        if self.se_reduce is not None:
            y = _squeeze_excite(y, self.se_reduce, self.se_expand, act=F.relu, gate=hard_sigmoid)
        y = self.project_bn(self.project(y))
        return y + x if self.use_residual else y


# (expand_ratio, channels, num_blocks, stride): MobileNetV2 paper, table 2
_V2_CONFIG = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


class MobileNetV2Encoder(EncoderBase):
    """MobileNetV2 (arXiv:1801.04381); feature maps at strides 2, 4, 8, 16,
    32.  Channels round as the reference's vendored backbone does
    (``int(c * width_mult)`` stages, ``round(in * t)`` hidden widths), and
    ``activation`` replaces relu6 everywhere.  ``in_channels`` is new here
    (flax infers it)."""

    def __init__(self, width_mult: float = 1.0, layers: Optional[Tuple[int, ...]] = None, activation: str = "relu6",
                 in_channels: int = 3):
        super().__init__()
        self.width_mult = width_mult
        self.layers = None if layers is None else tuple(layers)
        self.act = get_activation_fn(activation)
        prev = int(32 * width_mult)
        self.stem = nn.Sequential(nn.Conv2d(in_channels, prev, 3, stride=2, padding=1, bias=False), _bn(prev))
        self.blocks = nn.ModuleList()
        self.snapshot_before = []  # indexes of the blocks whose input is a feature map
        current_stride = 2
        for t, c, n, s in _V2_CONFIG:
            for i in range(n):
                stride = s if i == 0 else 1
                if stride == 2 and current_stride in (2, 4, 8, 16):
                    self.snapshot_before.append(len(self.blocks))
                    current_stride *= 2
                self.blocks.append(InvertedResidual(prev, int(c * width_mult), stride, t, divisible_hidden=False,
                                                    activation=activation))
                prev = int(c * width_mult)

    def get_output_spec(self) -> FeatureMapsSpec:
        channels = tuple(int(c * self.width_mult) for c in (16, 24, 32, 96, 320))
        strides = (2, 4, 8, 16, 32)
        if self.layers is not None:
            channels, strides = _take(channels, self.layers), _take(strides, self.layers)
        return FeatureMapsSpec(channels, strides)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return _run_blocks(self.act(self.stem(x)), self.blocks, self.snapshot_before, self.layers)


# (kernel, expanded, out, use_se, use_hs, stride): MobileNetV3 paper, tables 1 and 2
_V3_LARGE = [
    (3, 16, 16, False, False, 1),
    (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1),
    (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1),
    (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2),
    (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1),
    (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2),
    (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
]
_V3_SMALL = [
    (3, 16, 16, True, False, 2),
    (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1),
    (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1),
    (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1),
    (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2),
    (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1),
]


class MobileNetV3Encoder(EncoderBase):
    """MobileNetV3 large / small (arXiv:1905.02244): a hard-swish stem, then
    the table's inverted residuals; the maps before each downsample and the
    last, dropping the first when there are six (five in all, strides 2 to
    32).  ``in_channels`` is new here (flax infers it)."""

    def __init__(self, small: bool = False, layers: Optional[Tuple[int, ...]] = None, in_channels: int = 3):
        super().__init__()
        self.config = _V3_SMALL if small else _V3_LARGE
        self.layers = None if layers is None else tuple(layers)
        self.stem = nn.Sequential(nn.Conv2d(in_channels, 16, 3, stride=2, padding=1, bias=False), _bn(16))
        self.blocks = nn.ModuleList()
        prev = 16
        for k, e, c, se, hs, s in self.config:
            self.blocks.append(InvertedResidual(prev, c, s, e / prev, kernel_size=k, use_se=se, use_hs=hs))
            prev = c

    def get_output_spec(self) -> FeatureMapsSpec:
        channels, strides = [16], [2]
        current_stride, last_c = 2, 16
        for _, _, c, _, _, s in self.config:
            if s == 2:
                channels.append(last_c)
                strides.append(current_stride)
                current_stride *= 2
            last_c = c
        channels.append(last_c)
        strides.append(current_stride)
        # the first snapshot repeats the stem's map when the first block downsamples
        channels, strides = channels[1:], strides[1:]
        if self.layers is not None:
            channels, strides = _take(channels, self.layers), _take(strides, self.layers)
        return FeatureMapsSpec(channels, strides)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = hard_swish(self.stem(x))
        outputs = []
        for (_, _, _, _, _, s), block in zip(self.config, self.blocks):
            if s == 2:
                outputs.append(x)
            x = block(x)
        outputs.append(x)
        outputs = outputs[1:] if len(outputs) > 5 else outputs
        return outputs if self.layers is None else _take(outputs, self.layers)


def mobilenet_v3_large_encoder(**kwargs) -> MobileNetV3Encoder:
    return MobileNetV3Encoder(small=False, **kwargs)


def mobilenet_v3_small_encoder(**kwargs) -> MobileNetV3Encoder:
    return MobileNetV3Encoder(small=True, **kwargs)
