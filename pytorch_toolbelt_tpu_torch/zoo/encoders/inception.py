"""Inception V4 encoder (arXiv:1602.07261; counterpart of
``pytorch_toolbelt_tpu/zoo/encoders/inception.py``).

Two padding regimes, as in the JAX package:

* default (``torch_compat=False``): flax ``SAME`` everywhere (convs through
  ``Conv2dSame``, the stride-2 max pools padded with -inf the same way,
  3x3 average pools counting the padding), so the strides are exactly
  (2, 4, 8, 16, 32);
* ``torch_compat=True``: the Cadene backbone -- VALID stem and reduction
  convs and pools, the other convs padded (k - 1) // 2 on each side, 3x3
  average pools with ``count_include_pad=False`` -- so that torch
  checkpoints port as they are (``porting.inception_v4_mapping``).

BatchNorm has epsilon 1e-3 in both, and momentum 0.01 (flax's default of
0.99 in torch's convention).  Channels per level: (64, 192, 384, 1024,
1536).  Children are registered in the order flax creates its ``ConvBN``s.
"""

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.normalization import BN_MOMENTUM, BatchNorm2d
from ...nn.simple import Conv2dSame, _same_padding
from .common import EncoderBase, _take

__all__ = ["ConvBN", "InceptionA", "InceptionB", "InceptionC", "InceptionV4Encoder", "ReductionA", "ReductionB",
           "inception_v4_encoder"]


def _avg_pool_3x3(x: torch.Tensor, compat: bool) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=not compat)


def _max_pool_3x3s2(x: torch.Tensor, compat: bool) -> torch.Tensor:
    if not compat:
        (top, bottom), (left, right) = (_same_padding(x.shape[2 + i], 3, 2) for i in range(2))
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


class ConvBN(nn.Module):
    """Conv (no bias) -> BN (epsilon 1e-3) -> ReLU.  ``valid`` is honoured
    only with ``compat``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: Tuple[int, int] = (3, 3), stride: int = 1,
                 valid: bool = False, compat: bool = False):
        super().__init__()
        if compat:
            padding = 0 if valid else tuple((k - 1) // 2 for k in kernel)
            self.conv = nn.Conv2d(in_channels, out_channels, kernel, stride=stride, padding=padding, bias=False)
        else:
            self.conv = Conv2dSame(in_channels, out_channels, kernel, stride=stride, bias=False)
        self.bn = BatchNorm2d(out_channels, eps=1e-3, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    """384 -> 384: 1x1 | 1x1, 3x3 | 1x1, 3x3, 3x3 | avg pool, 1x1."""

    def __init__(self, compat: bool = False):
        super().__init__()
        self.compat = compat
        c = dict(compat=compat)
        self.branch0 = ConvBN(384, 96, (1, 1), **c)
        self.branch1 = nn.Sequential(ConvBN(384, 64, (1, 1), **c), ConvBN(64, 96, (3, 3), **c))
        self.branch2 = nn.Sequential(ConvBN(384, 64, (1, 1), **c), ConvBN(64, 96, (3, 3), **c),
                                     ConvBN(96, 96, (3, 3), **c))
        self.branch3 = ConvBN(384, 96, (1, 1), **c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(_avg_pool_3x3(x, self.compat))], dim=1)


class ReductionA(nn.Module):
    """384 -> 1024 at stride 2: 3x3/2 | 1x1, 3x3, 3x3/2 | max pool."""

    def __init__(self, compat: bool = False):
        super().__init__()
        self.compat = compat
        c = dict(compat=compat)
        self.branch0 = ConvBN(384, 384, (3, 3), stride=2, valid=True, **c)
        self.branch1 = nn.Sequential(ConvBN(384, 192, (1, 1), **c), ConvBN(192, 224, (3, 3), **c),
                                     ConvBN(224, 256, (3, 3), stride=2, valid=True, **c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch0(x), self.branch1(x), _max_pool_3x3s2(x, self.compat)], dim=1)


class InceptionB(nn.Module):
    """1024 -> 1024 with factorised 7x7s."""

    def __init__(self, compat: bool = False):
        super().__init__()
        self.compat = compat
        c = dict(compat=compat)
        self.branch0 = ConvBN(1024, 384, (1, 1), **c)
        self.branch1 = nn.Sequential(ConvBN(1024, 192, (1, 1), **c), ConvBN(192, 224, (1, 7), **c),
                                     ConvBN(224, 256, (7, 1), **c))
        self.branch2 = nn.Sequential(ConvBN(1024, 192, (1, 1), **c), ConvBN(192, 192, (7, 1), **c),
                                     ConvBN(192, 224, (1, 7), **c), ConvBN(224, 224, (7, 1), **c),
                                     ConvBN(224, 256, (1, 7), **c))
        self.branch3 = ConvBN(1024, 128, (1, 1), **c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(_avg_pool_3x3(x, self.compat))], dim=1)


class ReductionB(nn.Module):
    """1024 -> 1536 at stride 2."""

    def __init__(self, compat: bool = False):
        super().__init__()
        self.compat = compat
        c = dict(compat=compat)
        self.branch0 = nn.Sequential(ConvBN(1024, 192, (1, 1), **c),
                                     ConvBN(192, 192, (3, 3), stride=2, valid=True, **c))
        self.branch1 = nn.Sequential(ConvBN(1024, 256, (1, 1), **c), ConvBN(256, 256, (1, 7), **c),
                                     ConvBN(256, 320, (7, 1), **c),
                                     ConvBN(320, 320, (3, 3), stride=2, valid=True, **c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch0(x), self.branch1(x), _max_pool_3x3s2(x, self.compat)], dim=1)


class InceptionC(nn.Module):
    """1536 -> 1536 with split 1x3 / 3x1 heads."""

    def __init__(self, compat: bool = False):
        super().__init__()
        self.compat = compat
        c = dict(compat=compat)
        self.branch0 = ConvBN(1536, 256, (1, 1), **c)
        self.branch1_0 = ConvBN(1536, 384, (1, 1), **c)
        self.branch1_1a = ConvBN(384, 256, (1, 3), **c)
        self.branch1_1b = ConvBN(384, 256, (3, 1), **c)
        self.branch2 = nn.Sequential(ConvBN(1536, 384, (1, 1), **c), ConvBN(384, 448, (3, 1), **c),
                                     ConvBN(448, 512, (1, 3), **c))
        self.branch2_3a = ConvBN(512, 256, (1, 3), **c)
        self.branch2_3b = ConvBN(512, 256, (3, 1), **c)
        self.branch3 = ConvBN(1536, 256, (1, 1), **c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1_0(x)
        b2 = self.branch2(x)
        return torch.cat([self.branch0(x), self.branch1_1a(b1), self.branch1_1b(b1), self.branch2_3a(b2),
                          self.branch2_3b(b2), self.branch3(_avg_pool_3x3(x, self.compat))], dim=1)


class InceptionV4Encoder(EncoderBase):
    """``stage_repeats`` counts the Inception-A/B/C blocks (4, 7, 3 in the
    reference).  ``in_channels`` is new here: flax infers it."""

    def __init__(self, layers: Optional[Tuple[int, ...]] = None, torch_compat: bool = False,
                 stage_repeats: Sequence[int] = (4, 7, 3), in_channels: int = 3):
        super().__init__()
        self.layers = None if layers is None else tuple(layers)
        self.compat = c = torch_compat
        na, nb, nc = stage_repeats
        self.stem = nn.Sequential(ConvBN(in_channels, 32, (3, 3), stride=2, valid=True, compat=c),
                                  ConvBN(32, 32, (3, 3), valid=True, compat=c), ConvBN(32, 64, (3, 3), compat=c))
        self.mixed_3a = ConvBN(64, 96, (3, 3), stride=2, valid=True, compat=c)
        self.mixed_4a_0 = nn.Sequential(ConvBN(160, 64, (1, 1), compat=c),
                                        ConvBN(64, 96, (3, 3), valid=True, compat=c))
        self.mixed_4a_1 = nn.Sequential(ConvBN(160, 64, (1, 1), compat=c), ConvBN(64, 64, (1, 7), compat=c),
                                        ConvBN(64, 64, (7, 1), compat=c),
                                        ConvBN(64, 96, (3, 3), valid=True, compat=c))
        self.mixed_5a = ConvBN(192, 192, (3, 3), stride=2, valid=True, compat=c)
        self.blocks_a = nn.Sequential(*(InceptionA(c) for _ in range(na)))
        self.reduction_a = ReductionA(c)
        self.blocks_b = nn.Sequential(*(InceptionB(c) for _ in range(nb)))
        self.reduction_b = ReductionB(c)
        self.blocks_c = nn.Sequential(*(InceptionC(c) for _ in range(nc)))

    def get_output_spec(self) -> FeatureMapsSpec:
        channels, strides = (64, 192, 384, 1024, 1536), (2, 4, 8, 16, 32)
        if self.layers is not None:
            channels, strides = _take(channels, self.layers), _take(strides, self.layers)
        return FeatureMapsSpec(channels, strides)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(x)
        outputs = [x]
        x = torch.cat([_max_pool_3x3s2(x, self.compat), self.mixed_3a(x)], dim=1)  # 160
        x = torch.cat([self.mixed_4a_0(x), self.mixed_4a_1(x)], dim=1)  # 192
        outputs.append(x)
        x = torch.cat([self.mixed_5a(x), _max_pool_3x3s2(x, self.compat)], dim=1)  # 384
        x = self.blocks_a(x)
        outputs.append(x)
        x = self.blocks_b(self.reduction_a(x))
        outputs.append(x)
        x = self.blocks_c(self.reduction_b(x))
        outputs.append(x)
        if self.layers is not None:
            outputs = _take(outputs, self.layers)
        return outputs


def inception_v4_encoder(**kwargs) -> InceptionV4Encoder:
    return InceptionV4Encoder(**kwargs)
