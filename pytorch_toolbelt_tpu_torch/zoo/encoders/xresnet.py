"""XResNet / SE-XResNet encoders (bag-of-tricks ResNet, arXiv:1812.01187;
counterpart of ``pytorch_toolbelt_tpu/zoo/encoders/xresnet.py``).

A 3-conv stem (8 -> 64 -> 64, the first at stride 2), the last BN of each
residual branch initialised to zero, and a 2x2 average pool (floor mode,
as flax's ``avg_pool``) before the identity path's 1x1 conv on stride-2
blocks.  Every conv is flax ``SAME`` (``Conv2dSame``): at stride 2 an even
input pads (0, 1).  A stride-2 block needs an even input, in the JAX
package too: the pool floors where the strided conv rounds up.
BatchNorm uses momentum 0.01, flax's default of 0.99 in torch's convention.
"""

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.activations import ACT_RELU, instantiate_activation_block
from ...nn.scse import ChannelSpatialGate2d
from ...nn.simple import Conv2dSame
from .common import EncoderBase, _bn, _take

__all__ = [
    "XResNetBlock",
    "XResNetEncoder",
    "xresnet18_encoder",
    "xresnet34_encoder",
    "xresnet50_encoder",
    "xresnet101_encoder",
    "xresnet152_encoder",
    "se_xresnet18_encoder",
    "se_xresnet34_encoder",
    "se_xresnet50_encoder",
    "se_xresnet101_encoder",
    "se_xresnet152_encoder",
]


class _ConvBN(nn.Module):
    """SAME conv (no bias) -> BN (scale zero-initialised with ``zero_bn``)
    -> the activation, if any."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1,
                 zero_bn: bool = False, activation: Optional[str] = ACT_RELU):
        super().__init__()
        self.conv = Conv2dSame(in_channels, out_channels, kernel_size, stride=stride, bias=False)
        self.bn = _bn(out_channels)
        if zero_bn:
            nn.init.zeros_(self.bn.weight)
        self.act = None if activation is None else instantiate_activation_block(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return x if self.act is None else self.act(x)


class XResNetBlock(nn.Module):
    """Basic (``expansion`` 1: two 3x3) or bottleneck (1x1, 3x3, 1x1) block
    of ``n_hidden * expansion`` output channels, with an optional scSE gate
    on the branch."""

    def __init__(self, in_channels: int, expansion: int, n_hidden: int, stride: int = 1,
                 activation: str = ACT_RELU, use_se: bool = False):
        super().__init__()
        n_filters = n_hidden * expansion
        self.stride = stride
        if expansion == 1:
            convs = [_ConvBN(in_channels, n_hidden, 3, stride, activation=activation),
                     _ConvBN(n_hidden, n_filters, 3, zero_bn=True, activation=None)]
        else:
            convs = [_ConvBN(in_channels, n_hidden, 1, activation=activation),
                     _ConvBN(n_hidden, n_hidden, 3, stride, activation=activation),
                     _ConvBN(n_hidden, n_filters, 1, zero_bn=True, activation=None)]
        self.convs = nn.Sequential(*convs)
        self.se = ChannelSpatialGate2d(n_filters, reduction=4) if use_se else None
        self.shortcut = (_ConvBN(in_channels, n_filters, 1, activation=None) if in_channels != n_filters
                         else None)
        self.act = instantiate_activation_block(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.convs(x)
        if self.se is not None:
            y = self.se(y)
        identity = F.avg_pool2d(x, 2, 2) if self.stride != 1 else x
        if self.shortcut is not None:
            identity = self.shortcut(identity)
        return self.act(y + identity)


class XResNetEncoder(EncoderBase):
    """``in_channels`` is new here: flax infers it."""

    def __init__(self, expansion: int = 1, blocks: Sequence[int] = (2, 2, 2, 2), activation: str = ACT_RELU,
                 use_se: bool = False, layers: Optional[Tuple[int, ...]] = None, in_channels: int = 3):
        super().__init__()
        self.expansion = expansion
        self.layers = None if layers is None else tuple(layers)
        self.stem = nn.Sequential(_ConvBN(in_channels, 8, 3, 2, activation=activation),
                                  _ConvBN(8, 64, 3, activation=activation),
                                  _ConvBN(64, 64, 3, activation=activation))
        prev, stages = 64, []
        for stage, (num_blocks, hidden) in enumerate(zip(blocks, (64, 128, 256, 512))):
            stage_blocks = []
            for i in range(num_blocks):
                stage_blocks.append(XResNetBlock(prev, expansion, hidden, 1 if stage == 0 or i > 0 else 2,
                                                 activation, use_se))
                prev = hidden * expansion
            stages.append(nn.Sequential(*stage_blocks))
        self.stages = nn.ModuleList(stages)

    def get_output_spec(self) -> FeatureMapsSpec:
        e = self.expansion
        channels, strides = (64, 64 * e, 128 * e, 256 * e, 512 * e), (2, 4, 8, 16, 32)
        if self.layers is not None:
            channels, strides = _take(channels, self.layers), _take(strides, self.layers)
        return FeatureMapsSpec(channels, strides)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(x)
        outputs = [x]
        x = F.max_pool2d(x, 3, 2, padding=1)
        for stage in self.stages:
            x = stage(x)
            outputs.append(x)
        if self.layers is not None:
            outputs = _take(outputs, self.layers)
        return outputs


def xresnet18_encoder(**kwargs) -> XResNetEncoder:
    return XResNetEncoder(expansion=1, blocks=(2, 2, 2, 2), **kwargs)


def xresnet34_encoder(**kwargs) -> XResNetEncoder:
    return XResNetEncoder(expansion=1, blocks=(3, 4, 6, 3), **kwargs)


def xresnet50_encoder(**kwargs) -> XResNetEncoder:
    return XResNetEncoder(expansion=4, blocks=(3, 4, 6, 3), **kwargs)


def xresnet101_encoder(**kwargs) -> XResNetEncoder:
    return XResNetEncoder(expansion=4, blocks=(3, 4, 23, 3), **kwargs)


def xresnet152_encoder(**kwargs) -> XResNetEncoder:
    return XResNetEncoder(expansion=4, blocks=(3, 8, 36, 3), **kwargs)


def se_xresnet18_encoder(**kwargs) -> XResNetEncoder:
    return XResNetEncoder(expansion=1, blocks=(2, 2, 2, 2), use_se=True, **kwargs)


def se_xresnet34_encoder(**kwargs) -> XResNetEncoder:
    return XResNetEncoder(expansion=1, blocks=(3, 4, 6, 3), use_se=True, **kwargs)


def se_xresnet50_encoder(**kwargs) -> XResNetEncoder:
    return XResNetEncoder(expansion=4, blocks=(3, 4, 6, 3), use_se=True, **kwargs)


def se_xresnet101_encoder(**kwargs) -> XResNetEncoder:
    return XResNetEncoder(expansion=4, blocks=(3, 4, 23, 3), use_se=True, **kwargs)


def se_xresnet152_encoder(**kwargs) -> XResNetEncoder:
    return XResNetEncoder(expansion=4, blocks=(3, 8, 36, 3), use_se=True, **kwargs)
