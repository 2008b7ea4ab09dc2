"""WiderResNet encoders (the Mapillary in-place-ABN family; counterpart of
``pytorch_toolbelt_tpu/zoo/encoders/wide_resnet.py``): pre-activation
identity-residual blocks, channels per module (64, 128, 256, 512, 1024,
2048, 4096).

Downsampling, as in the JAX package:

* base: a 3x3/2 max pool (padding 1) before each of modules 2-6, every
  block at stride 1;
* ``a2``: the pool before modules 2 and 3 only; modules 4-6 downsample in
  their first block (stride on ``conv1`` and a strided 1x1 ``proj_conv``);
  modules 6 and 7 drop out 0.3 and 0.5 of their elements in training
  (flax's ``Dropout``, element-wise);
* ``a2`` with ``dilation``: only module 4 downsamples, modules 5-7 dilate
  by 2, 4, 4 (output stride 8).

The 3x3 convs pad their dilation on each side.  The modules carry the JAX
package's hand names (``mod1_conv1``, ``mod{m}_block{b}``; in a block
``bn1``, ``proj_conv``, ``conv1``, ``bn2``, ``conv2``, ``bn3``, ``conv3``),
which the weight bridge keeps.  BatchNorm uses momentum 0.01, flax's
default of 0.99 in torch's convention.
"""

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.activations import ACT_RELU, instantiate_activation_block
from .common import EncoderBase, _bn, _take

__all__ = [
    "IdentityResidualBlock",
    "WiderResNetA2Encoder",
    "WiderResNetEncoder",
    "wider_resnet16_a2_encoder",
    "wider_resnet16_encoder",
    "wider_resnet20_a2_encoder",
    "wider_resnet20_encoder",
    "wider_resnet38_a2_encoder",
    "wider_resnet38_encoder",
]

# channels per module; a 3-tuple makes a bottleneck block
_MODULE_CHANNELS = (
    (128, 128),
    (256, 256),
    (512, 512),
    (512, 1024),
    (512, 1024, 2048),
    (1024, 2048, 4096),
)


class IdentityResidualBlock(nn.Module):
    """BN -> act -> two 3x3 convs (or 1x1, 3x3, 1x1) with BN -> act between,
    added to the input, or to a 1x1 projection of the activated input where
    the stride or the width changes."""

    def __init__(self, in_channels: int, channels: Sequence[int], stride: int = 1, dilation: int = 1,
                 dropout_rate: float = 0.0, activation: str = ACT_RELU):
        super().__init__()
        self.act = instantiate_activation_block(activation)
        channels, d = tuple(channels), dilation
        self.bn1 = _bn(in_channels)
        self.proj_conv = (nn.Conv2d(in_channels, channels[-1], 1, stride=stride, bias=False)
                          if stride != 1 or in_channels != channels[-1] else None)
        if len(channels) == 2:
            self.conv1 = nn.Conv2d(in_channels, channels[0], 3, stride=stride, padding=d, dilation=d, bias=False)
            self.bn2 = _bn(channels[0])
            self.conv2 = nn.Conv2d(channels[0], channels[1], 3, padding=d, dilation=d, bias=False)
            self.bn3 = self.conv3 = None
        else:
            self.conv1 = nn.Conv2d(in_channels, channels[0], 1, stride=stride, bias=False)
            self.bn2 = _bn(channels[0])
            self.conv2 = nn.Conv2d(channels[0], channels[1], 3, padding=d, dilation=d, bias=False)
            self.bn3 = _bn(channels[1])
            self.conv3 = nn.Conv2d(channels[1], channels[2], 1, bias=False)
        self.dropout = nn.Dropout(dropout_rate) if dropout_rate else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pre = self.act(self.bn1(x))
        shortcut = x if self.proj_conv is None else self.proj_conv(pre)
        y = self.act(self.bn2(self.conv1(pre)))
        if self.conv3 is not None:
            y = self.act(self.bn3(self.conv2(y)))
        if self.dropout is not None:
            y = self.dropout(y)
        y = self.conv2(y) if self.conv3 is None else self.conv3(y)
        return y + shortcut


class WiderResNetEncoder(EncoderBase):
    """``structure`` counts the blocks of modules 2-7.  ``in_channels`` is
    new here: flax infers it."""

    def __init__(self, structure: Sequence[int] = (1, 1, 1, 1, 1, 1), activation: str = ACT_RELU, a2: bool = False,
                 dilation: bool = False, layers: Optional[Tuple[int, ...]] = None, in_channels: int = 3):
        super().__init__()
        self.a2, self.dilation = a2, dilation
        self.layers = None if layers is None else tuple(layers)
        self.mod1_conv1 = nn.Conv2d(in_channels, 64, 3, padding=1, bias=False)
        self.plan = []  # (pool before, [block names]) per module
        prev = 64
        for mod_id, (num_blocks, channels) in enumerate(zip(structure, _MODULE_CHANNELS)):
            names = []
            for block_id in range(num_blocks):
                stride, dil, drop = 1, 1, 0.0
                if a2:
                    if dilation:
                        dil = 2 if mod_id == 3 else (4 if mod_id > 3 else 1)
                        stride = 2 if block_id == 0 and mod_id == 2 else 1
                    else:
                        stride = 2 if block_id == 0 and 2 <= mod_id <= 4 else 1
                    drop = 0.3 if mod_id == 4 else (0.5 if mod_id == 5 else 0.0)
                name = f"mod{mod_id + 2}_block{block_id + 1}"
                self.add_module(name, IdentityResidualBlock(prev, channels, stride, dil, drop, activation))
                names.append(name)
                prev = channels[-1]
            self.plan.append((mod_id < 2 if a2 else mod_id < 5, names))

    def get_output_spec(self) -> FeatureMapsSpec:
        channels = (64, 128, 256, 512, 1024, 2048, 4096)
        strides = (1, 2, 4, 8, 8, 8, 8) if self.a2 and self.dilation else (1, 2, 4, 8, 16, 32, 32)
        if self.layers is not None:
            channels, strides = _take(channels, self.layers), _take(strides, self.layers)
        return FeatureMapsSpec(channels, strides)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.mod1_conv1(x)
        outputs = [x]
        for pool_before, names in self.plan:
            if pool_before:
                x = F.max_pool2d(x, 3, 2, padding=1)
            for name in names:
                x = getattr(self, name)(x)
            outputs.append(x)
        if self.layers is not None:
            outputs = _take(outputs, self.layers)
        return outputs


def WiderResNetA2Encoder(**kwargs) -> WiderResNetEncoder:
    """The A2 flavour (strided first blocks in modules 4-6)."""
    return WiderResNetEncoder(a2=True, **kwargs)


def wider_resnet16_encoder(**kwargs) -> WiderResNetEncoder:
    return WiderResNetEncoder(structure=(1, 1, 1, 1, 1, 1), **kwargs)


def wider_resnet20_encoder(**kwargs) -> WiderResNetEncoder:
    return WiderResNetEncoder(structure=(1, 1, 1, 3, 1, 1), **kwargs)


def wider_resnet38_encoder(**kwargs) -> WiderResNetEncoder:
    return WiderResNetEncoder(structure=(3, 3, 6, 3, 1, 1), **kwargs)


def wider_resnet16_a2_encoder(**kwargs) -> WiderResNetEncoder:
    return WiderResNetEncoder(structure=(1, 1, 1, 1, 1, 1), a2=True, **kwargs)


def wider_resnet20_a2_encoder(**kwargs) -> WiderResNetEncoder:
    return WiderResNetEncoder(structure=(1, 1, 1, 3, 1, 1), a2=True, **kwargs)


def wider_resnet38_a2_encoder(**kwargs) -> WiderResNetEncoder:
    return WiderResNetEncoder(structure=(3, 3, 6, 3, 1, 1), a2=True, **kwargs)
