"""TResNet encoders (arXiv:2003.13630; counterpart of
``pytorch_toolbelt_tpu/zoo/encoders/tresnet.py``): a space-to-depth stem,
anti-aliased (blur-pool) downsampling, SE gates in the first three stages,
basic blocks in stages 0-1 and bottlenecks (x4) in stages 2-3.

Conventions kept from the JAX package:

* :func:`space_to_depth` orders the channels ``(c s1 s2)``: channel
  ``c * 16 + s1 * 4 + s2`` holds input channel c at offset (s1, s2) of its
  4 x 4 block, where timm's order is ``(s1 s2 c)``.  The input's sides must
  be multiples of 4;
* :class:`BlurPool` is a fixed binomial depthwise 3x3 at stride 2, flax
  ``SAME`` (an even side pads (0, 1), an odd one (1, 1)), with its kernel in
  the input's dtype and no parameters;
* every activation is ``leaky_relu(x, 1e-3)``; the SE gate is
  ``nn.scse.SpatialGate2d`` (reduction 4 after the basic block's second BN,
  8 after the bottleneck's 3x3);
* the widths are ``int(64 * width_factor)`` times 1, 2, 16 and 32.

Children are registered in flax's creation order: a block's main path, its
SE gate, then the shortcut conv and its BN.  BatchNorm uses momentum 0.01,
flax's default of 0.99 in torch's convention.
"""

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.scse import SpatialGate2d
from ...nn.simple import _same_padding
from .common import EncoderBase, _bn, _take

__all__ = [
    "BlurPool",
    "TResNetBasicBlock",
    "TResNetBottleneck",
    "TResNetEncoder",
    "space_to_depth",
    "tresnet_l_encoder",
    "tresnet_m_encoder",
    "tresnet_xl_encoder",
]

_SLOPE = 1e-3


def space_to_depth(x: torch.Tensor, block: int = 4) -> torch.Tensor:
    """[B, C, H, W] -> [B, C * block^2, H / block, W / block], channels in
    ``(c s1 s2)`` order."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // block, block, w // block, block)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(b, c * block * block, h // block, w // block)


class BlurPool(nn.Module):
    """Anti-aliased stride-2 downsampling: the depthwise 3x3 binomial filter
    [1, 2, 1]^T [1, 2, 1] / 16, ``SAME`` padded."""

    def __init__(self):
        super().__init__()
        self._kernels: Dict[Tuple[torch.dtype, torch.device, int], torch.Tensor] = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        key = (x.dtype, x.device, c)
        kernel = self._kernels.get(key)
        if kernel is None:
            row = torch.tensor([1.0, 2.0, 1.0], dtype=torch.float64)
            k2 = torch.outer(row, row)
            kernel = (k2 / k2.sum()).to(x.dtype).expand(c, 1, 3, 3).contiguous().to(x.device)
            self._kernels[key] = kernel
        (top, bottom), (left, right) = (_same_padding(x.shape[2 + i], 3, 2) for i in range(2))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), kernel, stride=2, groups=c)


def _shortcut(in_channels: int, out_channels: int) -> Optional[nn.Sequential]:
    if in_channels == out_channels:
        return None
    return nn.Sequential(nn.Conv2d(in_channels, out_channels, 1, bias=False), _bn(out_channels))


class TResNetBasicBlock(nn.Module):
    """[blur] -> 3x3 -> BN -> leaky -> 3x3 -> BN -> [SE/4], plus the
    (blurred, projected where the channels change) input, then leaky."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1, use_se: bool = True):
        super().__init__()
        self.stride = stride
        self.blur = BlurPool() if stride == 2 else None
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.bn1 = _bn(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        self.bn2 = _bn(out_channels)
        self.se = SpatialGate2d(out_channels, reduction=4) if use_se else None
        self.shortcut = _shortcut(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.blur is not None:
            x = self.blur(x)  # the main path and the residual both start blurred
        y = F.leaky_relu(self.bn1(self.conv1(x)), _SLOPE)
        y = self.bn2(self.conv2(y))
        if self.se is not None:
            y = self.se(y)
        residual = x if self.shortcut is None else self.shortcut(x)
        return F.leaky_relu(y + residual, _SLOPE)


class TResNetBottleneck(nn.Module):
    """1x1 -> BN -> leaky -> [blur] -> 3x3 -> BN -> leaky -> [SE/8] -> 1x1
    -> BN, plus the (blurred, projected) input, then leaky."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1, use_se: bool = False,
                 expansion: int = 4):
        super().__init__()
        width = out_channels // expansion
        self.conv1 = nn.Conv2d(in_channels, width, 1, bias=False)
        self.bn1 = _bn(width)
        self.blur = BlurPool() if stride == 2 else None
        self.conv2 = nn.Conv2d(width, width, 3, padding=1, bias=False)
        self.bn2 = _bn(width)
        self.se = SpatialGate2d(width, reduction=8) if use_se else None
        self.conv3 = nn.Conv2d(width, out_channels, 1, bias=False)
        self.bn3 = _bn(out_channels)
        self.shortcut = _shortcut(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(self.bn1(self.conv1(x)), _SLOPE)
        if self.blur is not None:
            y, x = self.blur(y), self.blur(x)
        y = F.leaky_relu(self.bn2(self.conv2(y)), _SLOPE)
        if self.se is not None:
            y = self.se(y)
        y = self.bn3(self.conv3(y))
        residual = x if self.shortcut is None else self.shortcut(x)
        return F.leaky_relu(y + residual, _SLOPE)


class TResNetEncoder(EncoderBase):
    """Space-to-depth stem (3x3 conv, BN, leaky) and four stages; feature
    maps at strides 4, 4, 8, 16, 32.  ``in_channels`` is new here."""

    def __init__(self, width_factor: float = 1.0, stage_blocks: Tuple[int, ...] = (3, 4, 11, 3),
                 layers: Optional[Tuple[int, ...]] = None, in_channels: int = 3):
        super().__init__()
        self.width_factor = width_factor
        self.layers = None if layers is None else tuple(layers)
        base = int(64 * width_factor)
        self.stem = nn.Sequential(nn.Conv2d(in_channels * 16, base, 3, padding=1, bias=False), _bn(base))
        self.stages = nn.ModuleList()
        prev = base
        for stage, (num_blocks, channels) in enumerate(zip(stage_blocks, self._stage_channels())):
            block_cls = TResNetBottleneck if stage >= 2 else TResNetBasicBlock
            blocks = nn.ModuleList()
            for i in range(num_blocks):
                blocks.append(block_cls(prev, channels, stride=2 if stage > 0 and i == 0 else 1, use_se=stage <= 2))
                prev = channels
            self.stages.append(blocks)

    def _stage_channels(self) -> Tuple[int, ...]:
        base = int(64 * self.width_factor)
        return base, base * 2, base * 4 * 4, base * 8 * 4

    def get_output_spec(self) -> FeatureMapsSpec:
        channels, strides = (int(64 * self.width_factor),) + self._stage_channels(), (4, 4, 8, 16, 32)
        if self.layers is not None:
            channels, strides = _take(channels, self.layers), _take(strides, self.layers)
        return FeatureMapsSpec(channels, strides)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.leaky_relu(self.stem(space_to_depth(x, 4)), _SLOPE)
        outputs = [x]
        for blocks in self.stages:
            for block in blocks:
                x = block(x)
            outputs.append(x)
        return outputs if self.layers is None else _take(outputs, self.layers)


def tresnet_m_encoder(**kwargs) -> TResNetEncoder:
    return TResNetEncoder(width_factor=1.0, stage_blocks=(3, 4, 11, 3), **kwargs)


def tresnet_l_encoder(**kwargs) -> TResNetEncoder:
    return TResNetEncoder(width_factor=1.2, stage_blocks=(4, 5, 18, 3), **kwargs)


def tresnet_xl_encoder(**kwargs) -> TResNetEncoder:
    return TResNetEncoder(width_factor=1.3, stage_blocks=(4, 5, 24, 3), **kwargs)
