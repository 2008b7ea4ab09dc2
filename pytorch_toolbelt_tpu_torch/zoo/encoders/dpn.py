"""Dual Path Network encoders (arXiv:1707.01629; counterpart of
``pytorch_toolbelt_tpu/zoo/encoders/dpn.py``).

Each block carries a residual path (summed) and a dense path
(concatenated).  A block runs pre-activation BN-ReLU-conv steps (1x1, a
grouped 3x3 with the stride, flax ``SAME``) on the concatenated state, then
one 1x1 whose first ``num_1x1_c`` channels add to the residual path and the
rest join the dense path, or (``b_style``) two separate 1x1s.  The first
block of a stage, a strided one, or one fed a single tensor projects the
state first (BN, ReLU, strided 1x1 to ``num_1x1_c + 2 * inc``, split the same
way).  BatchNorm uses momentum 0.01, flax's default of 0.99 in torch's
convention.
"""

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.simple import Conv2dSame
from .common import EncoderBase, _bn, _take

__all__ = [
    "DPNEncoder",
    "DualPathBlock",
    "dpn68_encoder",
    "dpn68b_encoder",
    "dpn92_encoder",
    "dpn107_encoder",
    "dpn131_encoder",
]

_State = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


class DualPathBlock(nn.Module):
    """``in_channels`` counts the state's channels, both paths together;
    ``in_res_channels`` is its residual path's, None where the block is fed
    a single tensor."""

    def __init__(self, in_channels: int, num_1x1_a: int, num_3x3_b: int, num_1x1_c: int, inc: int,
                 groups: int = 32, stride: int = 1, is_first: bool = False, b_style: bool = False,
                 in_res_channels: Optional[int] = None):
        super().__init__()
        self.num_1x1_c, self.b_style = num_1x1_c, b_style
        self.bn_a = _bn(in_channels)
        self.conv_a = nn.Conv2d(in_channels, num_1x1_a, 1, bias=False)
        self.bn_b = _bn(num_1x1_a)
        self.conv_b = Conv2dSame(num_1x1_a, num_3x3_b, 3, stride=stride, groups=groups, bias=False)
        self.bn_c = _bn(num_3x3_b)
        if b_style:
            self.conv_c = nn.Conv2d(num_3x3_b, num_1x1_c, 1, bias=False)
            self.conv_dense = nn.Conv2d(num_3x3_b, inc, 1, bias=False)
        else:
            self.conv_c = nn.Conv2d(num_3x3_b, num_1x1_c + inc, 1, bias=False)
            self.conv_dense = None
        self.project = is_first or stride > 1 or in_res_channels != num_1x1_c
        if self.project:
            self.proj_bn = _bn(in_channels)
            self.proj_conv = nn.Conv2d(in_channels, num_1x1_c + 2 * inc, 1, stride=stride, bias=False)

    def forward(self, x: _State) -> Tuple[torch.Tensor, torch.Tensor]:
        inp = torch.cat(x, dim=1) if isinstance(x, tuple) else x
        y = self.conv_a(F.relu(self.bn_a(inp)))
        y = self.conv_b(F.relu(self.bn_b(y)))
        y = F.relu(self.bn_c(y))
        if self.b_style:
            out_res, out_dense = self.conv_c(y), self.conv_dense(y)
        else:
            out = self.conv_c(y)
            out_res, out_dense = out[:, :self.num_1x1_c], out[:, self.num_1x1_c:]
        if self.project:
            proj = self.proj_conv(F.relu(self.proj_bn(inp)))
            res_in, dense_in = proj[:, :self.num_1x1_c], proj[:, self.num_1x1_c:]
        else:
            res_in, dense_in = x
        return res_in + out_res, torch.cat([dense_in, out_dense], dim=1)


class DPNEncoder(EncoderBase):
    """``in_channels`` is new here: flax infers it."""

    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 12, 3), base_width: Sequence[int] = (96, 192, 384, 768),
                 res_width: Sequence[int] = (256, 512, 1024, 2048), inc: Sequence[int] = (16, 32, 24, 128),
                 groups: int = 32, stem_channels: int = 64, small_stem: bool = False, b_style: bool = False,
                 layers: Optional[Tuple[int, ...]] = None, in_channels: int = 3):
        super().__init__()
        self.layers = None if layers is None else tuple(layers)
        if small_stem:
            self.conv1 = Conv2dSame(in_channels, stem_channels, 3, stride=2, bias=False)
        else:
            self.conv1 = nn.Conv2d(in_channels, stem_channels, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(stem_channels)
        channels, res, stages, self.feature_channels = stem_channels, None, [], (stem_channels,)
        for stage, (blocks, bw, rw, k) in enumerate(zip(stage_blocks, base_width, res_width, inc)):
            stage_list = []
            for i in range(blocks):
                block = DualPathBlock(channels, bw, bw, rw, k, groups=groups, stride=2 if stage > 0 and i == 0 else 1,
                                      is_first=i == 0, b_style=b_style, in_res_channels=res)
                stage_list.append(block)
                dense = 3 * k if block.project else channels - res + k
                res, channels = rw, rw + dense
            stages.append(nn.Sequential(*stage_list))
            self.feature_channels += (channels,)
        self.stages = nn.ModuleList(stages)

    def get_output_spec(self) -> FeatureMapsSpec:
        channels, strides = self.feature_channels, (2, 4, 8, 16, 32)
        if self.layers is not None:
            channels, strides = _take(channels, self.layers), _take(strides, self.layers)
        return FeatureMapsSpec(channels, strides)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        outputs = [x]
        state: _State = F.max_pool2d(x, 3, 2, padding=1)
        for stage in self.stages:
            state = stage(state)
            outputs.append(torch.cat(state, dim=1))
        if self.layers is not None:
            outputs = _take(outputs, self.layers)
        return outputs


def dpn68_encoder(**kwargs) -> DPNEncoder:
    return DPNEncoder(**{**dict(stage_blocks=(3, 4, 12, 3), base_width=(64, 128, 256, 512),
                                res_width=(64, 128, 256, 512), inc=(16, 32, 32, 64), groups=32, stem_channels=10,
                                small_stem=True), **kwargs})


def dpn68b_encoder(**kwargs) -> DPNEncoder:
    """dpn68 with B-style blocks."""
    return dpn68_encoder(**{**dict(b_style=True), **kwargs})


def dpn92_encoder(**kwargs) -> DPNEncoder:
    return DPNEncoder(**{**dict(stage_blocks=(3, 4, 20, 3), base_width=(96, 192, 384, 768),
                                res_width=(256, 512, 1024, 2048), inc=(16, 32, 24, 128), groups=32,
                                stem_channels=64), **kwargs})


def dpn107_encoder(**kwargs) -> DPNEncoder:
    return DPNEncoder(**{**dict(stage_blocks=(4, 8, 20, 3), base_width=(200, 400, 800, 1600),
                                res_width=(256, 512, 1024, 2048), inc=(20, 64, 64, 128), groups=50,
                                stem_channels=128, b_style=True), **kwargs})


def dpn131_encoder(**kwargs) -> DPNEncoder:
    return DPNEncoder(**{**dict(stage_blocks=(4, 8, 28, 3), base_width=(160, 320, 640, 1280),
                                res_width=(256, 512, 1024, 2048), inc=(16, 32, 32, 128), groups=40,
                                stem_channels=128), **kwargs})
