"""HRNet V2 encoders (arXiv:1904.04514; counterpart of
``pytorch_toolbelt_tpu/zoo/encoders/hrnet.py``): parallel branches at four
resolutions, exchanged by fuse layers after every module; the encoder
returns the branch pyramid [w @ 4, 2w @ 8, 4w @ 16, 8w @ 32].

Where the JAX package departs from the official HRNet, the port follows it:

* The stem's two stride-2 3x3 convs, the transitions' and the fuse layers'
  strided 3x3 convs are flax ``SAME`` convs (``Conv2dSame``): an even input
  pads (0, 1), where the official HRNet pads (1, 1).
* A coarser branch reaches a finer one by a 1x1 conv, BN and a nearest
  resize to the finer map's size (torch's legacy rule, src = floor(dst *
  in / out)).

Children are registered in the order flax creates them, class by class, so
the weight bridge's numbering finds them: the stem, the stage-1
Bottlenecks, the transitions of every stage, then the ``_HRModule``s; in a
``_FuseLayer`` the paths (i, j) row by row, each chain's convs step by step.
BatchNorm uses momentum 0.01, flax's default of 0.99 in torch's convention.
"""

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.functional import resize_nearest
from ...nn.simple import Conv2dSame
from .common import EncoderBase, _bn, _take
from .resnet import BasicBlock, Bottleneck

__all__ = [
    "HRNetEncoder",
    "hrnet18_encoder",
    "hrnet32_encoder",
    "hrnet34_encoder",
    "hrnet48_encoder",
    "hrnet_w18_small_v2_encoder",
]


def _conv3x3(in_channels: int, out_channels: int, stride: int = 1) -> Conv2dSame:
    return Conv2dSame(in_channels, out_channels, 3, stride=stride, bias=False)


class _FuseLayer(nn.Module):
    """Exchange information across resolutions: output i sums every branch
    j, a coarser one through a 1x1 conv, BN and a nearest resize, a finer
    one through i - j strided 3x3 convs (BN after each, ReLU between), then
    a ReLU."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        self.channels = tuple(channels)
        rows = []
        for i, out in enumerate(self.channels):
            row = []
            for j, c in enumerate(self.channels):
                if j > i:
                    row.append(nn.Sequential(nn.Conv2d(c, out, 1, bias=False), _bn(out)))
                elif j < i:
                    steps = []
                    for step in range(i - j):
                        last = step == i - j - 1
                        steps += [_conv3x3(c, out if last else c, 2), _bn(out if last else c)]
                        if not last:
                            steps.append(nn.ReLU())
                    row.append(nn.Sequential(*steps))
                else:
                    row.append(nn.Identity())
            rows.append(nn.ModuleList(row))
        self.paths = nn.ModuleList(rows)

    def forward(self, branches: List[torch.Tensor]) -> List[torch.Tensor]:
        outputs = []
        for i, row in enumerate(self.paths):
            acc = None
            for j, path in enumerate(row):
                y = path(branches[j])
                if j > i:
                    y = resize_nearest(y, branches[i].shape[2:])
                acc = y if acc is None else acc + y
            outputs.append(F.relu(acc))
        return outputs


class _HRModule(nn.Module):
    """``num_blocks`` BasicBlocks on each branch, then a fuse layer."""

    def __init__(self, channels: Sequence[int], num_blocks: int = 4):
        super().__init__()
        self.branches = nn.ModuleList(nn.Sequential(*(BasicBlock(c, c) for _ in range(num_blocks)))
                                      for c in channels)
        self.fuse = _FuseLayer(channels)

    def forward(self, branches: List[torch.Tensor]) -> List[torch.Tensor]:
        return self.fuse([blocks(x) for blocks, x in zip(self.branches, branches)])


class HRNetEncoder(EncoderBase):
    """HRNet V2 of branch width ``width``: a stride-4 stem of two 3x3 convs,
    ``stage1_blocks`` Bottlenecks at 256 channels, then stages of
    ``stage_modules`` modules on 2, 3 and 4 branches.  ``in_channels`` is
    new here: flax infers it."""

    def __init__(self, width: int = 18, stage_modules: Sequence[int] = (1, 4, 3), blocks_per_module: int = 4,
                 stage1_blocks: int = 4, layers: Optional[Tuple[int, ...]] = None, in_channels: int = 3):
        super().__init__()
        self.width = width
        self.stage_modules = tuple(stage_modules)
        self.layers = None if layers is None else tuple(layers)
        self.conv1 = _conv3x3(in_channels, 64, 2)
        self.bn1 = _bn(64)
        self.conv2 = _conv3x3(64, 64, 2)
        self.bn2 = _bn(64)
        self.layer1 = nn.Sequential(*(Bottleneck(64 if i == 0 else 256, 256) for i in range(stage1_blocks)))

        prev = (256,)
        transitions, stages = [], []
        for stage_index, num_modules in enumerate(self.stage_modules):
            channels = self._branch_channels(stage_index + 2)
            step = []
            for i, c in enumerate(channels):
                if i < len(prev):
                    step.append(nn.Identity() if prev[i] == c else nn.Sequential(_conv3x3(prev[i], c), _bn(c),
                                                                                   nn.ReLU()))
                else:  # a new branch, from the coarsest one
                    step.append(nn.Sequential(_conv3x3(prev[-1], c, 2), _bn(c), nn.ReLU()))
            transitions.append(nn.ModuleList(step))
            stages.append(nn.Sequential(*(_HRModule(channels, blocks_per_module) for _ in range(num_modules))))
            prev = channels
        self.transitions = nn.ModuleList(transitions)
        self.stages = nn.ModuleList(stages)

    def _branch_channels(self, num_branches: int) -> Tuple[int, ...]:
        return tuple(self.width * (2**i) for i in range(num_branches))

    def get_output_spec(self) -> FeatureMapsSpec:
        channels, strides = self._branch_channels(4), (4, 8, 16, 32)
        if self.layers is not None:
            channels, strides = _take(channels, self.layers), _take(strides, self.layers)
        return FeatureMapsSpec(channels, strides)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        branches = [self.layer1(x)]
        for step, modules in zip(self.transitions, self.stages):
            branches = [t(branches[i] if i < len(branches) else branches[-1]) for i, t in enumerate(step)]
            for module in modules:
                branches = module(branches)
        if self.layers is not None:
            branches = _take(branches, self.layers)
        return branches


def hrnet18_encoder(**kwargs) -> HRNetEncoder:
    return HRNetEncoder(width=18, **kwargs)


def hrnet34_encoder(**kwargs) -> HRNetEncoder:
    return HRNetEncoder(width=34, **kwargs)


def hrnet32_encoder(**kwargs) -> HRNetEncoder:
    return HRNetEncoder(width=32, **kwargs)


def hrnet48_encoder(**kwargs) -> HRNetEncoder:
    return HRNetEncoder(width=48, **kwargs)


def hrnet_w18_small_v2_encoder(**kwargs) -> HRNetEncoder:
    """HRNet-W18 small v2: 2 stage-1 Bottlenecks, (1, 3, 2) stage modules,
    2 BasicBlocks per branch."""
    return HRNetEncoder(width=18, stage_modules=(1, 3, 2), blocks_per_module=2, stage1_blocks=2, **kwargs)
