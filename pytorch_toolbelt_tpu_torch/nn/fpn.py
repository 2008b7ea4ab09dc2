"""FPN fusion blocks (counterpart of ``pytorch_toolbelt_tpu/nn/fpn.py``).
The blocks with convs take the input's channels, which flax infers."""

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .activations import ABN, ACT_RELU
from .functional import resize_2d

__all__ = ["FPNBottleneckBlock", "FPNContextBlock", "FPNFuse", "FPNFuseSum", "HFF"]


class FPNContextBlock(nn.Module):
    """Center FPN block aggregating multi-scale context: a 1x1 halving
    conv, average pools of 2, 4 and 8 (floor, as flax's VALID pool) and a
    global one, each to in/8 channels, resized (nearest) to the stride-2
    pool's size and concatenated, then 1x1 -> 3x3-ABN-dropout-3x3-ABN."""

    def __init__(self, in_channels: int, out_channels: int, activation: str = ACT_RELU, dropout: float = 0.0):
        super().__init__()
        half, eighth = in_channels // 2, in_channels // 8
        self.reduce = nn.Conv2d(in_channels, half, 1)
        self.pool_convs = nn.ModuleList(nn.Conv2d(half, eighth, 1) for _ in range(4))  # pools of 2, 4, 8, global
        self.project = nn.Conv2d(4 * eighth, out_channels, 1)
        self.conv1 = nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        self.abn1 = ABN(out_channels, activation=activation)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        self.abn2 = ABN(out_channels, activation=activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.reduce(x)
        c2, c4, c8, cg = self.pool_convs
        p2 = c2(F.avg_pool2d(x, 2, 2))
        out_size = p2.shape[2:]
        pooled = [p2] + [resize_2d(p, out_size, mode="nearest")
                         for p in (c4(F.avg_pool2d(x, 4, 4)), c8(F.avg_pool2d(x, 8, 8)),
                                   cg(x.mean(dim=(2, 3), keepdim=True)))]
        x = self.project(torch.cat(pooled, dim=1))
        x = self.dropout(self.abn1(self.conv1(x)))
        return self.abn2(self.conv2(x))


class FPNBottleneckBlock(nn.Module):
    """conv3x3-ABN-dropout-conv3x3-ABN."""

    def __init__(self, in_channels: int, out_channels: int, activation: str = ACT_RELU, dropout: float = 0.0):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.abn1 = ABN(out_channels, activation=activation)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        self.abn2 = ABN(out_channels, activation=activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dropout(self.abn1(self.conv1(x)))
        return self.abn2(self.conv2(x))


class FPNFuse(nn.Module):
    """Resize all maps to the first (finest) and concatenate."""

    def __init__(self, mode: str = "bilinear", align_corners: bool = False):
        super().__init__()
        self.mode = mode
        self.align_corners = align_corners

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        dst_size = features[0].shape[2:]
        return torch.cat([resize_2d(f, dst_size, mode=self.mode, align_corners=self.align_corners) for f in features],
                         dim=1)


class FPNFuseSum(nn.Module):
    """Resize all maps to the first and sum."""

    def __init__(self, mode: str = "bilinear", align_corners: bool = False):
        super().__init__()
        self.mode = mode
        self.align_corners = align_corners

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        dst_size = features[0].shape[2:]
        output = features[0]
        for f in features[1:]:
            output = output + resize_2d(f, dst_size, mode=self.mode, align_corners=self.align_corners)
        return output


class HFF(nn.Module):
    """Hierarchical feature fusion (arXiv:1811.11431):
    out = f0 + up(f1 + up(f2 + up(...))), each level resized to the next
    finer one's size (or to ``sizes[i]``)."""

    def __init__(self, upsample_scale: int = 2, mode: str = "nearest", align_corners: Optional[bool] = None,
                 sizes: Optional[Sequence] = None):
        super().__init__()
        self.upsample_scale = upsample_scale
        self.mode = mode
        self.align_corners = align_corners
        self.sizes = sizes

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        current = features[-1]
        for i in reversed(range(len(features) - 1)):
            target_size = self.sizes[i] if self.sizes is not None else features[i].shape[2:]
            current = features[i] + resize_2d(current, target_size, mode=self.mode,
                                              align_corners=bool(self.align_corners))
        return current
