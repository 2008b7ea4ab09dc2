"""OCNet object-context self-attention blocks (counterpart of
``pytorch_toolbelt_tpu/nn/ocnet.py``).

Attention runs as batched matmuls over flattened spatial tokens, its
similarities and its weighted sum in float32 whatever the input's dtype
(the JAX package's ``preferred_element_type``), and the context returns in
the value's dtype.  The key and query transforms are shared, as in the
reference.  The pyramid blocks partition the map into scale x scale tiles,
so its size must divide by the scale.
"""

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .activations import ABN, ACT_RELU
from .functional import resize_bilinear
from .simple import Conv2dSame

__all__ = [
    "ASPObjectContextBlock",
    "ObjectContextBlock",
    "PyramidObjectContextBlock",
    "PyramidSelfAttentionBlock2D",
    "SelfAttentionBlock2D",
]


def _attend(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor, key_channels: int) -> torch.Tensor:
    """softmax(Q K^T / sqrt(d)) V over [B, N, C] tokens, in float32."""
    sim = torch.matmul(query.float(), key.float().transpose(1, 2)) * (key_channels**-0.5)
    return torch.matmul(sim.softmax(dim=-1), value.float()).to(value.dtype)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    return x.flatten(2).transpose(1, 2)


class SelfAttentionBlock2D(nn.Module):
    """Non-local block on a map max-pooled ``scale`` times: shared key/query
    1x1 conv + ABN, value 1x1 conv, attention, 1x1 out conv, bilinear resize
    back.  ``in_channels`` is new here (flax infers it)."""

    def __init__(self, in_channels: int, key_channels: int, value_channels: int, out_channels: Optional[int] = None,
                 scale: int = 1):
        super().__init__()
        self.key_channels, self.scale = key_channels, scale
        self.key = nn.Conv2d(in_channels, key_channels, 1)
        self.key_abn = ABN(key_channels)
        self.value = nn.Conv2d(in_channels, value_channels, 1)
        self.out = nn.Conv2d(value_channels, out_channels or in_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2:]
        small = F.max_pool2d(x, self.scale) if self.scale > 1 else x
        kq = _tokens(self.key_abn(self.key(small)))
        context = _attend(kq, kq, _tokens(self.value(small)), self.key_channels)
        context = self.out(context.transpose(1, 2).reshape(x.shape[0], -1, *small.shape[2:]))
        return resize_bilinear(context, (h, w)) if self.scale > 1 else context


class ObjectContextBlock(nn.Module):
    """Sum of one ``SelfAttentionBlock2D`` per size, then a 1x1 conv + ABN.
    ``dropout`` is kept for the JAX signature; like the JAX block, this one
    applies none.  ``in_channels`` is new here."""

    def __init__(self, in_channels: int, out_channels: int, key_channels: int, value_channels: int,
                 dropout: float = 0.05, sizes: Sequence[int] = (1,)):
        super().__init__()
        self.stages = nn.ModuleList(SelfAttentionBlock2D(in_channels, key_channels, value_channels, out_channels,
                                                         scale=size) for size in sizes)
        self.conv = nn.Conv2d(out_channels, out_channels, 1, bias=False)
        self.abn = ABN(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        context = self.stages[0](x)
        for stage in self.stages[1:]:
            context = context + stage(x)
        return self.abn(self.conv(context))


class ASPObjectContextBlock(nn.Module):
    """ASP-OC: a 3x3 conv-ABN into an object-context block, a 1x1 conv-ABN
    and three dilated 3x3 conv-ABNs, concatenated, a 1x1 conv-ABN to twice
    ``out_features``, dropout.  Children in flax's creation order.
    ``in_channels`` is new here."""

    def __init__(self, in_channels: int, out_features: int = 256, dilations: Sequence[int] = (12, 24, 36),
                 dropout: float = 0.1, activation: str = ACT_RELU):
        super().__init__()

        def conv_abn(k: int, dilation: int = 1) -> nn.Sequential:
            return nn.Sequential(Conv2dSame(in_channels, out_features, k, dilation=dilation, bias=False),
                                 ABN(out_features, activation=activation))

        self.context_in = conv_abn(3)
        self.context = ObjectContextBlock(out_features, out_features, out_features // 2, out_features,
                                          dropout=dropout, sizes=(2,))
        self.branches = nn.ModuleList([conv_abn(1)] + [conv_abn(3, d) for d in dilations])
        self.fuse = nn.Sequential(nn.Conv2d(5 * out_features, 2 * out_features, 1, bias=False),
                                  ABN(2 * out_features, activation=activation))
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [self.context(self.context_in(x))] + [branch(x) for branch in self.branches]
        return self.dropout(self.fuse(torch.cat(feats, dim=1)))


class PyramidSelfAttentionBlock2D(nn.Module):
    """Attention inside each tile of a ``scale`` x ``scale`` partition of the
    map: shared key/query 1x1 conv (no bias) + ABN, value 1x1 conv, 1x1 out
    conv.  ``in_channels`` is new here."""

    def __init__(self, in_channels: int, key_channels: int, value_channels: int, out_channels: Optional[int] = None,
                 scale: int = 1):
        super().__init__()
        self.key_channels, self.scale = key_channels, scale
        self.key = nn.Conv2d(in_channels, key_channels, 1, bias=False)
        self.key_abn = ABN(key_channels)
        self.value = nn.Conv2d(in_channels, value_channels, 1)
        self.out = nn.Conv2d(value_channels, out_channels or in_channels, 1)

    def _partition(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, s hh, s ww] -> [B s s, hh ww, C]."""
        b, c, h, w = x.shape
        s = self.scale
        return x.reshape(b, c, s, h // s, s, w // s).permute(0, 2, 4, 3, 5, 1).reshape(b * s * s, -1, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        s = self.scale
        if h % s or w % s:
            raise ValueError(f"Spatial dims ({h}x{w}) must be divisible by pyramid scale {s}")
        kq = self._partition(self.key_abn(self.key(x)))
        context = _attend(kq, kq, self._partition(self.value(x)), self.key_channels)
        c = context.shape[-1]
        context = context.reshape(b, s, s, h // s, w // s, c).permute(0, 5, 1, 3, 2, 4).reshape(b, c, h, w)
        return self.out(context)


class PyramidObjectContextBlock(nn.Module):
    """Pyramid OC: a 1x1 conv-ABN to ``len(sizes)`` times the input width
    and one ``PyramidSelfAttentionBlock2D`` per size, concatenated, then a
    1x1 conv-ABN and dropout.  ``in_channels`` is new here."""

    def __init__(self, in_channels: int, out_channels: int, dropout: float = 0.05, sizes: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        group = len(sizes)
        self.up = nn.Conv2d(in_channels, in_channels * group, 1, bias=False)
        self.up_abn = ABN(in_channels * group)
        self.stages = nn.ModuleList(PyramidSelfAttentionBlock2D(in_channels, in_channels // 2, in_channels,
                                                                in_channels, scale=size) for size in sizes)
        self.conv = nn.Conv2d(2 * group * in_channels, out_channels, 1, bias=False)
        self.abn = ABN(out_channels)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        context = [self.up_abn(self.up(x))] + [stage(x) for stage in self.stages]
        return self.dropout(self.abn(self.conv(torch.cat(context, dim=1))))
