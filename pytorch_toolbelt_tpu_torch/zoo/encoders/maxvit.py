"""MaxViT encoders (arXiv:2204.01697; counterpart of
``pytorch_toolbelt_tpu/zoo/encoders/maxvit.py``): each block is an MBConv,
then attention within P x P windows (block attention), then attention
across a P x P grid of tokens h / P apart (grid attention).

Inside a block the attention runs on [B', P * P, C] tokens; the stages
return NCHW feature maps.  Conventions kept from the JAX package:

* the map is **zero-padded** at the bottom and right to a multiple of
  ``partition`` with **no mask**: the LayerNorms and the attention see the
  zero tokens, and the result is cropped after the grid attention;
* block windows gather rows ``(nh p1)`` (window index outer), grid windows
  ``(p1 nh)`` (the partition index outer);
* a stride-2 or channel-changing block adds a 2x2 average pool (VALID) and a
  1x1 conv with bias of its input to the MBConv's output;
* there is no relative position bias;
* every ``LayerNorm`` has flax's epsilon of 1e-6; GELU is the tanh
  approximation;
* the stem is a 3x3 stride-2 flax ``SAME`` conv (an even side pads (0, 1)),
  BN, GELU, and a 3x3 conv with bias.

Blocks are numbered over all stages (``MaxViTBlock_{i}``), as flax names
them.  ``use_remat`` recomputes each block's activations on the backward
pass (``torch.utils.checkpoint``, flax's ``nn.remat``).  BatchNorm uses
momentum 0.01, flax's default of 0.99 in torch's convention.
"""

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.simple import Conv2dSame
from .common import EncoderBase, _bn, _remat, _take
from .efficientnet import MBConv

__all__ = [
    "MaxViTBlock",
    "MaxViTEncoder",
    "maxvit_base_encoder",
    "maxvit_large_encoder",
    "maxvit_small_encoder",
    "maxvit_tiny_encoder",
    "maxvit_xlarge_encoder",
]

LN_EPS = 1e-6  # flax's LayerNorm epsilon


class _Attention(nn.Module):
    """Multi-head self-attention on [B', N, C]: one qkv projection, split as
    (3, heads, head_dim), softmax(q k^T * head_dim^-0.5) v, projection."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        head_dim = c // self.num_heads
        q, k, v = self.qkv(x).reshape(b, n, 3, self.num_heads, head_dim).permute(2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(q, k, v, scale=head_dim**-0.5)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class _TransformerBlock(nn.Module):
    """x + attn(LN(x)), then x + fc2(gelu(fc1(LN(x))))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = _Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, dim * mlp_ratio)
        self.fc2 = nn.Linear(dim * mlp_ratio, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="tanh"))


def _block_windows(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, H, W, C] -> [(B nh nw), p * p, C]: rows ``(nh p1)``."""
    b, h, w, c = x.shape
    return x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, p * p, c)


def _from_block_windows(t: torch.Tensor, b: int, h: int, w: int, p: int) -> torch.Tensor:
    c = t.shape[-1]
    return t.reshape(b, h // p, w // p, p, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _grid_windows(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, H, W, C] -> [(B nh nw), p * p, C]: rows ``(p1 nh)``."""
    b, h, w, c = x.shape
    return x.reshape(b, p, h // p, p, w // p, c).permute(0, 2, 4, 1, 3, 5).reshape(-1, p * p, c)


def _from_grid_windows(t: torch.Tensor, b: int, h: int, w: int, p: int) -> torch.Tensor:
    c = t.shape[-1]
    return t.reshape(b, h // p, w // p, p, p, c).permute(0, 3, 1, 4, 2, 5).reshape(b, h, w, c)


class MaxViTBlock(nn.Module):
    """MBConv (expand 4, 3x3, SE) with a pooled 1x1 shortcut where the shape
    changes, then block and grid attention.  ``in_channels`` is new here
    (flax infers it)."""

    def __init__(self, in_channels: int, out_channels: int, num_heads: int, stride: int = 1, partition: int = 8):
        super().__init__()
        self.stride, self.partition = stride, partition
        self.mbconv = MBConv(in_channels, out_channels, stride=stride, expand_ratio=4, kernel_size=3)
        if stride != 1 or in_channels != out_channels:
            self.shortcut = nn.Conv2d(in_channels, out_channels, 1)
        else:
            self.shortcut = None
        self.block_attention = _TransformerBlock(out_channels, num_heads)
        self.grid_attention = _TransformerBlock(out_channels, num_heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.partition
        y = self.mbconv(x)
        if self.shortcut is not None:
            shortcut = x if self.stride == 1 else F.avg_pool2d(x, self.stride, self.stride)
            y = y + self.shortcut(shortcut)
        x = y.permute(0, 2, 3, 1)  # NHWC (a view of a channels_last map)
        b, h, w, _ = x.shape
        pad_h, pad_w = (-h) % p, (-w) % p
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        hp, wp = h + pad_h, w + pad_w
        x = _from_block_windows(self.block_attention(_block_windows(x, p)), b, hp, wp, p)
        x = _from_grid_windows(self.grid_attention(_grid_windows(x, p)), b, hp, wp, p)
        if pad_h or pad_w:
            x = x[:, :h, :w]
        return x.permute(0, 3, 1, 2)


class MaxViTEncoder(EncoderBase):
    """Stem (3x3 SAME stride 2, BN, GELU, 3x3 with bias) and four stages of
    MaxViT blocks, the first of each at stride 2; feature maps at strides 2,
    4, 8, 16, 32.  ``in_channels`` is new here (flax infers it)."""

    def __init__(
        self,
        stem_channels: int = 64,
        stage_channels: Sequence[int] = (64, 128, 256, 512),
        stage_blocks: Sequence[int] = (2, 2, 5, 2),
        num_heads: Sequence[int] = (2, 4, 8, 16),
        partition: int = 8,
        layers: Optional[Tuple[int, ...]] = None,
        use_remat: bool = False,
        in_channels: int = 3,
    ):
        super().__init__()
        self.stem_channels, self.stage_channels = stem_channels, tuple(stage_channels)
        self.layers = None if layers is None else tuple(layers)
        self.use_remat = use_remat
        self.stem = nn.Sequential(Conv2dSame(in_channels, stem_channels, 3, stride=2, bias=False), _bn(stem_channels))
        self.stem_conv = nn.Conv2d(stem_channels, stem_channels, 3, padding=1)
        self.stages = nn.ModuleList()
        prev = stem_channels
        for channels, blocks, heads in zip(self.stage_channels, stage_blocks, num_heads):
            stage = nn.ModuleList()
            for i in range(blocks):
                stage.append(MaxViTBlock(prev, channels, heads, stride=2 if i == 0 else 1, partition=partition))
                prev = channels
            self.stages.append(stage)

    def get_output_spec(self) -> FeatureMapsSpec:
        channels, strides = (self.stem_channels,) + self.stage_channels, (2, 4, 8, 16, 32)
        if self.layers is not None:
            channels, strides = _take(channels, self.layers), _take(strides, self.layers)
        return FeatureMapsSpec(channels, strides)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem_conv(F.gelu(self.stem(x), approximate="tanh"))
        outputs = [x]
        for stage in self.stages:
            for block in stage:
                x = _remat(block, None, x) if self.use_remat and torch.is_grad_enabled() else block(x)
            outputs.append(x)
        return outputs if self.layers is None else _take(outputs, self.layers)


def maxvit_tiny_encoder(**kwargs) -> MaxViTEncoder:
    return MaxViTEncoder(**{**dict(stage_channels=(64, 128, 256, 512), stage_blocks=(2, 2, 5, 2)), **kwargs})


def maxvit_small_encoder(**kwargs) -> MaxViTEncoder:
    return MaxViTEncoder(**{**dict(stage_channels=(96, 192, 384, 768), stage_blocks=(2, 2, 5, 2)), **kwargs})


def maxvit_base_encoder(**kwargs) -> MaxViTEncoder:
    """MaxViT-B (arXiv:2204.01697 table 1)."""
    return MaxViTEncoder(**{**dict(stem_channels=64, stage_channels=(96, 192, 384, 768), stage_blocks=(2, 6, 14, 2),
                                   num_heads=(3, 6, 12, 24)), **kwargs})


def maxvit_large_encoder(**kwargs) -> MaxViTEncoder:
    return MaxViTEncoder(**{**dict(stem_channels=128, stage_channels=(128, 256, 512, 1024), stage_blocks=(2, 6, 14, 2),
                                   num_heads=(4, 8, 16, 32)), **kwargs})


def maxvit_xlarge_encoder(**kwargs) -> MaxViTEncoder:
    return MaxViTEncoder(**{**dict(stem_channels=192, stage_channels=(192, 384, 768, 1536), stage_blocks=(2, 6, 14, 2),
                                   num_heads=(6, 12, 24, 48)), **kwargs})
