"""Swin Transformer encoders (arXiv:2103.14030; counterpart of
``pytorch_toolbelt_tpu/zoo/encoders/swin.py``).

Inside the encoder the maps are ``[B, H, W, C]`` tensors, so the ``Linear``
layers and ``LayerNorm`` act on the last dim; the stages return NCHW
feature maps (views in the channels_last memory format).  Each block pads
its map to a multiple of the window, and windows become the batch of plain
attention.  The shifted-window mask and the relative-position index are
numpy arrays built once per shape, and each is copied to a device once.

Conventions kept from the JAX package:

* ``LayerNorm`` epsilon 1e-6 (flax's) and the tanh GELU;
* a block shifts only where ``min(h, w) > window_size``;
* ``PatchMerging`` concatenates the 2x2 neighbours in (p1 p2 c) order,
  (0, 0), (0, 1), (1, 0), (1, 1), where the reference takes (0, 0), (1, 0),
  (0, 1), (1, 1);
* the 4x4 patch embedding is a flax ``SAME`` conv (``Conv2dSame``).
"""

from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.drop_path import DropPath
from ...nn.simple import Conv2dSame
from .common import EncoderBase, _remat, _take

__all__ = [
    "PatchMerging",
    "SwinBlock",
    "SwinTransformerEncoder",
    "WindowAttention",
    "swin_base_encoder",
    "swin_large_encoder",
    "swin_small_encoder",
    "swin_tiny_encoder",
]

LN_EPS = 1e-6  # flax's LayerNorm epsilon


@lru_cache(maxsize=None)
def _relative_position_index(ws: int) -> np.ndarray:
    """[N, N] index into the (2 ws - 1)^2 bias table, N = ws^2."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))  # [2, ws, ws]
    coords_flat = coords.reshape(2, -1)
    relative = (coords_flat[:, :, None] - coords_flat[:, None, :]).transpose(1, 2, 0)  # [N, N, 2]
    relative[:, :, 0] += ws - 1
    relative[:, :, 1] += ws - 1
    relative[:, :, 0] *= 2 * ws - 1
    return relative.sum(-1)


@lru_cache(maxsize=None)
def _shift_attn_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """[num_windows, N, N] additive mask (0 or -100) for shifted-window
    attention on an (hp, wp) map padded to window multiples."""
    img_mask = np.zeros((hp, wp))
    cnt = 0
    for h_slice in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w_slice in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[h_slice, w_slice] = cnt
            cnt += 1
    windows = img_mask.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = windows[:, None, :] - windows[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@lru_cache(maxsize=64)
def _on_device(array_fn, args: tuple, device: torch.device) -> torch.Tensor:
    """``array_fn(*args)`` copied to ``device`` once."""
    return torch.from_numpy(array_fn(*args)).to(device)


class WindowAttention(nn.Module):
    """Multi-head attention inside each window, with a learned relative
    position bias (the raw parameter ``relative_position_bias``,
    [(2 ws - 1)^2, heads]) and an optional additive mask per window."""

    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias = nn.Parameter(
            nn.init.trunc_normal_(torch.empty((2 * window_size - 1) ** 2, num_heads), std=0.02))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:  # x: [B*nw, N, C]
        bnw, n, c = x.shape
        head_dim = c // self.num_heads
        q, k, v = self.qkv(x).reshape(bnw, n, 3, self.num_heads, head_dim).permute(2, 0, 3, 1, 4)
        attn = torch.matmul(q, k.transpose(-2, -1)) * (head_dim**-0.5)
        index = _on_device(_relative_position_index, (self.window_size,), x.device)
        bias = self.relative_position_bias[index.reshape(-1)].reshape(n, n, self.num_heads).permute(2, 0, 1)
        attn = attn + bias.to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bnw // nw, nw, self.num_heads, n, n) + mask[None, :, None].to(attn.dtype)).reshape(
                bnw, self.num_heads, n, n)
        out = torch.matmul(attn.softmax(dim=-1), v)
        return self.proj(out.transpose(1, 2).reshape(bnw, n, c))


class SwinBlock(nn.Module):
    """(Shifted-)window attention and an MLP, each pre-norm and residual.
    ``forward`` takes and returns [B, H, W, C]."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift: bool = False, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.drop_path = DropPath(drop_path_rate, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws = self.window_size
        shift = ws // 2 if (self.shift and min(h, w) > ws) else 0
        pad_h, pad_w = (-h) % ws, (-w) % ws
        hp, wp = h + pad_h, w + pad_w
        y = self.norm1(x)
        if pad_h or pad_w:
            y = F.pad(y, (0, 0, 0, pad_w, 0, pad_h))
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = _on_device(_shift_attn_mask, (hp, wp, ws, shift), x.device)
        nh, nw = hp // ws, wp // ws
        windows = y.reshape(b, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b * nh * nw, ws * ws, c)
        windows = self.attn(windows, mask=mask)
        y = windows.reshape(b, nh, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        if pad_h or pad_w:
            y = y[:, :h, :w]
        x = x + self.drop_path(y)
        y = self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="tanh"))
        return x + self.drop_path(y)


class PatchMerging(nn.Module):
    """2x2 neighbourhood concat in (p1 p2 c) order -> LayerNorm -> Linear to
    twice the channels, no bias.  [B, H, W, C] -> [B, ceil(H/2), ceil(W/2), 2C]."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        h2, w2 = (h + 1) // 2, (w + 1) // 2
        x = x.reshape(b, h2, 2, w2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h2, w2, 4 * c)
        return self.reduction(self.norm(x))


class SwinTransformerEncoder(EncoderBase):
    """4x4 patch embedding + LayerNorm, then per stage its Swin blocks
    (every second one shifted), a LayerNorm for the stage's output and, but
    after the last stage, a ``PatchMerging``.  Feature maps at strides 4, 8,
    16, 32.  ``use_remat`` recomputes each block's activations on the
    backward pass (``torch.utils.checkpoint``, flax's ``nn.remat``).
    ``in_channels`` is new here (flax infers it); ``generator`` is the
    drop-path masks' ``torch.Generator``."""

    def __init__(
        self,
        embed_dim: int = 96,
        depths: Sequence[int] = (2, 2, 6, 2),
        num_heads: Sequence[int] = (3, 6, 12, 24),
        window_size: int = 7,
        mlp_ratio: float = 4.0,
        drop_path_rate: float = 0.0,
        layers: Optional[Tuple[int, ...]] = None,
        use_remat: bool = False,
        in_channels: int = 3,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.layers = None if layers is None else tuple(layers)
        self.use_remat = use_remat
        self.generator = generator
        self.patch_embed = Conv2dSame(in_channels, embed_dim, 4, stride=4)
        self.patch_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        total = sum(self.depths)
        self.blocks = nn.ModuleList()
        self.norms = nn.ModuleList()
        self.merges = nn.ModuleList()
        index = 0
        for stage, depth in enumerate(self.depths):
            dim = embed_dim * 2**stage
            stage_blocks = nn.ModuleList()
            for i in range(depth):
                rate = drop_path_rate * index / max(1, total - 1)
                stage_blocks.append(SwinBlock(dim, num_heads[stage], window_size, i % 2 == 1, mlp_ratio, rate,
                                              generator))
                index += 1
            self.blocks.append(stage_blocks)
            self.norms.append(nn.LayerNorm(dim, eps=LN_EPS))
            if stage != len(self.depths) - 1:
                self.merges.append(PatchMerging(dim))

    def get_output_spec(self) -> FeatureMapsSpec:
        channels = tuple(self.embed_dim * 2**i for i in range(len(self.depths)))
        strides = tuple(4 * 2**i for i in range(len(self.depths)))
        if self.layers is not None:
            channels, strides = _take(channels, self.layers), _take(strides, self.layers)
        return FeatureMapsSpec(channels, strides)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.patch_norm(self.patch_embed(x).permute(0, 2, 3, 1))
        outputs = []
        for stage, (blocks, norm) in enumerate(zip(self.blocks, self.norms)):
            for block in blocks:
                x = _remat(block, self.generator, x) if self.use_remat and torch.is_grad_enabled() else block(x)
            outputs.append(norm(x).permute(0, 3, 1, 2))
            if stage < len(self.merges):
                x = self.merges[stage](x)
        return outputs if self.layers is None else _take(outputs, self.layers)


def swin_tiny_encoder(**kwargs) -> SwinTransformerEncoder:
    return SwinTransformerEncoder(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24), **kwargs)


def swin_small_encoder(**kwargs) -> SwinTransformerEncoder:
    return SwinTransformerEncoder(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24), **kwargs)


def swin_base_encoder(**kwargs) -> SwinTransformerEncoder:
    return SwinTransformerEncoder(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), **kwargs)


def swin_large_encoder(**kwargs) -> SwinTransformerEncoder:
    return SwinTransformerEncoder(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48), **kwargs)
