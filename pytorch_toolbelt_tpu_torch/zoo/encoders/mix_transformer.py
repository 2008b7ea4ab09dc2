"""MixVisionTransformer (SegFormer MiT-B0..B5) encoders (arXiv:2105.15203;
counterpart of ``pytorch_toolbelt_tpu/zoo/encoders/mix_transformer.py``).

Inside a stage the tokens are ``[B, N, C]`` (N = h * w, row-major), so the
``Linear`` projections and ``LayerNorm`` act on the last dim; the stages
return NCHW feature maps (views of the tokens in the channels_last memory
format).  Attention is two ``torch.matmul`` and a softmax over the heads,
with the keys and values spatially reduced by a strided conv (``sr_ratio``).

Conventions kept from the JAX package:

* every ``LayerNorm`` has flax's epsilon of 1e-6 (torch's default is 1e-5);
* GELU is the tanh approximation (``jax.nn.gelu``'s default);
* the patch embeddings (7x7 stride 4, then 3x3 stride 2) and the spatial
  reduction are flax ``SAME`` convs (``Conv2dSame``): on 512^2 the 7x7/4
  pads (1, 2), where the reference pads ``patch_size // 2`` = 3 on each side.
"""

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.drop_path import DropPath
from ...nn.simple import Conv2dSame
from .common import EncoderBase, _remat, _take

__all__ = [
    "EfficientSelfAttention",
    "MiTBlock",
    "MixFFN",
    "MixVisionTransformerEncoder",
    "OverlapPatchEmbed",
    "mit_b0_encoder",
    "mit_b1_encoder",
    "mit_b2_encoder",
    "mit_b3_encoder",
    "mit_b4_encoder",
    "mit_b5_encoder",
]

LN_EPS = 1e-6  # flax's LayerNorm epsilon


def _to_map(tokens: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """[B, h * w, C] tokens -> an NCHW view of them (channels_last strides)."""
    b, _, c = tokens.shape
    return tokens.transpose(1, 2).reshape(b, c, hw[0], hw[1])


def _to_tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> [B, h * w, C]."""
    return x.flatten(2).transpose(1, 2)


class OverlapPatchEmbed(nn.Module):
    """Strided ``SAME`` conv patch embedding with overlap, then LayerNorm.
    Returns the tokens and the map's (h, w)."""

    def __init__(self, in_channels: int, embed_dim: int, patch_size: int, stride: int):
        super().__init__()
        self.proj = Conv2dSame(in_channels, embed_dim, patch_size, stride=stride)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
        x = self.proj(x)
        return self.norm(_to_tokens(x)), (x.shape[2], x.shape[3])


class EfficientSelfAttention(nn.Module):
    """Multi-head attention with the keys and values taken from a map
    reduced ``sr_ratio`` times by a strided conv + LayerNorm.  Children in
    flax's creation order: q, sr, its norm, k, v, proj."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv2dSame(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        else:
            self.sr = self.norm = None
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        b, n, c = x.shape
        head_dim = c // self.num_heads
        q = self.q(x).reshape(b, n, self.num_heads, head_dim).transpose(1, 2)
        kv = x if self.sr is None else self.norm(_to_tokens(self.sr(_to_map(x, hw))))
        k = self.k(kv).reshape(b, -1, self.num_heads, head_dim).transpose(1, 2)
        v = self.v(kv).reshape(b, -1, self.num_heads, head_dim).transpose(1, 2)
        attn = torch.matmul(q, k.transpose(-2, -1)) * (head_dim**-0.5)
        out = torch.matmul(attn.softmax(dim=-1), v)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class MixFFN(nn.Module):
    """Linear -> 3x3 depthwise conv -> GELU (tanh) -> Linear."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.dwconv = Conv2dSame(hidden_dim, hidden_dim, 3, groups=hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        y = _to_tokens(self.dwconv(_to_map(self.fc1(x), hw)))
        return self.fc2(F.gelu(y, approximate="tanh"))


class MiTBlock(nn.Module):
    """Pre-norm transformer block: x + attn(LN(x)), then x + ffn(LN(x)), each
    branch through one ``DropPath``."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int, mlp_ratio: int = 4, drop_path_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = EfficientSelfAttention(dim, num_heads, sr_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ffn = MixFFN(dim, dim * mlp_ratio)
        self.drop_path = DropPath(drop_path_rate, generator=generator)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x), hw))
        return x + self.drop_path(self.ffn(self.norm2(x), hw))


class MixVisionTransformerEncoder(EncoderBase):
    """Four stages of (overlapping patch embedding, MiT blocks, LayerNorm);
    feature maps at strides 4, 8, 16, 32.  The drop-path rate grows linearly
    over the blocks of all stages.  ``use_remat`` recomputes each block's
    activations on the backward pass (``torch.utils.checkpoint``, flax's
    ``nn.remat``).  ``in_channels`` is new here (flax infers it);
    ``generator`` is the drop-path masks' ``torch.Generator``."""

    def __init__(
        self,
        embed_dims: Sequence[int] = (32, 64, 160, 256),
        depths: Sequence[int] = (2, 2, 2, 2),
        num_heads: Sequence[int] = (1, 2, 5, 8),
        sr_ratios: Sequence[int] = (8, 4, 2, 1),
        mlp_ratios: Sequence[int] = (4, 4, 4, 4),
        drop_path_rate: float = 0.0,
        layers: Optional[Tuple[int, ...]] = None,
        use_remat: bool = False,
        in_channels: int = 3,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.embed_dims = tuple(embed_dims)
        self.layers = None if layers is None else tuple(layers)
        self.use_remat = use_remat
        self.generator = generator
        total = sum(depths)
        self.patch_embeds = nn.ModuleList()
        self.blocks = nn.ModuleList()
        self.norms = nn.ModuleList()
        prev, index = in_channels, 0
        for stage, dim in enumerate(self.embed_dims):
            patch, stride = (7, 4) if stage == 0 else (3, 2)
            self.patch_embeds.append(OverlapPatchEmbed(prev, dim, patch, stride))
            stage_blocks = nn.ModuleList()
            for _ in range(depths[stage]):
                rate = drop_path_rate * index / max(1, total - 1)
                stage_blocks.append(MiTBlock(dim, num_heads[stage], sr_ratios[stage], mlp_ratios[stage], rate,
                                             generator))
                index += 1
            self.blocks.append(stage_blocks)
            self.norms.append(nn.LayerNorm(dim, eps=LN_EPS))
            prev = dim

    def get_output_spec(self) -> FeatureMapsSpec:
        channels, strides = self.embed_dims, (4, 8, 16, 32)
        if self.layers is not None:
            channels, strides = _take(channels, self.layers), _take(strides, self.layers)
        return FeatureMapsSpec(channels, strides)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outputs = []
        for embed, blocks, norm in zip(self.patch_embeds, self.blocks, self.norms):
            tokens, hw = embed(x)
            for block in blocks:
                if self.use_remat and torch.is_grad_enabled():
                    tokens = _remat(block, self.generator, tokens, hw)
                else:
                    tokens = block(tokens, hw)
            x = _to_map(norm(tokens), hw)
            outputs.append(x)
        return outputs if self.layers is None else _take(outputs, self.layers)


def mit_b0_encoder(**kwargs) -> MixVisionTransformerEncoder:
    return MixVisionTransformerEncoder(embed_dims=(32, 64, 160, 256), depths=(2, 2, 2, 2), **kwargs)


def mit_b1_encoder(**kwargs) -> MixVisionTransformerEncoder:
    return MixVisionTransformerEncoder(embed_dims=(64, 128, 320, 512), depths=(2, 2, 2, 2), **kwargs)


def mit_b2_encoder(**kwargs) -> MixVisionTransformerEncoder:
    return MixVisionTransformerEncoder(embed_dims=(64, 128, 320, 512), depths=(3, 4, 6, 3), **kwargs)


def mit_b3_encoder(**kwargs) -> MixVisionTransformerEncoder:
    return MixVisionTransformerEncoder(embed_dims=(64, 128, 320, 512), depths=(3, 4, 18, 3), **kwargs)


def mit_b4_encoder(**kwargs) -> MixVisionTransformerEncoder:
    return MixVisionTransformerEncoder(embed_dims=(64, 128, 320, 512), depths=(3, 8, 27, 3), **kwargs)


def mit_b5_encoder(**kwargs) -> MixVisionTransformerEncoder:
    return MixVisionTransformerEncoder(embed_dims=(64, 128, 320, 512), depths=(3, 6, 40, 3), **kwargs)
