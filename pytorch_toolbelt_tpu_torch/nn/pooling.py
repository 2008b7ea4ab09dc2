"""Global pooling zoo (counterpart of ``pytorch_toolbelt_tpu/nn/pooling.py``).

Every module takes NCHW and returns [B, C, 1, 1], or [B, C] with
``flatten=True``.  The modules with a conv take the input's channels, which
flax infers.  The raw parameters keep flax's names and shapes:
``GlobalKMaxPool2d.weights`` (1, 1, k), ``GlobalRankPooling.weights`` (C,
spatial_size), ``GeneralizedMeanPooling2d.p`` (1,).  ``jax.lax.top_k`` is
``torch.topk(..., sorted=True)``: the largest first.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .normalization import BN_MOMENTUM, BatchNorm2d

__all__ = [
    "GWAP",
    "GeneralizedMeanPooling2d",
    "GlobalAvgPool2d",
    "GlobalKMaxPool2d",
    "GlobalMaxAvgPooling2d",
    "GlobalMaxPool2d",
    "GlobalRankPooling",
    "GlobalWeightedAvgPool2d",
    "MILCustomPoolingModule",
    "RMSPool",
]


def _maybe_flatten(x: torch.Tensor, flatten: bool) -> torch.Tensor:
    return x[:, :, 0, 0] if flatten else x


class GlobalAvgPool2d(nn.Module):
    def __init__(self, flatten: bool = False):
        super().__init__()
        self.flatten = flatten

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _maybe_flatten(x.mean(dim=(2, 3), keepdim=True), self.flatten)


class GlobalMaxPool2d(nn.Module):
    def __init__(self, flatten: bool = False):
        super().__init__()
        self.flatten = flatten

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _maybe_flatten(x.amax(dim=(2, 3), keepdim=True), self.flatten)


class GlobalKMaxPool2d(nn.Module):
    """Mean of the weighted top-k activations per channel (arXiv:1911.07344)."""

    def __init__(self, k: int = 4, trainable: bool = True, flatten: bool = False):
        super().__init__()
        self.k = k
        self.flatten = flatten
        self.weights = nn.Parameter(torch.ones(1, 1, k)) if trainable else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kmax = torch.topk(x.flatten(2), self.k, dim=-1, sorted=True).values  # [B, C, k]
        if self.weights is not None:
            kmax = kmax * self.weights
        kmax = kmax.mean(dim=2)
        return kmax if self.flatten else kmax[:, :, None, None]


class GlobalWeightedAvgPool2d(nn.Module):
    """GWAP: a 1x1 conv predicts a score map; exp(sigmoid(score)),
    normalized over the map, weighs the average."""

    def __init__(self, in_channels: int, flatten: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, 1, 1)
        self.flatten = flatten

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = torch.exp(torch.sigmoid(self.conv(x)))
        m = m / m.sum(dim=(2, 3), keepdim=True)
        return _maybe_flatten((x * m).sum(dim=(2, 3), keepdim=True), self.flatten)


GWAP = GlobalWeightedAvgPool2d


class RMSPool(nn.Module):
    """Root-mean-square (std) pooling: [B, C, 1, 1]."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_mean = x.mean(dim=(2, 3), keepdim=True)
        return (x - x_mean).square().mean(dim=(2, 3), keepdim=True).sqrt()


class MILCustomPoolingModule(nn.Module):
    """Multiple-instance-learning pooling: a sigmoid weight branch
    (norm -> 1x1 conv -> relu -> 1x1 conv) gating a 1x1 classifier branch;
    returns [B, out_channels]."""

    def __init__(self, in_channels: int, out_channels: int, reduction: int = 4):
        super().__init__()
        self.bn = BatchNorm2d(in_channels, momentum=BN_MOMENTUM)
        self.weight_conv1 = nn.Conv2d(in_channels, in_channels // reduction, 1)
        self.weight_conv2 = nn.Conv2d(in_channels // reduction, out_channels, 1)
        self.classifier = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = torch.sigmoid(self.weight_conv2(F.relu(self.weight_conv1(self.bn(x)))))
        logits = self.classifier(x)
        return (w * logits).sum(dim=(2, 3)) / (w.sum(dim=(2, 3)) + 1e-6)


class GlobalRankPooling(nn.Module):
    """Learnable weighting over rank-sorted activations (arXiv:1704.02112)."""

    def __init__(self, in_channels: int, spatial_size: int, flatten: bool = False):
        super().__init__()
        self.spatial_size = spatial_size
        self.flatten = flatten
        self.weights = nn.Parameter(torch.empty(in_channels, spatial_size))
        nn.init.normal_(self.weights, std=in_channels**-0.5)  # LeCun normal, as flax initialises it

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2:]
        if h * w != self.spatial_size:
            raise ValueError(f"Expected spatial size {self.spatial_size}, got {h}x{w}")
        x_sorted = torch.topk(x.flatten(2), self.spatial_size, dim=-1, sorted=True).values  # descending
        out = (x_sorted * self.weights).sum(dim=-1)
        return out if self.flatten else out[:, :, None, None]


class GeneralizedMeanPooling2d(nn.Module):
    """GeM pooling with a softplus-parameterized exponent
    (arXiv:1902.05509): (mean(max(x, eps)^p))^(1/p), p = softplus(raw) + 1."""

    def __init__(self, p: float = 3.0, eps: float = 1e-6, flatten: bool = False, l2_normalize: bool = False):
        super().__init__()
        self.p = nn.Parameter(torch.full((1,), float(p)))
        self.eps = eps
        self.flatten = flatten
        self.l2_normalize = l2_normalize

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = F.softplus(self.p) + 1.0
        out = x.clamp(min=self.eps).pow(p).mean(dim=(2, 3), keepdim=True).pow(1.0 / p)
        if self.l2_normalize:
            out = out / torch.linalg.vector_norm(out, dim=1, keepdim=True).clamp(min=1e-12)
        return _maybe_flatten(out, self.flatten)


class GlobalMaxAvgPooling2d(nn.Module):
    """Concat of global max and global average pooling -> [B, 2C]; flattened
    whatever ``flatten`` says, as in the JAX package."""

    def __init__(self, flatten: bool = True):
        super().__init__()
        self.flatten = flatten

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x.amax(dim=(2, 3)), x.mean(dim=(2, 3))], dim=1)
