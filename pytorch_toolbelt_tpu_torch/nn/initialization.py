"""Initialisers (counterpart of ``pytorch_toolbelt_tpu/nn/initialization.py``).
Each fills a torch weight or bias in place and returns it; JAX's build an
HWIO array (or a bias) from a key."""

import math
from typing import Callable

import torch
from torch import nn

__all__ = ["bilinear_upsample_initializer", "first_class_background_init_bias", "icnr_init", "zeros_kernel_init"]


def _logit(p: float) -> float:
    return math.log(p / (1.0 - p))


@torch.no_grad()
def zeros_kernel_init(weight: torch.Tensor) -> torch.Tensor:
    return weight.zero_()


def first_class_background_init_bias(background_prob: float = 0.95) -> Callable:
    """Bias initialiser [logit(bg), logit(fg), logit(fg), ...] with
    bg = ``background_prob`` and fg = 1 - bg, for detection-style heads.
    Pair it with ``zeros_kernel_init`` on the weight."""

    @torch.no_grad()
    def init(bias: torch.Tensor) -> torch.Tensor:
        bias.fill_(_logit(1.0 - background_prob))
        bias[0] = _logit(background_prob)
        return bias

    return init


@torch.no_grad()
def bilinear_upsample_initializer(weight: torch.Tensor) -> torch.Tensor:
    """The radial tent of a transposed-conv upsampler, the same in every
    (in, out) slice of a ``[*, *, kh, kw]`` weight: one minus the distance
    from the kernel's centre over the sum of distances, normalised to unit
    mass."""
    h, w = weight.shape[-2:]
    ii = torch.arange(h, dtype=torch.float32)[:, None]
    jj = torch.arange(w, dtype=torch.float32)[None, :]
    dist = torch.hypot(h // 2 - ii, w // 2 - jj)
    y = 1.0 - dist / dist.sum()
    return weight.copy_((y / y.sum()).expand_as(weight))


def icnr_init(upscale_factor: int = 2, base_init: Callable = nn.init.kaiming_normal_) -> Callable:
    """ICNR (arXiv:1707.02937): an initialiser for the OIHW weight of a conv
    that feeds a pixel shuffle by ``upscale_factor``.  ``base_init`` fills
    one [O / n, I, kh, kw] sub-kernel, n = upscale_factor**2, and each of its
    output channels is repeated n times in a row along O, so all n channels
    that the shuffle spreads over one output pixel's neighbourhood start
    equal."""
    n = upscale_factor * upscale_factor

    @torch.no_grad()
    def init(weight: torch.Tensor) -> torch.Tensor:
        sub = torch.empty((weight.shape[0] // n,) + tuple(weight.shape[1:]), dtype=weight.dtype)
        base_init(sub)
        return weight.copy_(sub.repeat_interleave(n, dim=0))

    return init
