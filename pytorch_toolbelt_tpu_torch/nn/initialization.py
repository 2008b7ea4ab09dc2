"""The initialisers the upsample layers use (counterpart of part of
``pytorch_toolbelt_tpu/nn/initialization.py``).  Each fills a torch weight
in place and returns it; JAX's build an HWIO array from a key."""

from typing import Callable

import torch
from torch import nn

__all__ = ["bilinear_upsample_initializer", "icnr_init"]


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
