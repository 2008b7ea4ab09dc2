"""CoordConv (arXiv:1807.03247; counterpart of ``pytorch_toolbelt_tpu/nn/coord_conv.py``).

NCHW: the coordinate channels are appended on dim 1, rows then columns
(then the radius).
"""

import torch
from torch import nn

from .simple import Conv2dSame

__all__ = ["AddCoords", "CoordConv", "append_coords"]


def append_coords(input_tensor: torch.Tensor, with_r: bool = False) -> torch.Tensor:
    """Append row and column coordinates in [-1, 1] (and, ``with_r``, the
    distance from (0.5, 0.5)) as channels, in the input's dtype."""
    b, _, h, w = input_tensor.shape
    kwargs = dict(dtype=input_tensor.dtype, device=input_tensor.device)
    rr = torch.linspace(-1.0, 1.0, h, **kwargs)[:, None].expand(h, w)
    cc = torch.linspace(-1.0, 1.0, w, **kwargs)[None, :].expand(h, w)
    extra = [rr, cc]
    if with_r:
        extra.append(torch.sqrt(torch.square(rr - 0.5) + torch.square(cc - 0.5)))
    extra = torch.stack(extra)[None].expand(b, len(extra), h, w)
    return torch.cat([input_tensor, extra], dim=1)


class AddCoords(nn.Module):
    def __init__(self, with_r: bool = False):
        super().__init__()
        self.with_r = with_r

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return append_coords(x, self.with_r)


class CoordConv(nn.Module):
    """``append_coords`` then a flax ``SAME`` conv.  ``in_channels`` (without
    the coordinates) is new here: flax infers it."""

    def __init__(self, in_channels: int, out_channels: int, with_r: bool = False, kernel_size=(3, 3)):
        super().__init__()
        self.with_r = with_r
        self.conv = Conv2dSame(in_channels + 2 + int(with_r), out_channels, tuple(kernel_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(append_coords(x, self.with_r))
