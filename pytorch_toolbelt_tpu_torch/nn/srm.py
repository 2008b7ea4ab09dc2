"""Style-based Recalibration Module (counterpart of ``pytorch_toolbelt_tpu/nn/srm.py``)."""

import torch
from torch import nn

from .normalization import BN_MOMENTUM, BatchNorm1d

__all__ = ["SRMLayer"]


class SRMLayer(nn.Module):
    """Style pooling (per-channel mean and unbiased std) -> per-channel linear
    style integration (the raw parameter ``cfc``, [C, 2]) -> BatchNorm on
    [B, C] -> sigmoid gate.  ``channels`` is new here: flax infers it."""

    def __init__(self, channels: int):
        super().__init__()
        self.cfc = nn.Parameter(torch.randn(channels, 2) * channels**-0.5)  # LeCun-normal, fan-in C as flax takes it
        self.bn = BatchNorm1d(channels, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.flatten(2)
        u = torch.stack([flat.mean(dim=2), flat.std(dim=2, correction=1)], dim=-1)  # [B, C, 2]
        z = self.bn((u * self.cfc[None]).sum(dim=-1))
        return x * torch.sigmoid(z)[:, :, None, None]
