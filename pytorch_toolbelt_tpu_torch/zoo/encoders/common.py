"""Encoder base (counterpart of ``pytorch_toolbelt_tpu/zoo/encoders/common.py``).

An encoder's ``forward`` returns a list of NCHW feature maps ordered fine ->
coarse, and ``get_output_spec()`` describes them without a forward pass.
"""

from typing import Tuple

from torch import nn

from ...core.interfaces import FeatureMapsSpec

__all__ = ["EncoderBase"]


class EncoderBase(nn.Module):
    """Base class for encoders: list-of-feature-maps contract."""

    def get_output_spec(self) -> FeatureMapsSpec:
        raise NotImplementedError

    @property
    def channels(self) -> Tuple[int, ...]:
        return self.get_output_spec().channels

    @property
    def strides(self) -> Tuple[int, ...]:
        return self.get_output_spec().strides
