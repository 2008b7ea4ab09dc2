"""Model-building contracts for encoder/decoder/head composition
(counterpart of ``pytorch_toolbelt_tpu/core/interfaces.py``).

An encoder maps an image batch to a list of feature maps ordered fine ->
coarse, a decoder maps that list to a new list, a head maps the list to the
task output.  Feature maps are NCHW.
"""

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["FeatureMapsSpec", "FeatureMapsSpecification"]


@dataclasses.dataclass(frozen=True)
class FeatureMapsSpec:
    """(channels, strides) description of a feature pyramid."""

    channels: Tuple[int, ...]
    strides: Tuple[int, ...]

    def __init__(self, channels: Sequence[int], strides: Sequence[int]):
        if len(channels) != len(strides):
            raise ValueError(
                f"Length of channels ({len(channels)}) must be equal to "
                f"length of strides ({len(strides)})"
            )
        object.__setattr__(self, "channels", tuple(int(c) for c in channels))
        object.__setattr__(self, "strides", tuple(int(s) for s in strides))

    def get_index_of_largest_feature_map(self) -> int:
        """0-based index of the spatially largest map (smallest stride)."""
        return int(np.argmin(self.strides))

    def get_dummy_input(
        self, image_size: Tuple[int, int] = (640, 512), dtype=torch.float32, device=None
    ) -> List[torch.Tensor]:
        """List of zero NCHW feature maps matching this spec (batch of 1)."""
        rows, cols = image_size
        return [
            torch.zeros((1, c, rows // s, cols // s), dtype=dtype, device=device)
            for c, s in zip(self.channels, self.strides)
        ]

    def __len__(self) -> int:
        return len(self.channels)


FeatureMapsSpecification = FeatureMapsSpec
