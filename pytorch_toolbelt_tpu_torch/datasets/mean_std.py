"""Streaming dataset mean/std (counterpart of
``pytorch_toolbelt_tpu/datasets/mean_std.py``)."""

from typing import Optional, Tuple

import numpy as np

__all__ = ["DatasetMeanStdCalculator"]


class DatasetMeanStdCalculator:
    """Running per-channel mean/std/min/max over images that don't fit in RAM."""

    __slots__ = ["global_mean", "global_var", "n_items", "num_channels", "global_max", "global_min", "dtype"]

    def __init__(self, num_channels: int = 3, dtype=np.float64):
        self.num_channels = num_channels
        self.dtype = dtype
        self.reset()

    def reset(self) -> None:
        self.global_mean = np.zeros(self.num_channels, dtype=self.dtype)
        self.global_var = np.zeros(self.num_channels, dtype=self.dtype)
        self.global_max = np.full(self.num_channels, float("-inf"), dtype=self.dtype)
        self.global_min = np.full(self.num_channels, float("+inf"), dtype=self.dtype)
        self.n_items = 0

    def accumulate(self, image: np.ndarray, mask: Optional[np.ndarray] = None) -> None:
        """image HWC (C == num_channels); optional boolean mask selects pixels."""
        if image.ndim == 2:
            image = np.expand_dims(image, axis=-1)
        if self.num_channels != image.shape[2]:
            raise RuntimeError(
                f"Number of channels in image must be {self.num_channels}, got {image.shape[2]}."
            )
        image = image.reshape((-1, self.num_channels))

        if mask is not None:
            image = image[mask.reshape(-1).astype(bool), :]
            if len(image) == 0:
                return

        self.global_mean += np.squeeze(np.mean(image, axis=0))
        self.global_var += np.squeeze(np.std(image, axis=0)) ** 2
        self.global_max = np.maximum(self.global_max, np.max(image, axis=0))
        self.global_min = np.minimum(self.global_min, np.min(image, axis=0))
        self.n_items += 1

    def compute(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.global_mean / self.n_items, np.sqrt(self.global_var / self.n_items)
