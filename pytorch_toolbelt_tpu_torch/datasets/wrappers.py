"""Dataset wrappers (counterpart of ``pytorch_toolbelt_tpu/datasets/wrappers.py``).

Any object with ``__len__``/``__getitem__`` works: a torch ``Dataset``, a list."""

import random
from typing import Any, Optional

import numpy as np

__all__ = ["RandomSubsetDataset", "RandomSubsetWithMaskDataset"]


class RandomSubsetDataset:
    """Draw ``num_samples`` random (optionally weighted) samples per epoch."""

    def __init__(self, dataset, num_samples: int, weights: Optional[np.ndarray] = None):
        if weights is not None and len(dataset) != len(weights):
            raise ValueError(
                f"Length of weights must be equal to length of dataset. Got {len(weights)} and {len(dataset)}"
            )
        self.dataset = dataset
        self.num_samples = num_samples
        self.weights = np.cumsum(weights) if weights is not None else None

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, _) -> Any:
        if self.weights is not None:
            index = random.choices(range(len(self.dataset)), cum_weights=self.weights, k=1)[0]
        else:
            index = random.randrange(len(self.dataset))
        return self.dataset[index]

    def get_collate_fn(self):
        get_collate_fn = getattr(self.dataset, "get_collate_fn", None)
        if callable(get_collate_fn):
            return get_collate_fn()
        return None


class RandomSubsetWithMaskDataset:
    """Like RandomSubsetDataset but samples only where mask[i] is True."""

    def __init__(self, dataset, mask: np.ndarray, num_samples: int):
        if (
            not isinstance(mask, np.ndarray)
            or mask.dtype != bool
            or mask.ndim != 1
            or len(mask) != len(dataset)
        ):
            raise ValueError("Mask must be boolean 1-D numpy array")
        if not mask.any():
            raise ValueError("Mask must have at least one positive value")
        self.dataset = dataset
        self.mask = mask
        self.num_samples = num_samples
        self.indexes = np.flatnonzero(mask)

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, _) -> Any:
        return self.dataset[random.choice(self.indexes)]

    def get_collate_fn(self):
        get_collate_fn = getattr(self.dataset, "get_collate_fn", None)
        if callable(get_collate_fn):
            return get_collate_fn()
        return None
