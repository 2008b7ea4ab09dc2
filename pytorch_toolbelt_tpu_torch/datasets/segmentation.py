"""Segmentation dataset helpers (counterpart of
``pytorch_toolbelt_tpu/datasets/segmentation.py``).  HWC numpy in and out."""

from functools import partial

import numpy as np

__all__ = ["mask_to_bce_target", "mask_to_ce_target", "read_binary_mask", "compute_weight_mask", "block_reduce_dominant_label"]


def mask_to_bce_target(mask: np.ndarray) -> np.ndarray:
    """HW(1) mask -> float32 HWC target with channel dim."""
    if mask.ndim == 2:
        mask = mask[..., None]
    return mask.astype(np.float32)


def mask_to_ce_target(mask: np.ndarray) -> np.ndarray:
    """HW mask -> int32 HW class-index target."""
    if mask.ndim == 3 and mask.shape[-1] == 1:
        mask = mask[..., 0]
    return mask.astype(np.int32)


def compute_weight_mask(mask: np.ndarray, edge_weight: float = 4) -> np.ndarray:
    """Edge-emphasis weights: boundary band (dilation xor erosion) gets
    edge_weight, blurred (reference segmentation.py:19-47)."""
    from scipy import ndimage

    binary_mask = mask > 0
    weight_mask = np.ones(mask.shape[:2], dtype=np.float32)

    if binary_mask.any():
        structure = np.ones((5, 5), dtype=bool)
        dilated = ndimage.binary_dilation(binary_mask, structure=structure)
        eroded = ndimage.binary_erosion(binary_mask, structure=structure)
        edges = (dilated & ~binary_mask) | (binary_mask & ~eroded)
        weight_mask = edges.astype(np.float32) * edge_weight + 1
        weight_mask = ndimage.gaussian_filter(weight_mask, sigma=5, truncate=0.5)
    return weight_mask


def block_reduce_dominant_label(x: np.ndarray, axis=None) -> np.ndarray:
    """Reduce label blocks to their dominant (most frequent) label
    (reference segmentation.py:50-61)."""
    minlength = int(np.max(x)) + 1
    bincount_fn = partial(np.bincount, minlength=minlength)
    counts = np.apply_along_axis(bincount_fn, -1, x.reshape((x.shape[0], x.shape[1], -1)))
    return np.argmax(counts, axis=-1)


def read_binary_mask(mask_fname: str) -> np.ndarray:
    """Read image as {0, 1} binary mask."""
    try:
        import cv2

        mask = cv2.imread(mask_fname, cv2.IMREAD_GRAYSCALE)
        if mask is None:
            raise FileNotFoundError(f"Cannot find {mask_fname}")
    except ImportError:
        from PIL import Image

        mask = np.asarray(Image.open(mask_fname).convert("L"))
    return (mask > 0).astype(np.uint8)
