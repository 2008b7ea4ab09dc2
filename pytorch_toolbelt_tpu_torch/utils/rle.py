"""Kaggle run-length encoding (counterpart of ``pytorch_toolbelt_tpu/utils/rle.py``, whose
numpy code it copies; parity target: pytorch_toolbelt/utils/rle.py:6-39)."""

import numpy as np

__all__ = ["rle_decode", "rle_encode", "rle_to_string"]


def rle_encode(mask: np.ndarray) -> np.ndarray:
    """Binary mask -> run-length pairs (1-indexed, column-major)."""
    pixels = mask.T.flatten()
    use_padding = False
    if pixels[0] or pixels[-1]:
        use_padding = True
        padded = np.zeros(len(pixels) + 2, dtype=pixels.dtype)
        padded[1:-1] = pixels
        pixels = padded
    rle = np.where(pixels[1:] != pixels[:-1])[0] + 2
    if use_padding:
        rle = rle - 1
    rle[1::2] = rle[1::2] - rle[:-1:2]
    return rle


def rle_to_string(runs) -> str:
    return " ".join(str(x) for x in runs)


def rle_decode(rle_str: str, shape, dtype=np.uint8) -> np.ndarray:
    s = rle_str.split()
    starts, lengths = (np.asarray(x, dtype=int) for x in (s[0:][::2], s[1:][::2]))
    starts = starts - 1
    ends = starts + lengths
    mask = np.zeros(int(np.prod(shape)), dtype=dtype)
    for lo, hi in zip(starts, ends):
        mask[lo:hi] = 1
    return mask.reshape(shape[::-1]).T
