"""Tiled inference for 3D volumes (counterpart of
``pytorch_toolbelt_tpu/inference/tiles_3d.py``).

Host side, ``VolumeSlicer`` and the 3D pyramid window are the JAX package's
numpy code (volumes DHW or DHWC there).  Device side, volumes are
``[C, D, H, W]`` tensors: ``VolumeMerger`` accumulates ``[B, C, d, h, w]``
tile batches, and :func:`tiled_apply_3d` runs a model over a volume's tiles
in balanced exact batches and merges them.  The merge is slice-adds in tile
order: the JAX package's 3D merge is a ``lax.scan`` of slice updates, with
no Pallas kernel to port.
"""

import math
from typing import Callable, List, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .tiles import _stack_batches

__all__ = ["VolumeSlicer", "VolumeMerger", "compute_pyramid_patch_weight_loss_3d", "tiled_apply_3d"]


def compute_pyramid_patch_weight_loss_3d(depth: int, height: int, width: int) -> np.ndarray:
    """3D center-weighted window: the separable product of per-axis pyramid
    profiles, scaled to a mean of 1."""

    def axis_profile(n):
        c = n * 0.5
        dc = np.abs(np.arange(n) + 0.5 - c)
        de = np.minimum(np.arange(n) + 0.5, n - np.arange(n) - 0.5)
        return de / np.maximum(dc + de, 1e-6)

    w = (
        axis_profile(depth)[:, None, None]
        * axis_profile(height)[None, :, None]
        * axis_profile(width)[None, None, :]
    )
    alpha = (depth * height * width) / np.sum(w)
    return (alpha * w).astype(np.float32)


class VolumeSlicer:
    """Slice a DHW(C) numpy volume into overlapping 3D tiles; ``crops`` holds
    each tile's (z, y, x, d, h, w) in the padded frame."""

    def __init__(self, volume_shape, voxel_size, voxel_step=0, weight="mean"):
        self.volume_depth = int(volume_shape[0])
        self.volume_height = int(volume_shape[1])
        self.volume_width = int(volume_shape[2])

        def _triple(v):
            if isinstance(v, (np.ndarray, tuple, list)):
                if len(v) != 3:
                    raise ValueError(f"Size must have exactly 3 elements. Got: {v}")
                return int(v[0]), int(v[1]), int(v[2])
            return int(v), int(v), int(v)

        self.voxel_size = _triple(voxel_size)
        self.voxel_step = _triple(voxel_step)

        weights = {"mean": self._mean, "pyramid": self._pyramid}
        self.weight = weight if isinstance(weight, np.ndarray) else weights[weight](self.voxel_size)

        for step, size in zip(self.voxel_step, self.voxel_size):
            if step < 1 or step > size:
                raise ValueError(f"voxel_step {self.voxel_step} must lie in [1, voxel_size {self.voxel_size}]")

        overlap = tuple(size - step for size, step in zip(self.voxel_size, self.voxel_step))
        shape = (self.volume_depth, self.volume_height, self.volume_width)

        margins = []
        for dim, ov, step in zip(shape, overlap, self.voxel_step):
            n = max(1, math.ceil((dim - ov) / step))
            extra = step * n - (dim - ov)
            before = extra // 2
            margins.append((before, extra - before))
        (self.margin_front, self.margin_back), (self.margin_top, self.margin_bottom), (
            self.margin_left,
            self.margin_right,
        ) = margins

        crops = []
        tgt = self.target_shape
        for z in range(0, tgt[0] - self.voxel_size[0] + 1, self.voxel_step[0]):
            for y in range(0, tgt[1] - self.voxel_size[1] + 1, self.voxel_step[1]):
                for x in range(0, tgt[2] - self.voxel_size[2] + 1, self.voxel_step[2]):
                    crops.append((z, y, x) + self.voxel_size)
        self.crops = np.array(crops)

    @property
    def target_shape(self) -> Tuple[int, int, int]:
        return (
            self.volume_depth + self.margin_front + self.margin_back,
            self.volume_height + self.margin_top + self.margin_bottom,
            self.volume_width + self.margin_left + self.margin_right,
        )

    def _pad_volume(self, volume: np.ndarray, value=0) -> np.ndarray:
        pad = [
            (self.margin_front, self.margin_back),
            (self.margin_top, self.margin_bottom),
            (self.margin_left, self.margin_right),
        ]
        if volume.ndim == 4:
            pad.append((0, 0))
        return np.pad(volume, pad, mode="constant", constant_values=value)

    def split(self, volume: np.ndarray, value=0) -> List[np.ndarray]:
        if volume.shape[:3] != (self.volume_depth, self.volume_height, self.volume_width):
            raise ValueError(f"expected a {self.volume_depth}x{self.volume_height}x{self.volume_width} volume, "
                             f"got shape {volume.shape}")
        orig_ndim = volume.ndim
        volume = self._pad_volume(volume, value)
        if volume.ndim != orig_ndim:
            volume = np.expand_dims(volume, axis=-1)
        return [volume[z : z + d, y : y + h, x : x + w] for z, y, x, d, h, w in self.crops]

    def iter_split(self, volume: np.ndarray, value=0):
        yield from zip(self.split(volume, value), self.crops)

    def merge(self, tiles: List[np.ndarray], dtype=np.float32) -> np.ndarray:
        """Host weighted overlap-add (float64 accumulators) of DHW(C) tiles."""
        if len(tiles) != len(self.crops):
            raise ValueError(f"{len(tiles)} tiles for {len(self.crops)} crops")
        channels = 1 if tiles[0].ndim == 3 else tiles[0].shape[3]
        target_shape = self.target_shape + (channels,)
        volume = np.zeros(target_shape, dtype=np.float64)
        norm = np.zeros(target_shape, dtype=np.float64)
        w = np.repeat(self.weight[..., None], channels, axis=-1)
        for tile, (z, y, x, d, h, wd) in zip(tiles, self.crops):
            tile = tile if tile.ndim == 4 else tile[..., None]
            volume[z : z + d, y : y + h, x : x + wd] += tile * w
            norm[z : z + d, y : y + h, x : x + wd] += w
        norm = np.clip(norm, np.finfo(norm.dtype).eps, None)
        return self.crop_to_original_size((volume / norm).astype(dtype))

    def crop_to_original_size(self, volume: Union[np.ndarray, torch.Tensor]):
        """Crop the margins: a DHW(C) numpy array, or a ``[C, D, H, W]``
        tensor such as ``VolumeMerger.merge()`` returns."""
        d = slice(self.margin_front, self.margin_front + self.volume_depth)
        h = slice(self.margin_top, self.margin_top + self.volume_height)
        w = slice(self.margin_left, self.margin_left + self.volume_width)
        if isinstance(volume, torch.Tensor):
            return volume[..., d, h, w]
        return volume[d, h, w]

    def _mean(self, voxel_size) -> np.ndarray:
        return np.ones(voxel_size, dtype=np.float32)

    def _pyramid(self, voxel_size) -> np.ndarray:
        return compute_pyramid_patch_weight_loss_3d(*voxel_size)


class VolumeMerger:
    """Device-resident 3D accumulator of ``[B, C, d, h, w]`` tile batches
    into a ``[C, D, H, W]`` volume.

    The volume lives on ``device``, by default the current CUDA device (it
    raises where there is none); ``device="cpu"`` merges on the CPU.
    """

    def __init__(self, volume_shape, channels: int, weight: np.ndarray, dtype=torch.float32, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "VolumeMerger allocates its volume on CUDA unless told otherwise, and "
                    "torch.cuda.is_available() is false; pass device='cpu' to merge on the CPU"
                )
            device = torch.device("cuda", torch.cuda.current_device())
        self.shape = tuple(int(s) for s in volume_shape)
        self.channels = int(channels)
        self.weight = torch.as_tensor(np.asarray(weight), dtype=dtype, device=device)
        self.volume = torch.zeros((self.channels,) + self.shape, dtype=dtype, device=device)
        self.norm_mask = torch.zeros((1,) + self.shape, dtype=dtype, device=device)

    def accumulate_single(self, tile: torch.Tensor, coords) -> None:
        """tile [C, d, h, w]; coords (z, y, x, d, h, w)."""
        self.integrate_batch(tile[None], np.asarray(coords)[None])

    def integrate_batch(self, batch: torch.Tensor, crop_coords) -> None:
        """batch [B, C, d, h, w]; crop_coords [B, 6] of (z, y, x, d, h, w)."""
        if len(batch) != len(crop_coords):
            raise ValueError("Number of tiles in batch does not correspond to number of coordinates")
        batch = torch.as_tensor(batch).to(device=self.volume.device, dtype=self.volume.dtype)
        td, th, tw = batch.shape[2:]
        for tile, (z, y, x) in zip(batch, np.asarray(crop_coords)[:, :3].tolist()):
            self.volume[:, z : z + td, y : y + th, x : x + tw] += tile * self.weight
            self.norm_mask[:, z : z + td, y : y + th, x : x + tw] += self.weight

    def merge(self) -> torch.Tensor:
        return self.volume / self.norm_mask

    def merge_(self) -> torch.Tensor:
        self.volume = self.volume / self.norm_mask
        return self.volume


def tiled_apply_3d(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    volume: torch.Tensor,
    voxel_size,
    voxel_step,
    weight: str = "pyramid",
    batch_size: int = 2,
    accumulator_dtype=torch.float32,
) -> torch.Tensor:
    """3D counterpart of ``tiled_apply``: run ``model_fn`` over overlapping
    sub-volumes on the volume's device and return the merged prediction.

    Tiles run in balanced exact batches (no padded model slots); each
    prediction is weighted and added into the canvas in tile order, then
    the canvas is multiplied by the inverse of the summed window (summed in
    float64) and the margins are cropped.

    Args:
        model_fn: [B, C, d, h, w] -> [B, K, d, h, w], shape-preserving.
        volume: [C, D, H, W] tensor.

    Returns:
        [K, D, H, W] in ``accumulator_dtype``.
    """
    if volume.ndim != 4:
        raise ValueError(f"volume must be [C, D, H, W], got shape {tuple(volume.shape)}")
    d, h, w = (int(s) for s in volume.shape[1:])
    slicer = VolumeSlicer((d, h, w), voxel_size, voxel_step, weight=weight)
    td, th, tw = slicer.voxel_size
    coords = slicer.crops[:, :3].astype(np.int64)

    weight_np = slicer.weight.astype(np.float32)
    # the summed window in float64 on the device, in tile order: the JAX package's host sums, bit for bit
    weight64 = torch.as_tensor(weight_np, dtype=torch.float64, device=volume.device)
    norm = torch.zeros(slicer.target_shape, dtype=torch.float64, device=volume.device)
    for z, y, x in coords.tolist():
        norm[z : z + td, y : y + th, x : x + tw] += weight64
    inv_norm = (1.0 / norm.clamp_min(np.finfo(np.float64).eps).float())[None]
    weight_dev = torch.as_tensor(weight_np, dtype=accumulator_dtype, device=volume.device)

    padded = F.pad(volume, (slicer.margin_left, slicer.margin_right, slicer.margin_top, slicer.margin_bottom,
                            slicer.margin_front, slicer.margin_back))
    main, rem = _stack_batches(coords, batch_size)
    canvas = None
    for batch in list(main.numpy()) + ([rem.numpy()] if len(rem) else []):
        tiles = torch.stack([padded[:, z : z + td, y : y + th, x : x + tw] for z, y, x in batch.tolist()])
        preds = model_fn(tiles).to(accumulator_dtype)
        if canvas is None:
            canvas = torch.zeros((preds.shape[1],) + slicer.target_shape, dtype=accumulator_dtype,
                                 device=volume.device)
        for pred, (z, y, x) in zip(preds, batch.tolist()):
            canvas[:, z : z + td, y : y + th, x : x + tw] += pred * weight_dev
    return slicer.crop_to_original_size(canvas * inv_norm)
