"""Tiled inference on huge images (counterpart of
``pytorch_toolbelt_tpu/inference/tiles.py``).

Host side, ``ImageSlicer`` and the pyramid window are the same numpy code as
in the JAX package.

``TileMerger`` accumulates streamed batches on the device; with
``use_pallas=True`` each batch is one launch of the scatter-merge kernel
(K3, :func:`~pytorch_toolbelt_tpu_torch.ops.accumulate_tiles`).

Device side, :func:`tiled_apply` pads the image on the device, gathers each
batch's tiles, runs ``model_fn``, writes each tile's prediction into a
preallocated ``[N, K, th, tw]`` stack and ends with one launch of the
grid-merge kernel (K1, :func:`~pytorch_toolbelt_tpu_torch.ops.grid_merge`),
which weights, sums, normalises and crops the margins.  Public tensors are
NCHW: images ``[C, H, W]``, tiles ``[B, C, th, tw]``, results ``[K, H, W]``.
"""

import math
from functools import lru_cache
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.tile_merge import accumulate_tiles as scatter_merge
from ..ops.tile_merge import detect_regular_grid, grid_merge
from ..utils.profiling import span
from .tta import d4_image2mask, d4_image_augment_views, d4_image_deaugment_views

__all__ = [
    "ImageSlicer",
    "TileMerger",
    "accumulate_tiles",
    "clear_tiled_cache",
    "compute_pyramid_patch_weight_loss",
    "tiled_apply",
    "tiled_apply_d4_tta",
]


def compute_pyramid_patch_weight_loss(width: int, height: int) -> np.ndarray:
    """Center-weighted pyramid window W = alpha * De / (Dc + De).
    Returns (W, Dc, De)."""
    xc = width * 0.5
    yc = height * 0.5

    Dcx = np.square(np.arange(width) - xc + 0.5)
    Dcy = np.square(np.arange(height) - yc + 0.5)
    Dc = np.sqrt(Dcx[np.newaxis].transpose() + Dcy)

    De_l = np.square(np.arange(width) + 0.5) + np.square(0.5)
    De_r = np.square(np.arange(width) - width + 0.5) + np.square(0.5)
    De_b = np.square(0.5) + np.square(np.arange(height) + 0.5)
    De_t = np.square(0.5) + np.square(np.arange(height) - height + 0.5)

    De_x = np.sqrt(np.minimum(De_l, De_r))
    De_y = np.sqrt(np.minimum(De_b, De_t))
    De = np.minimum(De_x[np.newaxis].transpose(), De_y)

    alpha = (width * height) / np.sum(np.divide(De, np.add(Dc, De)))
    W = alpha * np.divide(De, np.add(Dc, De))
    return W, Dc, De


class ImageSlicer:
    """Slice an image into overlapping tiles and merge them back (host-side
    numpy, the JAX package's semantics).  Images are HWC numpy arrays."""

    def __init__(self, image_shape, tile_size, tile_step=0, image_margin=0, weight="mean"):
        self.image_height = image_shape[0]
        self.image_width = image_shape[1]

        if isinstance(tile_size, (np.ndarray, tuple, list)):
            if len(tile_size) != 2:
                raise ValueError(f"tile_size must be an int or an (h, w) pair; got {tile_size!r}")
            self.tile_size = int(tile_size[0]), int(tile_size[1])
        else:
            self.tile_size = int(tile_size), int(tile_size)

        if isinstance(tile_step, (np.ndarray, tuple, list)):
            if len(tile_step) != 2:
                raise ValueError(f"tile_step must be an int or an (h, w) pair; got {tile_step!r}")
            self.tile_step = int(tile_step[0]), int(tile_step[1])
        else:
            self.tile_step = int(tile_step), int(tile_step)

        weights = {"mean": self._mean, "pyramid": self._pyramid}
        self.weight = weight if isinstance(weight, np.ndarray) else weights[weight](self.tile_size)

        if self.tile_step[0] < 1 or self.tile_step[0] > self.tile_size[0]:
            raise ValueError()
        if self.tile_step[1] < 1 or self.tile_step[1] > self.tile_size[1]:
            raise ValueError()

        overlap = (self.tile_size[0] - self.tile_step[0], self.tile_size[1] - self.tile_step[1])

        if image_margin == 0:
            nw = max(1, math.ceil((self.image_width - overlap[1]) / self.tile_step[1]))
            nh = max(1, math.ceil((self.image_height - overlap[0]) / self.tile_step[0]))
            extra_w = self.tile_step[1] * nw - (self.image_width - overlap[1])
            extra_h = self.tile_step[0] * nh - (self.image_height - overlap[0])
            self.margin_left = extra_w // 2
            self.margin_right = extra_w - self.margin_left
            self.margin_top = extra_h // 2
            self.margin_bottom = extra_h - self.margin_top
        else:
            if isinstance(image_margin, (tuple, list)):
                self.margin_left, self.margin_right, self.margin_top, self.margin_bottom = image_margin
            else:
                self.margin_left = self.margin_right = self.margin_top = self.margin_bottom = image_margin

        crops = []
        bbox_crops = []
        for y in range(
            0, self.image_height + self.margin_top + self.margin_bottom - self.tile_size[0] + 1, self.tile_step[0]
        ):
            for x in range(
                0, self.image_width + self.margin_left + self.margin_right - self.tile_size[1] + 1, self.tile_step[1]
            ):
                crops.append((x, y, self.tile_size[1], self.tile_size[0]))
                bbox_crops.append((x - self.margin_left, y - self.margin_top, self.tile_size[1], self.tile_size[0]))

        self.crops = np.array(crops)
        self.bbox_crops = np.array(bbox_crops)

    # cv2.BORDER_* int codes and their string names -> numpy pad modes
    _BORDER_MODES = {
        0: "constant", "constant": "constant",
        1: "edge", "replicate": "edge",
        2: "symmetric", "reflect": "symmetric",
        3: "wrap", "wrap": "wrap",
        4: "reflect", "reflect101": "reflect", "reflect_101": "reflect",
    }

    @classmethod
    def _np_pad(cls, array: np.ndarray, pad, border_type, value):
        try:
            mode = cls._BORDER_MODES[border_type]
        except KeyError:
            raise ValueError(
                f"Unsupported border_type {border_type!r}; use a cv2.BORDER_* code or one of "
                "'constant', 'replicate', 'reflect', 'wrap', 'reflect101'"
            ) from None
        if mode == "constant":
            return np.pad(array, pad, mode="constant", constant_values=value)
        return np.pad(array, pad, mode=mode)

    def _pad_image(self, image: np.ndarray, value=0, border_type="constant") -> np.ndarray:
        pad = [(self.margin_top, self.margin_bottom), (self.margin_left, self.margin_right)]
        if image.ndim == 3:
            pad.append((0, 0))
        return self._np_pad(image, pad, border_type, value)

    def split(self, image: np.ndarray, value=0, border_type="constant") -> List[np.ndarray]:
        assert image.shape[0] == self.image_height
        assert image.shape[1] == self.image_width
        orig_ndim = image.ndim
        image = self._pad_image(image, value, border_type)
        if image.ndim != orig_ndim:
            image = np.expand_dims(image, axis=-1)

        tiles = []
        for x, y, tile_width, tile_height in self.crops:
            tile = image[y : y + tile_height, x : x + tile_width]
            assert tile.shape[0] == self.tile_size[0]
            assert tile.shape[1] == self.tile_size[1]
            tiles.append(tile)
        return tiles

    def iter_split(self, image: np.ndarray, value=0, border_type="constant"):
        """Yield (tile, coords) one at a time without padding the whole image."""
        if image.shape[0] != self.image_height or image.shape[1] != self.image_width:
            raise ValueError()
        for coords, crop_coords in zip(self.crops, self.bbox_crops):
            yield self.cut_patch_by_bbox(image, crop_coords, value, border_type), coords

    def cut_patch(self, image: np.ndarray, slice_index: int, value=0, border_type="constant") -> np.ndarray:
        assert image.shape[0] == self.image_height
        assert image.shape[1] == self.image_width
        return self.cut_patch_by_bbox(image, self.bbox_crops[slice_index], value, border_type)

    def cut_patch_by_bbox(self, image: np.ndarray, crop_coords, value=0, border_type="constant") -> np.ndarray:
        x, y, tile_width, tile_height = crop_coords
        x1, y1 = max(x, 0), max(y, 0)
        x2 = min(image.shape[1], x + tile_width)
        y2 = min(image.shape[0], y + tile_height)
        orig_ndim = image.ndim
        tile = image[y1:y2, x1:x2]
        if x < 0 or y < 0 or (x + tile_width) > image.shape[1] or (y + tile_height) > image.shape[0]:
            pad = [
                (max(0, -y), max(0, y + tile_height - image.shape[0])),
                (max(0, -x), max(0, x + tile_width - image.shape[1])),
            ]
            if tile.ndim == 3:
                pad.append((0, 0))
            tile = self._np_pad(tile, pad, border_type, value)
            if tile.ndim != orig_ndim:
                tile = np.expand_dims(tile, axis=-1)
        return tile

    @property
    def target_shape(self) -> Tuple[int, int]:
        return (
            self.image_height + self.margin_bottom + self.margin_top,
            self.image_width + self.margin_right + self.margin_left,
        )

    def merge(self, tiles: List[np.ndarray], dtype=np.float32) -> np.ndarray:
        """Weighted overlap-add on host (float64 accumulators)."""
        if len(tiles) != len(self.crops):
            raise ValueError

        channels = 1 if tiles[0].ndim == 2 else tiles[0].shape[2]
        target_shape = self.target_shape + (channels,)

        image = np.zeros(target_shape, dtype=np.float64)
        norm_mask = np.zeros(target_shape, dtype=np.float64)
        w = np.dstack([self.weight] * channels)

        for tile, (x, y, tile_width, tile_height) in zip(tiles, self.crops):
            tile = tile if tile.ndim == 3 else tile[..., None]
            image[y : y + tile_height, x : x + tile_width] += tile * w
            norm_mask[y : y + tile_height, x : x + tile_width] += w

        norm_mask = np.clip(norm_mask, a_min=np.finfo(norm_mask.dtype).eps, a_max=None)
        normalized = np.divide(image, norm_mask).astype(dtype)
        return self.crop_to_orignal_size(normalized)

    def crop_to_orignal_size(self, image: Union[np.ndarray, torch.Tensor]):
        """Crop the margins: an [H, W, ...] numpy array, or a [C, H, W] tensor
        such as ``TileMerger.merge()`` returns."""
        # (sic) name kept for API compatibility
        if isinstance(image, torch.Tensor):
            if tuple(image.shape[-2:]) != self.target_shape:
                raise ValueError(f"expected [..., {self.target_shape[0]}, {self.target_shape[1]}], "
                                 f"got {tuple(image.shape)}")
            return image[..., self.margin_top : self.margin_top + self.image_height,
                         self.margin_left : self.margin_left + self.image_width]
        assert image.shape[0] == self.target_shape[0]
        assert image.shape[1] == self.target_shape[1]
        crop = image[
            self.margin_top : self.image_height + self.margin_top,
            self.margin_left : self.image_width + self.margin_left,
        ]
        assert crop.shape[0] == self.image_height
        assert crop.shape[1] == self.image_width
        return crop

    crop_to_original_size = crop_to_orignal_size

    def _mean(self, tile_size) -> np.ndarray:
        return np.ones((tile_size[0], tile_size[1]), dtype=np.float32)

    def _pyramid(self, tile_size) -> np.ndarray:
        w, _, _ = compute_pyramid_patch_weight_loss(tile_size[0], tile_size[1])
        return w


def accumulate_tiles(canvas, norm_mask, tiles, coords_yx, weight, donate: bool = False):
    """Weighted overlap-add of a batch of tiles through the scatter-merge
    kernel (K3, :func:`~pytorch_toolbelt_tpu_torch.ops.accumulate_tiles`).

    canvas [C, H, W] and norm_mask [1, H, W] fp32, tiles [N, C, th, tw],
    coords_yx [N, 2] (row, col), weight [th, tw] (or [th, tw, 1]).  Returns
    new accumulators and leaves the inputs as they were; ``donate=True``
    updates the input buffers in place instead and returns them.
    """
    if not donate:
        canvas, norm_mask = canvas.clone(), norm_mask.clone()
    th, tw = tiles.shape[2:]
    weight = torch.as_tensor(weight, dtype=torch.float32, device=canvas.device).reshape(th, tw).contiguous()
    return scatter_merge(canvas, norm_mask, tiles, coords_yx, weight)


class TileMerger:
    """Device-resident accumulator of NCHW tile batches.

    The canvas lives on ``device``, by default the current CUDA device (it
    raises where there is none); ``device="cpu"`` merges on the CPU.

    Merge strategy (``use_pallas``):

    * ``"auto"`` (default): a first ``integrate_batch`` call that delivers a
      complete regular grid spanning the canvas merges through the
      grid-merge kernel (K1); later or partial batches are added tile by
      tile with slice-adds.
    * ``False``: always the slice-adds.
    * ``True``: every batch goes through the scatter-merge kernel (K3), one
      launch per batch, reading fp32 or bf16 tiles as they are.  The sums
      are those of the slice-adds, bit for bit.
    """

    def __init__(self, image_shape, channels: int, weight: np.ndarray, dtype=torch.float32, device=None,
                 use_pallas="auto"):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TileMerger allocates its canvas on CUDA unless told otherwise, and "
                    "torch.cuda.is_available() is false; pass device='cpu' to merge on the CPU"
                )
            device = torch.device("cuda", torch.cuda.current_device())
        self.image_height = int(image_shape[0])
        self.image_width = int(image_shape[1])
        self.channels = int(channels)
        self.use_pallas = use_pallas
        self.weight = torch.as_tensor(np.asarray(weight), dtype=torch.float32, device=device).contiguous()
        self.image = torch.zeros(self.channels, self.image_height, self.image_width, dtype=dtype, device=device)
        self.norm_mask = torch.zeros(1, self.image_height, self.image_width, dtype=dtype, device=device)
        self._touched = False

    def accumulate_single(self, tile: torch.Tensor, coords) -> None:
        """tile [C, th, tw]; coords (x, y, w, h)."""
        self.integrate_batch(tile[None], np.asarray(coords)[None])

    def integrate_batch(self, batch: torch.Tensor, crop_coords) -> None:
        """batch [B, C, th, tw]; crop_coords [B, 4] of (x, y, w, h)."""
        if len(batch) != len(crop_coords):
            raise ValueError("Number of images in batch does not correspond to number of coordinates")
        with span("tiles.integrate", self.image):
            coords = np.asarray(crop_coords)
            coords_yx = coords[:, [1, 0]].astype(np.int64)
            batch = torch.as_tensor(batch).to(device=self.image.device)
            if self.use_pallas is True:
                if batch.dtype not in (torch.float32, torch.bfloat16):
                    batch = batch.to(self.image.dtype)
                scatter_merge(self.image, self.norm_mask, batch.contiguous(), coords_yx, self.weight)
                return
            batch = batch.to(self.image.dtype)
            th, tw = int(batch.shape[2]), int(batch.shape[3])

            first_call, self._touched = not self._touched, True
            if self.use_pallas == "auto" and first_call:
                grid = detect_regular_grid(coords_yx, th, tw)
                if grid is not None:
                    ty, tx, sh, sw = grid
                    if ((ty - 1) * sh + th, (tx - 1) * sw + tw) == (self.image_height, self.image_width):
                        self.image, norm = grid_merge(batch.contiguous(), self.weight, grid, normalize=False)
                        self.norm_mask = norm.to(self.image.dtype)
                        return

            w = self.weight.to(self.image.dtype)
            for tile, (y, x) in zip(batch, coords_yx):
                self.image[:, y : y + th, x : x + tw] += tile * w
                self.norm_mask[:, y : y + th, x : x + tw] += w

    def merge(self) -> torch.Tensor:
        with span("tiles.merge", self.image):
            return self.image / self.norm_mask

    def merge_(self) -> torch.Tensor:
        with span("tiles.merge", self.image):
            self.image = self.image / self.norm_mask
        return self.image


# ---------------------------------------------------------------------------
# Device-side tiled inference
# ---------------------------------------------------------------------------


def _stack_batches(coords_yx_np: np.ndarray, batch_size: int, device=None):
    """Split a [N, D] coord list ((row, col), or (z, row, col) for volumes)
    into balanced batches: stacked main batches [num_batches, B_eff, D] plus
    at most one remainder batch [r, D] with r < B_eff, as device tensors.

    No padding tiles (a padded slot would run the model on garbage), and a
    balanced batch size B_eff = ceil(N / ceil(N / B)), so no straggler batch
    of a few tiles runs beside full ones."""
    coords = np.asarray(coords_yx_np, dtype=np.int64)
    n_tiles = len(coords)
    if n_tiles == 0:
        main, rem = coords.reshape(0, max(batch_size, 1), coords.shape[-1]), coords
    else:
        total_batches = -(-n_tiles // batch_size)
        b_eff = -(-n_tiles // total_batches)
        num_full = n_tiles // b_eff
        main = coords[: num_full * b_eff].reshape(num_full, b_eff, coords.shape[-1])
        rem = coords[num_full * b_eff :]
    return torch.as_tensor(main, device=device), torch.as_tensor(rem, device=device)


def _group_coords(slicer: ImageSlicer, partition: str) -> List[np.ndarray]:
    """[N_g, 2] int64 (row, col) target-frame coordinates of each tile
    group, in scan order.

    ``partition='none'`` yields one tile group; ``'parity2x2'`` yields four
    groups keyed by grid parity ((row//step_h) % 2, (col//step_w) % 2) so
    that, at step = size/2, the up-to-4 tiles covering any pixel land in 4
    distinct groups (the basis for spreading TTA views across the overlap).
    """
    coords = slicer.crops  # (x, y, w, h)
    coords_yx = np.stack([coords[:, 1], coords[:, 0]], axis=1).astype(np.int64)
    if partition == "none":
        return [coords_yx]
    if partition == "parity2x2":
        step_h, step_w = slicer.tile_step
        parity = (coords_yx[:, 0] // step_h) % 2 * 2 + (coords_yx[:, 1] // step_w) % 2
        return [coords_yx[parity == g] for g in range(4)]
    raise ValueError(f"Unknown tile partition {partition!r}")


def _grid_shape(slicer: ImageSlicer) -> Tuple[int, int]:
    """(ty, tx): the tile grid's rows and columns."""
    (th, tw), (sh, sw) = slicer.tile_size, slicer.tile_step
    tgt_h, tgt_w = slicer.target_shape
    return (tgt_h - th) // sh + 1, (tgt_w - tw) // sw + 1


@lru_cache(maxsize=4)
def _get_tiled_plan(h, w, tile_size, tile_step, weight, batch_size, partition="none", device=None):
    """Host grid math plus device-resident tile coordinates and blend
    window for a tiling config, computed once and cached (call
    :func:`clear_tiled_cache` to release them).  One (main, remainder)
    batch plan per tile group of :func:`_group_coords`.
    """
    slicer = ImageSlicer((h, w), tile_size, tile_step, weight=weight)
    groups = tuple(_stack_batches(g, batch_size, device) for g in _group_coords(slicer, partition))
    group_coords = tuple(g[0] for g in groups)
    group_rem = tuple(g[1] for g in groups)
    weight_dev = torch.as_tensor(slicer.weight.astype(np.float32), device=device).contiguous()
    return slicer, group_coords, group_rem, weight_dev


def clear_tiled_cache() -> None:
    """Release the device-resident tiling plans cached by ``tiled_apply``."""
    _get_tiled_plan.cache_clear()


def tiled_apply(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    image: torch.Tensor,
    tile_size: Union[int, Tuple[int, int]],
    tile_step: Union[int, Tuple[int, int]],
    weight: str = "pyramid",
    batch_size: int = 8,
    out_channels: Optional[int] = None,
    accumulator_dtype=torch.float32,
) -> torch.Tensor:
    """Run ``model_fn`` over overlapping tiles of a huge image on its device
    and return the merged full-resolution prediction.

    Args:
        model_fn: maps [B, C, th, tw] -> [B, K, th, tw].
        image: [C, H, W] tensor.
        weight: 'mean' | 'pyramid' | ndarray [th, tw].
        accumulator_dtype: dtype of the prediction stack the merge reads
            (fp32 or bf16); the merge itself sums in fp32.

    Returns:
        [K, H, W] merged prediction in the model's output dtype.
    """
    return _tiled_apply_grouped(
        (model_fn,), image, tile_size, tile_step, weight, batch_size, out_channels,
        accumulator_dtype, partition="none",
    )


def _tiled_apply_grouped(model_fns, image, tile_size, tile_step, weight, batch_size, out_channels,
                         accumulator_dtype, partition):
    if image.ndim != 3:
        raise ValueError(f"image must be [C, H, W], got shape {tuple(image.shape)}")
    with span("tiles.apply", device=False):
        h, w = int(image.shape[1]), int(image.shape[2])
        plan_fn = _get_tiled_plan.__wrapped__ if isinstance(weight, np.ndarray) else _get_tiled_plan
        slicer, group_coords, group_rem, weight_dev = plan_fn(
            h, w,
            tile_size if isinstance(tile_size, int) else tuple(tile_size),
            tile_step if isinstance(tile_step, int) else tuple(tile_step),
            weight, batch_size, partition, image.device,
        )
        sh, sw = slicer.tile_step
        ty, tx = _grid_shape(slicer)
        padded = torch.nn.functional.pad(
            image, (slicer.margin_left, slicer.margin_right, slicer.margin_top, slicer.margin_bottom)
        )
        stack, out_dtype = _tile_rows_stack(model_fns, padded, tuple(zip(group_coords, group_rem)), slicer, 0, ty,
                                            out_channels, accumulator_dtype)
        with span("tiles.merge", stack):
            return grid_merge(
                stack, weight_dev, (ty, tx, sh, sw), out_hw=(h, w),
                offset=(slicer.margin_top, slicer.margin_left), out_dtype=out_dtype,
            )


def _gather_tiles(tile_view: torch.Tensor, batch_coords: torch.Tensor, tile_step, r0: int = 0):
    """The tiles of one batch of target-frame (row, col) coordinates from
    ``tile_view`` ([C, rows, tx, th, tw], grid row 0 being tile row ``r0``):
    (grid rows relative to r0, grid columns, tiles [B, C, th, tw])."""
    iy, ix = batch_coords[:, 0] // tile_step[0] - r0, batch_coords[:, 1] // tile_step[1]
    return iy, ix, tile_view[:, iy, ix].permute(1, 0, 2, 3).contiguous()


def _tile_rows_stack(model_fns, padded, groups, slicer, r0, r1, out_channels, accumulator_dtype):
    """Run each group's model over its batches and write every prediction
    into the stack of the sub-grid of tile rows ``[r0, r1)``: stack row
    ``(iy - r0) * tx + ix`` holds tile (iy, ix).

    ``padded`` is the padded image's target-frame rows from ``r0 * step_h``
    to the bottom of tile row ``r1 - 1``; ``groups`` holds, per model
    function, the (main, remainder) batches of :func:`_stack_batches` of
    its tiles in those rows, on ``padded``'s device.  The single-chip path
    runs it over every row and the strips of ``tiled_apply_sharded`` over
    theirs, so both merge the same tile predictions.  Returns the stack and
    the model's output dtype.
    """
    th, tw = slicer.tile_size
    sh, sw = slicer.tile_step
    tx = _grid_shape(slicer)[1]
    tile_view = padded.unfold(1, th, sh).unfold(2, tw, sw)  # [C, r1 - r0, tx, th, tw], no copy

    stack = None
    out_dtype = None
    for model_fn, (main, rem) in zip(model_fns, groups, strict=True):
        for batch_coords in list(main) + ([rem] if len(rem) else []):
            iy, ix, tiles = _gather_tiles(tile_view, batch_coords, (sh, sw), r0)
            preds = model_fn(tiles)
            if stack is None:
                out_dtype = preds.dtype
                k = int(out_channels) if out_channels is not None else int(preds.shape[1])
                stack = torch.empty((r1 - r0) * tx, k, th, tw, dtype=accumulator_dtype, device=padded.device)
            with span("tiles.stack", stack):
                stack[iy * tx + ix] = preds.to(accumulator_dtype)
    return stack, out_dtype


# The d4 group has 8 elements; at 2x overlap (step = size/2) every interior
# pixel is covered by exactly 4 tiles, one from each grid-parity class.
# Assigning each parity class a disjoint pair of d4 views makes every interior
# pixel an average over all 8 views while computing each view once per pixel.
_D4_PARITY_VIEW_PAIRS = ((0, 2), (1, 3), (4, 6), (5, 7))


def _views_fn(model_fn, views):
    def fn(tiles):
        return d4_image_deaugment_views(model_fn(d4_image_augment_views(tiles, views)), views)

    return fn


def tiled_apply_d4_tta(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    image: torch.Tensor,
    tile_size: Union[int, Tuple[int, int]],
    tile_step: Union[int, Tuple[int, int]],
    weight: str = "pyramid",
    batch_size: int = 8,
    out_channels: Optional[int] = None,
    accumulator_dtype=torch.float32,
    mode: str = "distributed",
) -> torch.Tensor:
    """Tiled inference with d4 test-time augmentation.

    mode='full': every tile runs all 8 d4 views (``tiled_apply`` of
        ``d4_image2mask(model_fn, .)``).
    mode='distributed': requires step == size/2 on both axes.  Each of the 4
        grid-parity tile classes computes a disjoint pair of d4 views, so
        every interior pixel still averages all 8 views, blended by the
        overlap window, at 1/4 the model compute of mode='full'.  Border
        pixels average the views of the tiles that cover them.
    """
    model_fns, partition = _d4_model_fns(model_fn, mode, tile_size, tile_step)
    return _tiled_apply_grouped(model_fns, image, tile_size, tile_step, weight, batch_size, out_channels,
                                accumulator_dtype, partition=partition)


def _d4_model_fns(model_fn, mode: str, tile_size, tile_step):
    """(model function of each tile group, partition) of d4 TTA mode
    ``'full'`` or ``'distributed'``."""
    if mode == "full":
        return (lambda tiles: d4_image2mask(model_fn, tiles),), "none"
    if mode != "distributed":
        raise ValueError(f"Unknown d4 TTA mode {mode!r}; use 'full' or 'distributed'")
    ts = (tile_size, tile_size) if isinstance(tile_size, int) else tuple(tile_size)
    st = (tile_step, tile_step) if isinstance(tile_step, int) else tuple(tile_step)
    if ts[0] != 2 * st[0] or ts[1] != 2 * st[1]:
        raise ValueError(
            "mode='distributed' needs tile_step == tile_size/2 (4-fold overlap) "
            f"so the parity classes tile the d4 group; got size={ts} step={st}"
        )
    return tuple(_views_fn(model_fn, views) for views in _D4_PARITY_VIEW_PAIRS), "parity2x2"
