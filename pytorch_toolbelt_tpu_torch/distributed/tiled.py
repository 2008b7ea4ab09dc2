"""Strip-sharded tiled inference over ``torch.distributed`` (counterpart of
``pytorch_toolbelt_tpu/distributed/tiled.py``; BASELINE config 5: a
10000x10000 orthophoto, tiles sharded over the devices, per-tile d4 TTA,
weighted merge).

torch runs one process per GPU, so each rank computes its own share of the
image and nothing is gathered unless asked for.

``canvas='strips'`` (the default) shards the OUTPUT rows: with
``strip_h = ceil(H / n)``, rank d owns output rows
``[d * strip_h, min(H, (d + 1) * strip_h))``.  It runs every tile whose rows
meet that window (tiles straddling a strip boundary are run by both
owners), in the single-chip path's group order and scan order, in balanced
exact batches, and merges them with one launch of the grid-merge kernel
(K1, :func:`~pytorch_toolbelt_tpu_torch.ops.grid_merge`) over its sub-grid
of tile rows, cropped to its own window.  Only its image rows plus the tile
halo move to its device, and the merge needs no collective.  K1 sums each
pixel's covering tiles in tile order, and every tile covering a row of the
window lies in the sub-grid, so the strips equal the single-chip
``tiled_apply`` / ``tiled_apply_d4_tta`` bit for bit wherever the model
computes each tile's output independently of its batch.

``canvas='replicated'`` deals each tile group round-robin over the ranks;
every rank adds its batches into a full-resolution canvas with the
scatter-merge kernel (K3, :func:`~pytorch_toolbelt_tpu_torch.ops.accumulate_tiles`),
the canvases are summed with one ``all_reduce``, and each rank normalises
by the inverse of the summed window (computed on the host in float64) and
crops the margins.  It avoids the duplicated boundary tiles, but each rank
holds the whole ``[K, H, W]`` canvas.

``d4_tta`` composes with both: ``'full'`` runs all 8 d4 views per tile,
``'distributed'`` runs each grid-parity class's view pair, keyed by the
GLOBAL tile parity, so a tile runs the same views whichever rank owns it.
"""

from functools import lru_cache
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..inference.tiles import (
    ImageSlicer,
    _d4_model_fns,
    _gather_tiles,
    _grid_shape,
    _group_coords,
    _stack_batches,
    _tile_rows_stack,
)
from ..ops.tile_merge import accumulate_tiles, grid_merge
from .comm import all_gather, is_dist_avail_and_initialized
from .mesh import get_rank, get_world_size

__all__ = ["tiled_apply_sharded", "clear_sharded_cache", "read_sharded_window"]

# Configurations whose plans stay cached: each pins device coordinates, the
# blend window and, for the replicated canvas, the cropped inverse norm.
_PLAN_CACHE_SIZE = 8


def _pair(v) -> Tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _strip_rows(h: int, rank: int, world_size: int) -> Tuple[int, int]:
    """Output rows [y0, y1) that ``rank`` owns; empty where ``rank * ceil(h / n) >= h``."""
    strip_h = -(-h // world_size)
    return min(h, rank * strip_h), min(h, (rank + 1) * strip_h)


class _StripPlan(NamedTuple):
    slicer: ImageSlicer
    rows: Tuple[int, int]  # the rank's output rows [y0, y1)
    tile_rows: Tuple[int, int]  # the sub-grid's tile rows [r0, r1)
    groups: tuple  # per tile group: (main, remainder) batches of its tiles in the sub-grid
    weight: torch.Tensor


@lru_cache(maxsize=_PLAN_CACHE_SIZE)
def _get_strip_plan(h, w, tile_size, tile_step, weight, batch_size, partition, rank, world_size, device):
    slicer = ImageSlicer((h, w), tile_size, tile_step, weight=weight)
    (th, _), (sh, _) = slicer.tile_size, slicer.tile_step
    ty = _grid_shape(slicer)[0]
    y0, y1 = _strip_rows(h, rank, world_size)
    lo, hi = slicer.margin_top + y0, slicer.margin_top + y1  # target frame
    # tile row iy covers target rows [iy * sh, iy * sh + th): those that meet [lo, hi)
    r0, r1 = max(0, (lo - th) // sh + 1), min(ty, -(-hi // sh))
    groups = tuple(
        _stack_batches(g[(g[:, 0] // sh >= r0) & (g[:, 0] // sh < r1)], batch_size, device)
        for g in _group_coords(slicer, partition)
    )
    weight_dev = torch.as_tensor(slicer.weight.astype(np.float32), device=device).contiguous()
    return _StripPlan(slicer, (y0, y1), (r0, r1), groups, weight_dev)


class _ReplicatedPlan(NamedTuple):
    slicer: ImageSlicer
    groups: tuple  # per tile group: (main, remainder) device batches of the rank's tiles
    host_groups: tuple  # the same batches as host arrays, for the scatter merge
    weight: torch.Tensor
    inv_norm: torch.Tensor  # [1, H, W] fp32: 1 / (summed window), margins cropped


@lru_cache(maxsize=_PLAN_CACHE_SIZE)
def _get_replicated_plan(h, w, tile_size, tile_step, weight, batch_size, partition, rank, world_size, device):
    slicer = ImageSlicer((h, w), tile_size, tile_step, weight=weight)
    th, tw = slicer.tile_size
    host_groups = tuple(
        tuple(b.numpy() for b in _stack_batches(g[rank::world_size], batch_size))
        for g in _group_coords(slicer, partition)
    )
    groups = tuple(tuple(torch.as_tensor(b, device=device) for b in g) for g in host_groups)
    weight_np = slicer.weight.astype(np.float32)
    norm = np.zeros(slicer.target_shape, dtype=np.float64)
    for x, y, _, _ in slicer.crops:
        norm[y : y + th, x : x + tw] += weight_np
    norm = np.clip(norm, np.finfo(np.float64).eps, None).astype(np.float32)
    inv_norm = (1.0 / norm)[slicer.margin_top : slicer.margin_top + h, slicer.margin_left : slicer.margin_left + w]
    return _ReplicatedPlan(
        slicer, groups, host_groups, torch.as_tensor(weight_np, device=device).contiguous(),
        torch.as_tensor(np.ascontiguousarray(inv_norm), device=device)[None],
    )


def clear_sharded_cache() -> None:
    """Drop the cached per-configuration plans (device coordinates, blend
    windows and inverse norms)."""
    _get_strip_plan.cache_clear()
    _get_replicated_plan.cache_clear()


def _resolve_device(image: torch.Tensor, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if image.device.type == "cuda":
        return image.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tiled_apply_sharded runs on the current CUDA device unless told otherwise, and "
            "torch.cuda.is_available() is false; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def _probe(model_fn, image: torch.Tensor, slicer: ImageSlicer, device, out_channels):
    """(K, output dtype) of the model, from one zero tile: for a rank that
    runs no tile but must still return or reduce a canvas."""
    th, tw = slicer.tile_size
    out = model_fn(torch.zeros(1, image.shape[0], th, tw, dtype=image.dtype, device=device))
    return (int(out_channels) if out_channels is not None else int(out.shape[1])), out.dtype


def tiled_apply_sharded(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    image: torch.Tensor,
    tile_size: Union[int, Tuple[int, int]],
    tile_step: Union[int, Tuple[int, int]],
    weight: str = "pyramid",
    batch_size: int = 4,
    canvas: str = "strips",
    d4_tta: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    out_channels: Optional[int] = None,
    accumulator_dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """Tiled inference of a huge image, sharded over the ranks of the
    process group (see the module docstring).

    Args:
        model_fn: maps [B, C, th, tw] -> [B, K, th, tw].
        image: [C, H, W] on the host or on the rank's device (numpy is taken
            as a host tensor).
        batch_size: tile batch cap; each rank runs balanced exact batches
            of its tiles, no padding slots.
        canvas: ``'strips'`` or ``'replicated'``.
        d4_tta: None, ``'full'`` or ``'distributed'`` (step == size / 2).
        rank, world_size: default the process group's, or 0 and 1 without
            one; explicit values let one process compute any rank's strip.
            ``canvas='replicated'`` with ``world_size > 1`` needs the group.
        out_channels, accumulator_dtype: as for ``tiled_apply``.
        device: the rank's device; default the image's if it lies on a GPU,
            else the current CUDA device (raises without one).  Pass
            ``device='cpu'`` to run on the CPU.

    Returns:
        strips: ``[K, rows_d, W]``, the rank's output rows (``[K, 0, W]``
        for an empty window); replicated: ``[K, H, W]`` on every rank.  In
        the model's output dtype, on the rank's device.
    """
    if d4_tta is None:
        model_fns, partition = (model_fn,), "none"
    else:
        model_fns, partition = _d4_model_fns(model_fn, d4_tta, tile_size, tile_step)
    if canvas not in ("strips", "replicated"):
        raise ValueError(f"Unknown canvas mode {canvas!r}; use 'strips' or 'replicated'")
    image = torch.as_tensor(image)
    if image.ndim != 3:
        raise ValueError(f"image must be [C, H, W], got shape {tuple(image.shape)}")
    rank = get_rank() if rank is None else int(rank)
    world_size = get_world_size() if world_size is None else int(world_size)
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is outside a world of {world_size}")
    device = _resolve_device(image, device)
    h, w = int(image.shape[1]), int(image.shape[2])
    key = (h, w, _pair(tile_size), _pair(tile_step), weight, batch_size, partition, rank, world_size, device)
    if canvas == "strips":
        plan_fn = _get_strip_plan.__wrapped__ if isinstance(weight, np.ndarray) else _get_strip_plan
        return _strip(model_fns, image, plan_fn(*key), device, out_channels, accumulator_dtype)
    if world_size > 1 and not is_dist_avail_and_initialized():
        raise RuntimeError(f"canvas='replicated' at world size {world_size} needs an initialized process group")
    plan_fn = _get_replicated_plan.__wrapped__ if isinstance(weight, np.ndarray) else _get_replicated_plan
    return _replicated(model_fns, image, plan_fn(*key), world_size, device, out_channels, accumulator_dtype)


def _strip(model_fns, image, plan: _StripPlan, device, out_channels, accumulator_dtype):
    slicer = plan.slicer
    (th, _), (sh, sw) = slicer.tile_size, slicer.tile_step
    h, w = slicer.image_height, slicer.image_width
    (y0, y1), (r0, r1) = plan.rows, plan.tile_rows
    if y0 == y1:
        k, out_dtype = _probe(model_fns[0], image, slicer, device, out_channels)
        return torch.empty(k, 0, w, dtype=out_dtype, device=device)
    # image rows under the sub-grid's tiles (the strip plus the tile halo), padded like the whole image
    a, b = r0 * sh - slicer.margin_top, (r1 - 1) * sh + th - slicer.margin_top
    rows = image[:, max(a, 0) : min(b, h)].to(device)
    padded = F.pad(rows, (slicer.margin_left, slicer.margin_right, max(0, -a), max(0, b - h)))
    stack, out_dtype = _tile_rows_stack(model_fns, padded, plan.groups, slicer, r0, r1, out_channels,
                                        accumulator_dtype)
    tx = _grid_shape(slicer)[1]
    return grid_merge(stack, plan.weight, (r1 - r0, tx, sh, sw), out_hw=(y1 - y0, w),
                      offset=(slicer.margin_top + y0 - r0 * sh, slicer.margin_left), out_dtype=out_dtype)


def _replicated(model_fns, image, plan: _ReplicatedPlan, world_size, device, out_channels, accumulator_dtype):
    slicer = plan.slicer
    (th, tw), (sh, sw) = slicer.tile_size, slicer.tile_step
    h, w = slicer.image_height, slicer.image_width
    padded = F.pad(image.to(device), (slicer.margin_left, slicer.margin_right, slicer.margin_top,
                                      slicer.margin_bottom))
    tile_view = padded.unfold(1, th, sh).unfold(2, tw, sw)  # [C, ty, tx, th, tw], no copy
    canvas = norm = out_dtype = None
    for model_fn, batches, host_batches in zip(model_fns, plan.groups, plan.host_groups, strict=True):
        (main, rem), (host_main, host_rem) = batches, host_batches
        for batch_coords, host_coords in zip(list(main) + [rem], list(host_main) + [host_rem]):
            if not len(host_coords):
                continue
            _, _, tiles = _gather_tiles(tile_view, batch_coords, (sh, sw))
            preds = model_fn(tiles)
            if canvas is None:
                out_dtype = preds.dtype
                k = int(out_channels) if out_channels is not None else int(preds.shape[1])
                canvas = torch.zeros(k, *slicer.target_shape, dtype=torch.float32, device=device)
                norm = torch.zeros(1, *slicer.target_shape, dtype=torch.float32, device=device)
            accumulate_tiles(canvas, norm, preds.to(accumulator_dtype).contiguous(), host_coords, plan.weight)
    if canvas is None:
        k, out_dtype = _probe(model_fns[0], image, slicer, device, out_channels)
        canvas = torch.zeros(k, *slicer.target_shape, dtype=torch.float32, device=device)
    if world_size > 1:
        dist.all_reduce(canvas, op=dist.ReduceOp.SUM)
    crop = canvas[:, slicer.margin_top : slicer.margin_top + h, slicer.margin_left : slicer.margin_left + w]
    return (crop * plan.inv_norm).to(out_dtype)


def read_sharded_window(
    strip: torch.Tensor,
    row0: int,
    row1: int,
    col0: int,
    col1: int,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    image_height: Optional[int] = None,
) -> torch.Tensor:
    """The window ``[:, row0:row1, col0:col1]`` of a strips-canvas result,
    on every rank, without gathering the whole canvas: each rank gives the
    rows of the window it owns (``all_gather_object`` of host copies).

    ``strip`` is this rank's ``[K, rows_d, W]`` from ``tiled_apply_sharded``.
    With a group of more than one process, the strips' shapes are gathered
    first and must be row strips of one ``[K, H, W]`` canvas (same K and W,
    rows split as ``ceil(H / n)``), ``H`` being their total rows.  Without
    one, only the local strip is read: rank ``rank`` of ``world_size``
    (default 0 of 1), of an image ``image_height`` rows high (needed when
    ``world_size > 1``); rows it does not own raise.

    Returns ``[K, row1 - row0, col1 - col0]`` on the strip's device.
    """
    if strip.ndim != 3:
        raise ValueError(f"strip must be [K, rows, W], got shape {tuple(strip.shape)}")
    k, rows, w = (int(s) for s in strip.shape)
    grouped = is_dist_avail_and_initialized()
    if grouped:
        rank, world_size = get_rank(), get_world_size()
        shapes = all_gather((k, rows, w))
    else:
        rank = 0 if rank is None else int(rank)
        world_size = 1 if world_size is None else int(world_size)
        if image_height is None:
            if world_size > 1:
                raise ValueError("without a process group, reading one of several strips needs image_height")
            image_height = rows
        shapes = None
    h = sum(s[1] for s in shapes) if grouped else int(image_height)
    if image_height is not None and int(image_height) != h:
        raise ValueError(f"the strips hold {h} rows, not image_height={image_height}")
    expected = [_strip_rows(h, d, world_size) for d in range(world_size)]
    if grouped and any(s != (k, y1 - y0, w) for s, (y0, y1) in zip(shapes, expected)):
        raise ValueError(f"the ranks' strips {shapes} are not row strips of one [{k}, {h}, {w}] canvas")
    y0, y1 = expected[rank]
    if rows != y1 - y0:
        raise ValueError(f"rank {rank} of {world_size} owns {y1 - y0} rows of {h}, the strip holds {rows}")
    if not (0 <= row0 < row1 <= h and 0 <= col0 < col1 <= w):
        raise ValueError(f"window rows [{row0}, {row1}) x cols [{col0}, {col1}) is outside the [{h}, {w}] canvas")
    a, b = max(row0, y0), min(row1, y1)
    if not grouped and (a, b) != (row0, row1):
        raise ValueError(f"rows [{row0}, {row1}) are not all owned by rank {rank} (rows [{y0}, {y1}))")
    piece = strip[:, a - y0 : b - y0, col0:col1].cpu() if a < b else None
    pieces = all_gather(piece) if grouped else [piece]
    return torch.cat([p for p in pieces if p is not None], dim=1).to(strip.device)
