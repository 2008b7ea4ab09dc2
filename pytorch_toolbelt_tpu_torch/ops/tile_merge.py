"""Weighted overlap-add of prediction tiles: the grid merge (kernel K1) and
the scatter merge (kernel K3).

Counterpart of ``pytorch_toolbelt_tpu/ops/tile_merge.py``.  The TPU package
merges a grid with the Pallas gather kernel ``pallas_grid_merge``; here the
same gather formulation is a CUDA kernel (``csrc/tile_merge.cu``) that also
fuses the normalisation by the summed window and the crop of the margins, so
tiled inference ends with one launch that writes each output element once.
It has two routes: ``cell``, where the steps divide the tile and blocks walk
the cells of the step lattice with TMA-fed 16-byte accesses, and
``general``, one thread per output element, for the rest.
Its Pallas scatter kernel ``pallas_accumulate_tiles``, which adds a batch of
tiles at arbitrary coordinates into a canvas in place, is the CUDA kernel
``csrc/scatter_merge.cu``.

Tiles are ``[N, K, th, tw]`` (NCHW per tile), the blend window is
``[th, tw]``, the canvas is ``[K, H, W]`` and the norm ``[1, H, W]``.

:func:`grid_merge` and :func:`accumulate_tiles` launch their kernels for
CUDA tensors and run :func:`grid_merge_reference` and
:func:`accumulate_tiles_reference` (torch slice-adds in tile order) for CPU
tensors; on any other device they raise.
"""

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

__all__ = [
    "accumulate_tiles",
    "accumulate_tiles_reference",
    "detect_regular_grid",
    "grid_merge",
    "grid_merge_reference",
]

# Floor of the summed window before dividing (the JAX plan's float64 eps).
NORM_EPS = float(np.finfo(np.float64).eps)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def detect_regular_grid(coords_yx, tile_h: int, tile_w: int):
    """If coords form a complete row-major (ty, tx) grid with uniform steps
    that divide the tile size, return (ty_tiles, tx_tiles, step_h, step_w);
    else None."""
    coords = np.asarray(coords_yx)
    if coords.ndim != 2 or coords.shape[1] != 2 or len(coords) == 0:
        return None
    ys = np.unique(coords[:, 0])
    xs = np.unique(coords[:, 1])
    if len(ys) * len(xs) != len(coords):
        return None
    expect = np.stack(np.meshgrid(ys, xs, indexing="ij"), axis=-1).reshape(-1, 2)
    if not np.array_equal(coords, expect):
        return None
    if ys[0] != 0 or xs[0] != 0:
        return None

    def step_of(vals, tile):
        if len(vals) == 1:
            return tile  # degenerate axis: single tile
        d = np.diff(vals)
        if (d != d[0]).any():
            return None
        return int(d[0])

    sh = step_of(ys, tile_h)
    sw = step_of(xs, tile_w)
    if sh is None or sw is None or sh <= 0 or sw <= 0:
        return None
    if tile_h % sh or tile_w % sw:
        return None
    return len(ys), len(xs), sh, sw


def _geometry(tiles: torch.Tensor, grid: Sequence[int], out_hw, offset):
    if tiles.ndim != 4:
        raise ValueError(f"tiles must be [N, K, th, tw], got shape {tuple(tiles.shape)}")
    ty, tx, sh, sw = (int(v) for v in grid)
    n, _, th, tw = tiles.shape
    if n != ty * tx:
        raise ValueError(f"{n} tiles do not fill a {ty}x{tx} grid")
    if not (0 < sh <= th and 0 < sw <= tw):
        raise ValueError(f"steps {(sh, sw)} must lie in (0, tile size {(th, tw)}]")
    canvas_h, canvas_w = (ty - 1) * sh + th, (tx - 1) * sw + tw
    off_y, off_x = (int(v) for v in offset)
    if out_hw is None:
        out_hw = (canvas_h - off_y, canvas_w - off_x)
    out_h, out_w = (int(v) for v in out_hw)
    if off_y < 0 or off_x < 0 or out_h <= 0 or out_w <= 0 or off_y + out_h > canvas_h or off_x + out_w > canvas_w:
        raise ValueError(
            f"output window {(off_y, off_x, out_h, out_w)} does not fit the canvas {(canvas_h, canvas_w)}"
        )
    return ty, tx, sh, sw, out_h, out_w, off_y, off_x


def grid_merge_reference(
    tiles: torch.Tensor,
    weight: torch.Tensor,
    grid: Sequence[int],
    out_hw: Optional[Tuple[int, int]] = None,
    offset: Tuple[int, int] = (0, 0),
    normalize: bool = True,
    out_dtype: Optional[torch.dtype] = None,
):
    """Plain version of :func:`grid_merge`: fp32 slice-adds in tile order,
    then the division by the summed window and the crop."""
    ty, tx, sh, sw, out_h, out_w, off_y, off_x = _geometry(tiles, grid, out_hw, offset)
    _, k, th, tw = tiles.shape
    out_dtype = out_dtype or tiles.dtype
    w = weight.to(device=tiles.device, dtype=torch.float32)
    canvas = torch.zeros(k, (ty - 1) * sh + th, (tx - 1) * sw + tw, dtype=torch.float32, device=tiles.device)
    norm = torch.zeros(1, canvas.shape[1], canvas.shape[2], dtype=torch.float32, device=tiles.device)
    for t in range(ty * tx):
        y, x = (t // tx) * sh, (t % tx) * sw
        canvas[:, y : y + th, x : x + tw] += tiles[t].to(torch.float32) * w
        norm[:, y : y + th, x : x + tw] += w
    canvas = canvas[:, off_y : off_y + out_h, off_x : off_x + out_w]
    norm = norm[:, off_y : off_y + out_h, off_x : off_x + out_w]
    if normalize:
        return (canvas / norm.clamp_min(NORM_EPS)).to(out_dtype)
    return canvas.to(out_dtype), norm


def grid_merge(
    tiles: torch.Tensor,
    weight: torch.Tensor,
    grid: Sequence[int],
    out_hw: Optional[Tuple[int, int]] = None,
    offset: Tuple[int, int] = (0, 0),
    normalize: bool = True,
    out_dtype: Optional[torch.dtype] = None,
):
    """Weighted overlap-add of a complete row-major tile grid.

    Args:
        tiles: [N, K, th, tw] fp32 or bf16, N = ty * tx in row-major order.
        weight: [th, tw] fp32 blend window.
        grid: (ty, tx, step_h, step_w), e.g. from :func:`detect_regular_grid`.
            Steps may be any value in (0, tile size].
        out_hw, offset: the window of the canvas ((ty-1)*step_h + th rows,
            (tx-1)*step_w + tw columns) to produce; default the whole canvas.
        normalize: True returns canvas / max(norm, eps); False returns the
            pair (canvas, norm), norm being [1, out_h, out_w] fp32.
        out_dtype: fp32 or bf16, default the tiles' dtype.

    CPU tensors take :func:`grid_merge_reference`; CUDA tensors launch the
    kernel, which picks its route from the geometry and the tensors'
    alignment (``cell`` or ``general``, see ``cell_takes`` in
    ``csrc/tile_merge.cu``); launches are counted in ``grid_merge.launches``
    and, by the route the kernel took, ``grid_merge.launches_by_route``.
    """
    if tiles.device.type == "cpu":
        return grid_merge_reference(tiles, weight, grid, out_hw, offset, normalize, out_dtype)
    if tiles.device.type != "cuda":
        raise ValueError(f"grid_merge: unsupported device {tiles.device}")
    ty, tx, sh, sw, out_h, out_w, off_y, off_x = _geometry(tiles, grid, out_hw, offset)
    _, k, th, tw = tiles.shape
    out_dtype = out_dtype or tiles.dtype
    if tiles.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise TypeError(f"grid_merge takes fp32/bf16 tiles and output, got {tiles.dtype} -> {out_dtype}")
    if not tiles.is_contiguous():
        raise ValueError("grid_merge: tiles must be contiguous [N, K, th, tw]")
    if (
        weight.device != tiles.device
        or weight.dtype != torch.float32
        or tuple(weight.shape) != (th, tw)
        or not weight.is_contiguous()
    ):
        raise ValueError(f"grid_merge: weight must be a contiguous fp32 [{th}, {tw}] tensor on {tiles.device}")
    out = torch.empty(k, out_h, out_w, dtype=out_dtype, device=tiles.device)
    norm = None if normalize else torch.empty(1, out_h, out_w, dtype=torch.float32, device=tiles.device)
    route = ctypes.c_int(-1)
    err = _build.library().ptt_grid_merge(
        tiles.device.index, tiles.data_ptr(), _DTYPE_CODES[tiles.dtype], weight.data_ptr(),
        out.data_ptr(), _DTYPE_CODES[out_dtype], None if norm is None else norm.data_ptr(),
        k, th, tw, ty, tx, sh, sw, out_h, out_w, off_y, off_x, int(normalize), NORM_EPS, ctypes.byref(route),
        _build.stream_of(tiles.device),
    )
    _build.check(err, "grid_merge")
    grid_merge.launches += 1
    grid_merge.launches_by_route[_ROUTES[route.value]] += 1
    return out if normalize else (out, norm)


# K1's routes (csrc/tile_merge.cu), indexed by the code ptt_grid_merge reports
_ROUTES = ("general", "cell")

grid_merge.launches = 0
grid_merge.launches_by_route = dict.fromkeys(_ROUTES, 0)


# Tiles per launch of the scatter merge (kMaxTiles in csrc/scatter_merge.cu):
# their coordinates sit in the kernel's shared memory.
MAX_TILES_PER_LAUNCH = 1024


def _scatter_coords(canvas: torch.Tensor, norm: torch.Tensor, tiles: torch.Tensor, coords_yx, weight) -> np.ndarray:
    """Check the geometry of a scatter merge; return the coordinates as an
    int64 [N, 2] numpy array of (row, col)."""
    if canvas.ndim != 3 or tuple(norm.shape) != (1, *canvas.shape[1:]):
        raise ValueError(f"canvas must be [C, H, W] and norm [1, H, W], got {tuple(canvas.shape)}, {tuple(norm.shape)}")
    if tiles.ndim != 4 or tiles.shape[1] != canvas.shape[0]:
        raise ValueError(f"tiles must be [N, {canvas.shape[0]}, th, tw], got shape {tuple(tiles.shape)}")
    if canvas.dtype != torch.float32 or norm.dtype != torch.float32:
        raise TypeError(f"canvas and norm must be fp32, got {canvas.dtype} and {norm.dtype}")
    n, _, th, tw = tiles.shape
    if tuple(weight.shape) != (th, tw):
        raise ValueError(f"weight must be [{th}, {tw}], got shape {tuple(weight.shape)}")
    if torch.is_tensor(coords_yx):
        coords_yx = coords_yx.detach().cpu().numpy()  # host coordinates spare this copy (and its sync)
    coords = np.asarray(coords_yx, dtype=np.int64).reshape(-1, 2)
    if len(coords) != n:
        raise ValueError(f"{len(coords)} coordinates for {n} tiles")
    h, w = canvas.shape[1:]
    if n and ((coords < 0).any() or (coords[:, 0] + th > h).any() or (coords[:, 1] + tw > w).any()):
        raise ValueError(f"tile coordinates run off the [{h}, {w}] canvas")
    return coords


def accumulate_tiles_reference(canvas, norm, tiles, coords_yx, weight):
    """Plain version of :func:`accumulate_tiles`: fp32 slice-adds in tile
    order (the product rounded, then the sum).  Updates and returns
    ``(canvas, norm)``."""
    coords = _scatter_coords(canvas, norm, tiles, coords_yx, weight)
    th, tw = tiles.shape[2:]
    w = weight.to(device=canvas.device, dtype=torch.float32)
    for tile, (y, x) in zip(tiles, coords.tolist()):
        canvas[:, y : y + th, x : x + tw] += tile.to(torch.float32) * w
        norm[:, y : y + th, x : x + tw] += w
    return canvas, norm


def accumulate_tiles(canvas, norm, tiles, coords_yx, weight):
    """Weighted scatter-add of a batch of tiles into ``canvas`` and ``norm``,
    in place and in batch order: ``canvas[:, y:y+th, x:x+tw] += tile * w``,
    ``norm[:, y:y+th, x:x+tw] += w``.

    Args:
        canvas: [C, H, W] fp32 accumulator, updated in place.
        norm: [1, H, W] fp32 weight accumulator, updated in place.
        tiles: [N, C, th, tw] fp32 or bf16 (bf16 is read as it is: it
            converts to fp32 exactly).
        coords_yx: [N, 2] (row, col) of each tile's top-left corner; any
            coordinates inside the canvas, no alignment asked.  A numpy
            array (or CPU tensor) is best: the wrapper checks them on the
            host and copies them to the card without a sync.
        weight: [th, tw] fp32 blend window.

    Returns ``(canvas, norm)``.  Coordinates that run off the canvas raise.
    CPU tensors take :func:`accumulate_tiles_reference`; CUDA tensors launch
    the kernel (counted in ``accumulate_tiles.launches``), one launch per
    ``MAX_TILES_PER_LAUNCH`` tiles.
    """
    if canvas.device.type == "cpu":
        return accumulate_tiles_reference(canvas, norm, tiles, coords_yx, weight)
    if canvas.device.type != "cuda":
        raise ValueError(f"accumulate_tiles: unsupported device {canvas.device}")
    coords = _scatter_coords(canvas, norm, tiles, coords_yx, weight)
    if tiles.dtype not in _DTYPE_CODES or weight.dtype != torch.float32:
        raise TypeError(f"accumulate_tiles takes fp32/bf16 tiles and an fp32 weight, got {tiles.dtype}, {weight.dtype}")
    if any(t.device != canvas.device for t in (norm, tiles, weight)):
        raise ValueError(f"accumulate_tiles: norm, tiles and weight must lie on {canvas.device}")
    if not all(t.is_contiguous() for t in (canvas, norm, tiles, weight)):
        raise ValueError("accumulate_tiles: canvas, norm, tiles and weight must be contiguous")
    n, c, th, tw = tiles.shape
    h, w = canvas.shape[1:]
    lib = _build.library()
    stream = _build.stream_of(canvas.device)
    tile_bytes = c * th * tw * tiles.element_size()
    for start in range(0, n, MAX_TILES_PER_LAUNCH):
        chunk = np.ascontiguousarray(coords[start : start + MAX_TILES_PER_LAUNCH])
        (y0, x0), (y1, x1) = chunk.min(0), chunk.max(0) + (th, tw)
        # pinned host memory: the copy joins the stream and the host does not wait
        chunk_dev = torch.from_numpy(chunk).pin_memory().to(canvas.device, non_blocking=True)
        err = lib.ptt_scatter_merge(
            canvas.device.index, canvas.data_ptr(), norm.data_ptr(), tiles.data_ptr() + start * tile_bytes,
            _DTYPE_CODES[tiles.dtype], weight.data_ptr(), chunk_dev.data_ptr(), len(chunk), c, h, w, th, tw,
            int(y0), int(x0), int(y1 - y0), int(x1 - x0), stream,
        )
        _build.check(err, "accumulate_tiles")
        accumulate_tiles.launches += 1
    return canvas, norm


accumulate_tiles.launches = 0
