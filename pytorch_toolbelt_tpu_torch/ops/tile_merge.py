"""Overlap-add merge of a complete regular tile grid (kernel K1).

Counterpart of ``pytorch_toolbelt_tpu/ops/tile_merge.py``.  The TPU package
merges a grid with the Pallas gather kernel ``pallas_grid_merge``; here the
same gather formulation is a CUDA kernel (``csrc/tile_merge.cu``) that also
fuses the normalisation by the summed window and the crop of the margins, so
tiled inference ends with one launch that writes each output element once.

Tiles are ``[N, K, th, tw]`` (NCHW per tile) in row-major grid order, the
blend window is ``[th, tw]``, and the canvas is ``[K, H, W]``.

:func:`grid_merge` launches the kernel for CUDA tensors and runs
:func:`grid_merge_reference` (torch slice-adds in tile order) for CPU
tensors; on any other device it raises.
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

__all__ = ["detect_regular_grid", "grid_merge", "grid_merge_reference"]

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
    kernel (counted in ``grid_merge.launches``).
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
    lib = _build.library()
    err = lib.ptt_grid_merge(
        tiles.device.index, tiles.data_ptr(), _DTYPE_CODES[tiles.dtype], weight.data_ptr(),
        out.data_ptr(), _DTYPE_CODES[out_dtype], None if norm is None else norm.data_ptr(),
        k, th, tw, ty, tx, sh, sw, out_h, out_w, off_y, off_x, int(normalize), NORM_EPS,
        _build.stream_of(tiles.device),
    )
    _build.check(err, "grid_merge")
    grid_merge.launches += 1
    return out if normalize else (out, norm)


grid_merge.launches = 0
