"""The reference side of each ``entry``: what the program's entry point
computes for one request, in plain torch on the reference's model.  Frozen
copies of ``inference/tiles.py`` (``_tiled_apply_grouped`` with d4 views,
``ImageSlicer`` + ``TileMerger``) and ``inference/tta.py``
(``MultiscaleTTA`` over ``d4_image2mask``); K1 and K3 are their plain
versions (``common.grid_merge``, ``common.accumulate``), whose sums they
equal bit for bit.

The int8 forward is exact and every sample is its own, so the tiled entries
may run the model in chunks of any size; the multiscale and streaming
entries run it on the program's batches, whose float32 products (the SE
gates, the head's resize) are then the program's."""

import numpy as np
import torch
import torch.nn.functional as F

from portbench import inputs
from portbench.reference import common as C

TILE_CHUNK = 8  # tiles per call of the model in the tiled entry: bounds its float64 memory


def tiled_d4(traffic, model, image: torch.Tensor, device) -> torch.Tensor:
    x = inputs.normalize(image.to(device))
    _, h, w = x.shape
    grid = C.TileGrid((h, w), traffic["tile"], traffic["step"])
    th = tw = traffic["tile"]
    sh = sw = traffic["step"]
    padded = F.pad(x, (grid.left, grid.right, grid.top, grid.bottom))
    tile_view = padded.unfold(1, th, sh).unfold(2, tw, sw)
    corners = np.array(grid.corners)
    if traffic["mode"] == "distributed":
        parity = (corners[:, 0] // sh) % 2 * 2 + (corners[:, 1] // sw) % 2
        groups = [(np.flatnonzero(parity == g), C.PARITY_VIEW_PAIRS[g]) for g in range(4)]
    else:
        groups = [(np.arange(len(corners)), tuple(range(8)))]
    stack = None
    for index, views in groups:
        for start in range(0, len(index), TILE_CHUNK):
            chunk = index[start:start + TILE_CHUNK]
            iy = torch.as_tensor(corners[chunk, 0] // sh, device=device)
            ix = torch.as_tensor(corners[chunk, 1] // sw, device=device)
            tiles = tile_view[:, iy, ix].permute(1, 0, 2, 3).contiguous()
            preds = C.d4_views(model, tiles, views)
            if stack is None:
                stack = torch.empty(len(corners), preds.shape[1], th, tw, dtype=torch.float32, device=device)
            stack[iy * grid.cols + ix] = preds.float()
    weight = torch.as_tensor(C.pyramid_weight(th, tw).astype(np.float32), device=device)
    return C.grid_merge(stack, weight, grid)


def multiscale_d4(traffic, model, image: torch.Tensor, device) -> torch.Tensor:
    x = inputs.normalize(image.to(device)[None])
    rows, cols = x.shape[2:]
    outs = []
    for off in traffic["size_offsets"]:
        xi = x if off == 0 else F.interpolate(x, size=(rows + off, cols + off), mode="bilinear", align_corners=False)
        yi = C.d4_views(model, xi, tuple(range(8)))
        if off != 0:
            yi = F.interpolate(yi, size=(rows, cols), mode="bilinear", align_corners=True)
        outs.append(yi)
    return torch.stack(outs).mean(dim=0)[0]


def stream(traffic, model, image: torch.Tensor, device) -> torch.Tensor:
    img = image.numpy()
    h, w = img.shape[:2]
    grid = C.TileGrid((h, w), traffic["tile"], traffic["step"])
    t = traffic["tile"]
    padded = np.pad(img, ((grid.top, grid.bottom), (grid.left, grid.right), (0, 0)))
    weight = torch.as_tensor(C.pyramid_weight(t, t), dtype=torch.float32, device=device)
    canvas = norm = None
    batch = traffic["batch"]
    for start in range(0, len(grid.corners), batch):
        corners = grid.corners[start:start + batch]
        host = np.stack([padded[y:y + t, x:x + t] for y, x in corners])
        preds = model(inputs.normalize(torch.from_numpy(host).to(device)))
        if canvas is None:
            canvas = torch.zeros(preds.shape[1], *grid.canvas, dtype=torch.float32, device=device)
            norm = torch.zeros(1, *grid.canvas, dtype=torch.float32, device=device)
        C.accumulate(canvas, norm, preds, corners, weight)
    return grid.crop(canvas / norm)


ENTRIES = {"tiled_d4": tiled_d4, "multiscale_d4": multiscale_d4, "stream": stream}
