"""How a request is served: one class per ``entry`` a traffic file names,
each driving the program only through its public entry points, and the
samples each request sends through the model (``views``).

A request is one user image, [H, W, 3] uint8 on the host; ``serve`` returns
the entry's merged map on the device, [K, H, W] in the dtype the entry
returns.  ``spans`` times the benchmark's own steps around the program's
calls."""

import collections
import concurrent.futures
import functools

import numpy as np
import torch

from portbench import inputs
from portbench.reference.common import TileGrid


class TiledD4:
    """``tiled_apply_d4_tta`` over the whole image on the card: the image is
    copied in and normalised by the user's code, then padded, cut into tiles,
    run through the model on d4 views and merged by K1 inside the program."""

    def __init__(self, traffic, forward, device, spans, num_classes):
        from pytorch_toolbelt_tpu_torch.inference import tiled_apply_d4_tta

        self.t, self.forward, self.device, self.spans = traffic, forward, device, spans
        self.apply = functools.partial(tiled_apply_d4_tta, tile_size=traffic["tile"], tile_step=traffic["step"],
                                       weight=traffic["weight"], batch_size=traffic["batch"], mode=traffic["mode"])

    def serve(self, image: torch.Tensor) -> torch.Tensor:
        with self.spans("h2d_normalize"):
            x = inputs.normalize(image.to(self.device, non_blocking=True))
        with self.spans("program"):
            return self.apply(self.forward, x)


class MultiscaleD4:
    """``MultiscaleTTA(d4_image2mask(model))`` on the whole image: the model
    runs on the 8 d4 views at each size offset; the outputs are resized back
    and reduced."""

    def __init__(self, traffic, forward, device, spans, num_classes):
        from pytorch_toolbelt_tpu_torch.inference import MultiscaleTTA, d4_image2mask

        self.device, self.spans = device, spans
        self.tta = MultiscaleTTA(functools.partial(d4_image2mask, forward), size_offsets=traffic["size_offsets"])

    def serve(self, image: torch.Tensor) -> torch.Tensor:
        with self.spans("h2d_normalize"):
            x = inputs.normalize(image.to(self.device, non_blocking=True)[None])
        with self.spans("program"):
            return self.tta(x)[0]


class _Cutter:
    """The tiles of one image shape, cut as ``ImageSlicer.split`` cuts them
    (the image zero-padded by the slicer's margins, each tile at its crop),
    from a padded host canvas kept for the shape: the image's rows are
    copied in as the batches reach them, and a batch's tiles leave by one
    strided copy per row of the tile grid, so that the thread that cuts
    holds Python's lock for microseconds a batch."""

    def __init__(self, slicer, channels: int):
        (th, tw), (sh, sw) = slicer.tile_size, slicer.tile_step
        self.top, self.left = slicer.margin_top, slicer.margin_left
        self.h, self.w = slicer.image_height, slicer.image_width
        self.canvas = np.zeros((*slicer.target_shape, channels), dtype=np.uint8)
        windows = np.lib.stride_tricks.sliding_window_view(self.canvas, (th, tw), axis=(0, 1))
        self.grid = windows[::sh, ::sw].transpose(0, 1, 3, 4, 2)  # [rows, cols, th, tw, channels]
        self.cols, self.row_step, self.tile_h, self.rows_in = self.grid.shape[1], sh, th, 0
        rows, cols = np.divmod(np.arange(self.grid.shape[0] * self.cols), self.cols)
        if not np.array_equal(slicer.crops[:, :2], np.stack([cols * sw, rows * sh], axis=1)):
            raise ValueError("the slicer's crops are not a row-major grid of its tile step")

    def start(self, image: np.ndarray) -> None:
        self.image, self.rows_in = image, 0

    def cut(self, out: np.ndarray, start: int, n: int) -> None:
        """Tiles ``start`` .. ``start + n - 1`` into ``out[:n]``."""
        first, last = start // self.cols, (start + n - 1) // self.cols
        need = min(self.h, last * self.row_step + self.tile_h - self.top)
        if need > self.rows_in:
            band = self.canvas[self.top + self.rows_in:self.top + need]
            band[:, self.left:self.left + self.w] = self.image[self.rows_in:need]
            self.rows_in = need
        j = 0
        for row in range(first, last + 1):
            c0 = max(start - row * self.cols, 0)
            c1 = min(start + n - row * self.cols, self.cols)
            out[j:j + c1 - c0] = self.grid[row, c0:c1]
            j += c1 - c0


class Stream:
    """The reference's streaming loop on images too big for the card:
    ``ImageSlicer`` sets the tiles on the host, and one producer thread cuts
    each batch of them (``_Cutter``) into one of the user's ring of pinned
    buffers (``prefetch`` of them, made at the first request), up to
    ``prefetch`` batches ahead of the one the card takes; each batch is
    copied and normalised, run through the model, and accumulated by
    ``TileMerger.integrate_batch`` (K3); then ``merge()`` and the crop.  A
    buffer is refilled only once its last copy has left it.  The producer
    works on the request being served only: the next image is cut once this
    one's map is back."""

    def __init__(self, traffic, forward, device, spans, num_classes):
        self.t, self.forward, self.device, self.spans = traffic, forward, device, spans
        self.num_classes, self.slicers, self.buffers = num_classes, {}, []
        self.producer = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="portbench-tiles")

    def _fill(self, cutter: _Cutter, k: int, start: int, n: int) -> int:
        """On the producer thread: tiles ``start`` .. ``start + n - 1`` into buffer ``k``."""
        host, copied = self.buffers[k % len(self.buffers)]
        if copied is not None:
            copied.synchronize()
        with self.spans("slice"):
            cutter.cut(host.numpy(), start, n)
        return n

    def serve(self, image: torch.Tensor) -> torch.Tensor:
        from pytorch_toolbelt_tpu_torch.inference import ImageSlicer, TileMerger

        t, spans = self.t, self.spans
        shape = tuple(image.shape)
        if shape not in self.slicers:
            slicer = ImageSlicer(shape[:2], t["tile"], t["step"], weight=t["weight"])
            self.slicers[shape] = slicer, _Cutter(slicer, shape[2])
        slicer, cutter = self.slicers[shape]
        batch, on_card = t["batch"], torch.device(self.device).type == "cuda"
        if not self.buffers:
            self.buffers = [(torch.empty((batch, *slicer.tile_size, shape[2]), dtype=torch.uint8, pin_memory=on_card),
                             torch.cuda.Event() if on_card else None) for _ in range(t["prefetch"])]
        depth, starts = len(self.buffers), range(0, len(slicer.crops), batch)
        sizes = [min(batch, len(slicer.crops) - start) for start in starts]
        cutter.start(image.numpy())
        pending = collections.deque(self.producer.submit(self._fill, cutter, k, starts[k], sizes[k])
                                    for k in range(min(depth, len(starts))))
        try:
            with spans("program"):
                merger = TileMerger(slicer.target_shape, channels=self.num_classes, weight=slicer.weight,
                                    device=self.device, use_pallas=True)
            for k, start in enumerate(starts):
                with spans("tile_wait"):
                    n = pending.popleft().result()
                host, copied = self.buffers[k % depth]
                with spans("h2d_normalize"):
                    x_u8 = host[:n].to(self.device, non_blocking=True)
                    if on_card:
                        copied.record()
                    x = inputs.normalize(x_u8)
                if k + depth < len(starts):
                    pending.append(self.producer.submit(self._fill, cutter, k + depth, starts[k + depth],
                                                        sizes[k + depth]))
                with spans("program"):
                    merger.integrate_batch(self.forward(x), slicer.crops[start:start + batch])
            with spans("program"):
                return slicer.crop_to_original_size(merger.merge())
        finally:  # a request that fails leaves no fill behind to write into the next one's buffers
            for future in pending:
                future.cancel()
            concurrent.futures.wait(pending)

    def close(self) -> None:
        self.producer.shutdown(wait=True)


ENTRIES = {"tiled_d4": TiledD4, "multiscale_d4": MultiscaleD4, "stream": Stream}


def views(traffic: dict, image_hw) -> list:
    """[(samples, h, w)] that one request of ``image_hw`` sends through the model."""
    entry = traffic["entry"]
    if entry in ("tiled_d4", "stream"):
        grid = TileGrid(image_hw, traffic["tile"], traffic["step"])
        per_tile = 1 if entry == "stream" else (2 if traffic["mode"] == "distributed" else 8)
        return [(per_tile * grid.rows * grid.cols, traffic["tile"], traffic["tile"])]
    if entry == "multiscale_d4":
        return [(8, image_hw[0] + off, image_hw[1] + off) for off in traffic["size_offsets"]]
    raise ValueError(f"unknown entry {entry!r}")
