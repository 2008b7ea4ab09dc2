"""stream_host_ms (layer: inference): host ms per request that the
streaming loop's producer thread spends cutting tiles with
``ImageSlicer.iter_split`` into the pinned buffers (its ``slice`` span),
overlapped with the card's work or not."""


def read(ctx):
    if "slice" not in ctx.spans or not ctx.requests:
        return None
    return 1e3 * ctx.spans["slice"] / ctx.requests
