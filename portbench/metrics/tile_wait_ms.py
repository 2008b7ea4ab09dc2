"""tile_wait_ms (layer: inference): host ms per request in which the
streaming loop waits for its producer thread's next batch of tiles (the
``tile_wait`` span): the part of the host's cutting that the card's work
does not hide."""


def read(ctx):
    if "tile_wait" not in ctx.spans or not ctx.requests:
        return None
    return 1e3 * ctx.spans["tile_wait"] / ctx.requests
