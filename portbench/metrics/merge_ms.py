"""merge_ms (layer: inference): the card's ms per request inside the port's
``tiles.stack``, ``tiles.merge`` and ``tiles.integrate`` spans: writing each
batch's predictions into the tile stack, the grid merge K1 or
``TileMerger``'s K3 batches and its final divide."""

from portbench import program_spans


def read(ctx):
    return program_spans.device_ms(ctx, "tiles.stack", "tiles.merge", "tiles.integrate")
