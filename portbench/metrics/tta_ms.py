"""tta_ms (layer: inference): the card's ms per request inside the port's
``tta.augment`` and ``tta.deaugment`` spans: making the d4 views and the
multiscale resizes, and undoing and reducing them."""

from portbench import program_spans


def read(ctx):
    return program_spans.device_ms(ctx, "tta.augment", "tta.deaugment")
