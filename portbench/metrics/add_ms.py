"""add_ms (layer: model step): the card's ms per request inside the port's
``int8.add`` spans: the int8 encoder-decoder's residual and FPN adds (widen to
int32, two multiplies, ReLU, rounding shift, clip, channels_last copy)."""

from portbench import program_spans


def read(ctx):
    return program_spans.device_ms(ctx, "int8.add")
