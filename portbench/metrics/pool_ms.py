"""pool_ms (layer: model step): the card's ms per request inside the port's
``int8.pool`` spans: the int8 max pools (and average pools) of the quantized
models."""

from portbench import program_spans


def read(ctx):
    return program_spans.device_ms(ctx, "int8.pool")
