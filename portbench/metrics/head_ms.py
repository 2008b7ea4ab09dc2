"""head_ms (layer: model step): the card's ms per request inside the port's
``int8.head`` spans: the head's conv on Q1, the dequant and, in the
encoder-decoder, the float32 resize with its matrices, and any idle the card
spends waiting on the host there."""

from portbench import program_spans


def read(ctx):
    return program_spans.device_ms(ctx, "int8.head")
