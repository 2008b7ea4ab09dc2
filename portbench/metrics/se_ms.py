"""se_ms (layer: model step): the card's ms per request inside the port's
``int8.se`` spans: the SE gates (the float squeeze and its GEMMs, the integer
excitation multiply and requant)."""

from portbench import program_spans


def read(ctx):
    return program_spans.device_ms(ctx, "int8.se")
