"""q1_host_us (layer: kernels): the host's µs per ``qconv2d`` call on the
card, the port's ``q1.call`` span: checks, route choice, packing the
arguments and the ctypes launch of Q1, under the profiler."""

from portbench import program_spans


def read(ctx):
    return program_spans.host_us_per_call(ctx, "q1.call")
