"""The port's own spans over the traced window, per request: the sums of
``pytorch_toolbelt_tpu_torch.utils.profiling.span_totals()``, which count
only spans closed while a profiler records, so the traced window's alone.
A program without spans, a run on the CPU (no card time) or a cell whose
requests enter none of the named spans reads nothing."""


def totals() -> dict:
    from pytorch_toolbelt_tpu_torch.utils import profiling

    read = getattr(profiling, "span_totals", None)
    return read() if read is not None else {}


def device_ms(ctx, *names):
    """The card's ms per request inside the named spans (each span's time
    between its two CUDA events on the stream, summed)."""
    spans = totals()
    seconds = sum(spans[name]["device_s"] for name in names if name in spans)
    if seconds <= 0 or not ctx.requests:
        return None
    return 1e3 * seconds / ctx.requests


def host_us_per_call(ctx, name):
    """The host's µs per call of the named span, on runs that used the card."""
    span = totals().get(name)
    if span is None or not span["calls"] or not ctx.events:
        return None
    return 1e6 * span["host_s"] / span["calls"]
