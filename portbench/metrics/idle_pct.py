"""idle_pct (layer: device): the share of the traced window in which no
kernel, copy or memset ran on the card, from the profiler's timeline."""


def read(ctx):
    if not ctx.events:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
