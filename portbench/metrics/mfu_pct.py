"""mfu_pct (layer: model step): the configuration's int8 conv operations of
the traced requests, counted from its conv shapes and the views each request
sends through the model, over the traced window and the card's dense int8
peak (yardstick.INT8_PEAK)."""


def read(ctx):
    if not ctx.events:
        return None
    ops = sum(ctx.yardstick.request_ops(ctx.reference, ctx.cfg, views) for views in ctx.request_views)
    return 100.0 * ops / ctx.window_s / ctx.yardstick.INT8_PEAK
