"""q2_roofline (layer: kernels): Q2's least time for the traced
requests' decoder inputs (x, skip and output bytes once over the HBM rate;
yardstick.q2_bound_s) over Q2's device time.  Nothing to read where the
configuration's reference has no decoder inputs on Q2."""

import re

Q2 = re.compile(r"q_upsample_band_kernel|q_upsample_kernel")  # chip_smoke.py INT8_KINDS


def read(ctx):
    q2_s = sum(b - a for a, b, name in ctx.events if Q2.search(name)) / 1e6
    bounds = [ctx.yardstick.q2_bound_s(ctx.reference, ctx.cfg, views) for views in ctx.request_views]
    if q2_s <= 0 or None in bounds:
        return None
    return 100.0 * sum(bounds) / q2_s
