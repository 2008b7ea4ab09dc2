"""q1_roofline (layer: kernels): Q1's least time for the traced requests
(each conv's compulsory bytes over the HBM rate or its int8 operations over
the peak, the larger, summed; yardstick.q1_bound_s) over Q1's device time."""

import re

Q1 = re.compile(r"qconv_kernel|qconv_wgmma_kernel|qconv_gemm_kernel")  # chip_smoke.py INT8_KINDS


def read(ctx):
    q1_s = sum(b - a for a, b, name in ctx.events if Q1.search(name)) / 1e6
    if q1_s <= 0:
        return None
    bound = sum(ctx.yardstick.q1_bound_s(ctx.reference, ctx.cfg, views) for views in ctx.request_views)
    return 100.0 * bound / q1_s
