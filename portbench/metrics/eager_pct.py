"""eager_pct (layer: model step): the share of the card's busy time in
kernels that are none of the port's own (Q1, Q2, K1-K5, the bf16 conv) and
no library GEMM or conv: the elementwise, clamp, copy and pooling passes.
The host-device copies and memsets are busy time but no pass."""

import re

PORT = re.compile(r"qconv_kernel|qconv_wgmma_kernel|qconv_gemm_kernel|q_upsample|grid_merge|scatter_merge|conv3x3"
                  r"|radix_|block_sort|merge_kernel|partition_kernel")
LIBRARY = re.compile(r"gemm|gemv|cutlass|xmma|cudnn|cublas|sm90_|sm80_|fprop|dgrad|wgrad|convolve")
TRANSFER = re.compile(r"^Memcpy|^Memset")


def read(ctx):
    if not ctx.events:
        return None
    eager = sum(b - a for a, b, name in ctx.events
                if not (PORT.search(name) or LIBRARY.search(name) or TRANSFER.search(name)))
    return 100.0 * eager / 1e6 / ctx.busy_s
