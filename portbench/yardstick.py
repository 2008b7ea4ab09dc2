"""The yardstick: the card's published peaks and the operation and byte
arithmetic of the int8 kernels, from the configurations' shapes and the
views the traffic runs, never from the route the program took.

Frozen copies of ``chip_smoke.py``'s sound arithmetic: the peaks
(``chip_smoke.py:262-264``), the bound as the larger of bytes over the HBM
rate and operations over the peak (``bound_ms``, ``:389``), Q1's operations
and compulsory bytes of a call (``_check_q1``, ``:2291-2292``) and Q2's
decoder-input bytes (``_check_q2_cat``, ``:2385``: x, skip and output once)."""

HBM_RATE = 3.35e12  # bytes/s, H100 SXM data sheet
INT8_PEAK = 1979e12  # dense int8 tensor-core operations/s, H100 SXM data sheet, at 700 W


def bound_s(nbytes: float, ops: float = 0.0) -> float:
    """The least time on the card's published peaks."""
    return max(nbytes / HBM_RATE, ops / INT8_PEAK)


def conv_ops(shape: dict, views: int) -> float:
    """int8 operations (2 per multiply-add) of one conv over ``views`` samples."""
    ci_pg = shape["cin"] // shape["groups"]
    return 2.0 * views * shape["ho"] * shape["wo"] * shape["cout"] * ci_pg * shape["kh"] * shape["kw"]


def conv_bytes(shape: dict, views: int) -> float:
    """Compulsory bytes of one conv over ``views`` samples: each int8 input
    read once, the weights once, each output written once (int32 for the
    head's raw accumulator)."""
    x = shape["cin"] * shape["h"] * shape["w"]
    y = shape["cout"] * shape["ho"] * shape["wo"] * shape["out_bytes"]
    weights = shape["cout"] * (shape["cin"] // shape["groups"]) * shape["kh"] * shape["kw"]
    return views * (x + y) + weights


def request_ops(reference, cfg: dict, views: list) -> float:
    """int8 conv operations of one request: ``views`` is [(samples, h, w)]."""
    return sum(conv_ops(s, n) for n, h, w in views for s in reference.conv_shapes(cfg, h, w))


def q1_bound_s(reference, cfg: dict, views: list) -> float:
    """Q1's least time for one request: each conv's bound over all the
    request's samples of its size, summed."""
    return sum(bound_s(conv_bytes(s, n), conv_ops(s, n)) for n, h, w in views
               for s in reference.conv_shapes(cfg, h, w))


def q2_bound_s(reference, cfg: dict, views: list):
    """Q2's least time for one request (decoder inputs: x, skip and output
    bytes once), or None where the configuration has no such call."""
    calls = getattr(reference, "q2_calls", None)
    if calls is None:
        return None
    nbytes = sum(n * (c["c"] * c["h"] * c["w"] + c["cs"] * c["oh"] * c["ow"] + (c["c"] + c["cs"]) * c["oh"] * c["ow"])
                 for n, h, w in views for c in calls(cfg, h, w))
    return bound_s(nbytes)
