"""The reduction of a ``torch.profiler`` trace of the traced window to what
the per-layer readers take: the device's kernels, copies and memsets inside
the window, its busy time, and the longest idle gaps named by what the
host was doing.  ``device_events`` and ``busy_s`` are frozen copies of
``chip_smoke.py:1494`` ``_device_events`` and ``:1506`` ``_busy_ms``."""

import re
from collections import defaultdict

from portbench.spans import PREFIX

TOP = 10  # entries of each list of the breakdown
NAME_CHARS = 160  # a kernel's name is cut to this many characters once its namespaces are dropped
_NOISE = re.compile(r"^void |at::native::|\(anonymous namespace\)::|at::")


def short(name: str) -> str:
    return _NOISE.sub("", name)[:NAME_CHARS]


def device_events(prof) -> list:
    """(start us, end us, name) of each kernel, copy and memset the profile
    saw on the card, in the order they started; ranges that
    ``record_function`` marks on the card's timeline are not device work."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False))


def busy_s(events) -> float:
    """Length of the union of the (start us, end us, ...) intervals, in s."""
    busy, end = 0.0, float("-inf")
    for a, b, *_ in events:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def _host_events(prof):
    """(start us, end us, name) of the host's ops and the benchmark's spans
    on the thread that ran the requests, by start."""
    from torch.autograd import DeviceType

    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    threads = {e.thread for e in cpu if e.name == PREFIX + "request"}
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu if e.thread in threads)


def window(prof):
    """(start us, end us) of the traced requests on the profile's clock."""
    reqs = [(s, e) for s, e, name in _host_events(prof) if name == PREFIX + "request"]
    return min(s for s, _ in reqs), max(e for _, e in reqs)


def clip(events, lo: float, hi: float) -> list:
    return [(max(a, lo), min(b, hi), n) for a, b, n in events if b > lo and a < hi]


def top_device_ops(events) -> list:
    """[[name, seconds]] of the device operations that took most time."""
    total = defaultdict(float)
    for a, b, name in events:
        total[short(name)] += (b - a) / 1e6
    return [[name, s] for name, s in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def idle_gaps(prof, events, lo: float, hi: float) -> list:
    """[[what the host was doing, seconds]] of the device's idle time inside
    the window, summed by the innermost benchmark span and host op active
    where each gap starts; the largest sums first."""
    gaps, end = [], lo
    for a, b, _ in events:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    host = _host_events(prof)
    total, stack, span_stack, i = defaultdict(float), [], [], 0
    for g0, g1 in gaps:
        while i < len(host) and host[i][0] <= g0:
            s, e, name = host[i]
            target = span_stack if name.startswith(PREFIX) else stack
            while target and target[-1][1] <= s:
                target.pop()
            target.append((s, e, name))
            i += 1
        for target in (stack, span_stack):
            while target and target[-1][1] <= g0:
                target.pop()
        span = span_stack[-1][2][len(PREFIX):] if span_stack else "outside the spans"
        op = stack[-1][2] if stack else "no host op"
        total[f"{span} / {op}"] += (g1 - g0) / 1e6
    return [[name, s] for name, s in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]
