"""Profiling and timing (counterpart of ``pytorch_toolbelt_tpu/utils/profiling.py``).

``trace`` records a ``torch.profiler`` trace of the host and the card;
``benchmark`` times a call between CUDA events on the card (with
``device="cpu"``, on the host's clock).  The JAX package's
``describe_compile`` reports XLA's compile statistics and has no
counterpart here.

**Spans.**  The port marks its layer boundaries with :func:`span`.  A span
switches on only while a ``torch.profiler`` records (``trace()``, a user's
``torch.profiler.profile``) or a CUDA graph captures it (below); otherwise it
costs two flag checks.  When on, it
is a profiler range named ``ptt.<name>`` (torch's ``RecordFunction``, as
``record_function`` makes, at a tenth of its host cost) on the profiler's
clock, which the card's kernels share (``trace(log_dir)`` shows it on the
host's timeline in Perfetto, above the kernels it launched), a pair of CUDA
events on the current stream where it times the card, and the host seconds
between its ends.  The spans:

* ``tiles.apply`` (``tiled_apply*``, a root), ``tiles.stack`` (writing a
  batch's predictions into the tile stack), ``tiles.merge`` (the grid merge
  K1; ``TileMerger.merge`` / ``merge_``), ``tiles.integrate``
  (``TileMerger.integrate_batch``, K3 with ``use_pallas=True``);
* ``tta.multiscale`` (``MultiscaleTTA``, a root), ``tta.augment`` and
  ``tta.deaugment`` (the d4 views and the multiscale resizes);
* ``int8.forward`` (the int8 UNet's and encoder-decoder's forward),
  ``int8.graph`` (a replay of the encoder-decoder's CUDA graph),
  ``int8.add`` (residual and FPN adds), ``int8.se`` (SE gates),
  ``int8.head`` (the head's conv, dequant and resize; in the
  encoder-decoder two calls a forward: the conv and dequant, then the
  resize), ``int8.pool`` (the int8 max and average pools);
* ``q1.call`` (the host's path of one ``qconv2d`` call on the card).

The roots and parents (``tiles.apply``, ``tta.multiscale``,
``int8.forward``) and ``q1.call`` time the host only: a CUDA event pair
costs the host ~20-40 µs under a profiler, which no reader of theirs needs.

**Spans inside a CUDA graph.**  While a graph captures inside
:func:`capture_spans`, a span does not depend on a profiler: with a
:class:`GraphSpans` each span that times the card records its event pair
into the graph (``external`` events, so the pair times every replay) and
host-only spans are off; with None every span is off.  Replaying the graph through
:meth:`GraphSpans.replay` while a profiler records counts each captured
span as one call with no host time, under the span open on the host at the
replay.

:func:`span_totals` returns ``{name: {"calls", "host_s", "self_host_s",
"device_s", "parents", "roots"}}`` over every span closed while a profiler
recorded since :func:`reset_spans`: ``device_s`` is the card's stream time
between each call's two events, its kernels and any idle between them;
``self_host_s`` is ``host_s`` less the spans opened inside; ``parents``
counts calls by the name of the enclosing span (``None`` at a root) and
``roots`` the distinct root calls the span ran under (all spans under one
root call share its id; ids are counted per process, so two threads' roots
that interleave count as more).  A span opened inside an open span of the
same name on its thread is not counted again.  Spans switch on in the threads the
profiler records (torch's profiler: the thread that started it).
"""

import contextlib
import itertools
import os
import threading
import time
from collections import Counter, defaultdict
from typing import Callable, Dict, Optional, Union

import torch
from torch.autograd.profiler import record_function

__all__ = ["trace", "benchmark", "Timer", "span", "span_totals", "reset_spans", "GraphSpans", "capture_spans"]


@contextlib.contextmanager
def trace(log_dir: str, device: Union[str, torch.device] = "cuda"):
    """Record a ``torch.profiler`` trace of the block into ``log_dir`` as a
    Chrome trace (TensorBoard / Perfetto read it); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        _require_cuda()
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class Timer:
    """Plain wall-clock timer.  CUDA work is asynchronous: synchronize inside
    the block, or use :func:`benchmark`, to time the card's work rather than
    its launch."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false; pass device='cpu' to run on the CPU")


def benchmark(
    fn: Callable,
    *args,
    iters: int = 10,
    warmup: int = 2,
    device: Union[str, torch.device] = "cuda",
    **kwargs,
) -> Dict[str, float]:
    """Time ``fn(*args, **kwargs)`` after ``warmup`` calls: on the card each
    call between two CUDA events on the current stream, on the CPU on the
    host's clock.  Returns {'mean_s', 'best_s', 'iters'}."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        _require_cuda()
    for _ in range(warmup):
        fn(*args, **kwargs)
    times = []
    for _ in range(iters):
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kwargs)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            times.append(time.perf_counter() - t0)
    return {"mean_s": sum(times) / len(times), "best_s": min(times), "iters": iters}


_PREFIX = "ptt."
_PENDING = 4096  # spans closed and not summed before a span sums those the card has passed
# torch's C++ profiler range, which torch's compiled code marks its regions with: a tenth of the host cost of
# ``record_function`` while a profiler records
_range = getattr(torch._C._profiler, "_RecordFunctionFast", record_function)


class _Off:
    """The span of a process that is not being profiled: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Sums:
    """One span name's sums."""

    __slots__ = ("calls", "host_s", "self_host_s", "device_s", "parents", "roots", "last_root")

    def __init__(self):
        self.calls, self.host_s, self.self_host_s, self.device_s = 0, 0.0, 0.0, 0.0
        self.parents, self.roots, self.last_root = Counter(), 0, 0


class _Totals:
    """The spans closed and not yet summed, the sums by name, a pool of free
    CUDA events per device, and each thread's open spans.  A span only
    appends a record as it closes; the sums are made when they are read."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.root_ids = itertools.count(1)
        self.free = defaultdict(list)  # device index -> events
        self.clear()

    def clear(self) -> None:
        self.sums = defaultdict(_Sums)
        # (name, parent's name, root id, host s, self host s, start event, end event, device index), as they closed
        self.closed = []
        for graph in getattr(self, "replayed", ()):
            graph.pending = None
        self.replayed = []  # the GraphSpans whose last replay is not summed yet

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def event(self, index: int) -> torch.cuda.Event:
        try:
            return self.free[index].pop()
        except IndexError:
            return torch.cuda.Event(enable_timing=True)

    def fold(self, wait: bool = True) -> None:
        """Sum the closed spans and give their events back to the pool: all
        of them after one wait for each card, or with ``wait=False`` those
        up to the first whose events the card has not passed."""
        with self.lock:
            closed, self.closed = self.closed, []
            replayed = list(self.replayed)
        for graph in replayed:
            graph.settle(wait)
        if wait:
            for index in {r[-1] for r in closed if r[-1] >= 0}:
                torch.cuda.synchronize(index)
        with self.lock:
            for k, (name, parent, root, host_s, self_s, start, end, index) in enumerate(closed):
                if end is not None and not wait and not end.query():
                    self.closed[:0] = closed[k:]
                    return
                device_s = 0.0
                if end is not None:
                    device_s = start.elapsed_time(end) / 1e3
                    self.free[index] += [start, end]
                self.add(name, parent, root, host_s, self_s, device_s)

    def add(self, name: str, parent, root: int, host_s: float, self_s: float, device_s: float) -> None:
        """One call into its name's sums; the lock is held."""
        sums = self.sums[name]
        sums.calls += 1
        sums.host_s += host_s
        sums.self_host_s += self_s
        sums.device_s += device_s
        sums.parents[parent] += 1
        if sums.last_root != root:  # a thread's spans close in the order of their roots
            sums.last_root, sums.roots = root, sums.roots + 1


_totals = _Totals()


class _Span:
    __slots__ = ("name", "index", "stack", "parent", "root", "child_s", "range", "stream", "start", "t0")

    def __init__(self, name: str, index: int, stack: list):
        self.name, self.index, self.stack, self.start = name, index, stack, None

    def __enter__(self):
        parent = self.parent = self.stack[-1] if self.stack else None
        self.root = next(_totals.root_ids) if parent is None else parent.root
        self.child_s = 0.0
        self.stack.append(self)
        self.range = _range(_PREFIX + self.name)
        self.range.__enter__()
        if self.index >= 0:
            self.stream = torch.cuda.current_stream(self.index)
            self.start = _totals.event(self.index)
            self.start.record(self.stream)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self.t0
        end = None
        if self.start is not None:
            end = _totals.event(self.index)
            end.record(self.stream)
        self.range.__exit__(*exc)
        self.stack.pop()
        parent = self.parent
        if parent is not None:
            parent.child_s += host_s
        record = (self.name, None if parent is None else parent.name, self.root, host_s, host_s - self.child_s,
                  self.start, end, self.index)
        with _totals.lock:
            _totals.closed.append(record)
            full = len(_totals.closed) > _PENDING
        if full:  # a long profile: sum what the card has passed, so the events go back to the pool
            _totals.fold(wait=False)
        return False


def _cuda_index(device) -> int:
    """The CUDA device a span times, or -1 for host time only."""
    if isinstance(device, torch.Tensor):
        return device.get_device() if device.is_cuda else -1
    if device is True and torch.cuda.is_initialized():
        return torch.cuda.current_device()
    return -1


def span(name: str, device: Union[bool, torch.Tensor] = True):
    """A context manager that marks one call of a layer as ``ptt.<name>``
    while a ``torch.profiler`` records, and does nothing otherwise.

    ``device``: a tensor (times the card's stream where the tensor is on a
    CUDA device), ``True`` (the current CUDA device, once CUDA is
    initialised) or ``False`` (host time only)."""
    if _captures:
        capture = getattr(_totals.local, "capture", None)
        if capture is not None:  # this thread captures a CUDA graph
            return capture.span(name, device)
    if not torch.autograd._profiler_enabled():
        return _OFF
    stack = _totals.stack()
    for open_span in stack:
        if open_span.name == name:
            return _OFF
    return _Span(name, _cuda_index(device), stack)


def span_totals() -> Dict[str, dict]:
    """Per span name, the sums over the spans closed while a profiler
    recorded since :func:`reset_spans` (see the module's docstring); waits
    for the card once, where spans timed it."""
    _totals.fold()
    with _totals.lock:
        return {name: {"calls": s.calls, "host_s": s.host_s, "self_host_s": s.self_host_s, "device_s": s.device_s,
                       "parents": dict(s.parents), "roots": s.roots}
                for name, s in _totals.sums.items()}


def reset_spans() -> None:
    """Forget every span's sums and the spans not yet summed."""
    with _totals.lock:
        _totals.clear()


class GraphSpans:
    """The spans captured into one CUDA graph (:func:`capture_spans`): an
    event pair each, which every replay of the graph records anew."""

    def __init__(self):
        self.records = []  # (name, parent's name inside the graph or None, start event, end event), as they closed
        self.open = []  # the spans open while the graph captures
        self.pending = None  # (parent's name, root id) of the replay not summed yet

    def span(self, name: str, device):
        index = _cuda_index(device)
        if index < 0 or any(s.name == name for s in self.open):
            return _OFF
        return _CapturedSpan(self, name, index)

    def replay(self, graph: "torch.cuda.CUDAGraph") -> None:
        """Replay ``graph``, which was captured with these spans.  While a
        profiler records, its spans count as calls under the span open here,
        summed by :func:`span_totals` or before the next replay, which
        records their events anew and so first waits for this replay's end
        (a caller that replays two copies of a graph in turns waits only for
        the replay before last)."""
        self.settle(wait=True)
        graph.replay()
        if self.records and torch.autograd._profiler_enabled():
            stack = _totals.stack()
            parent = stack[-1] if stack else None
            with _totals.lock:
                self.pending = (None, next(_totals.root_ids)) if parent is None else (parent.name, parent.root)
                _totals.replayed.append(self)

    def settle(self, wait: bool) -> None:
        """Sum the last replay's spans once the card has passed it: after a
        wait for it, or with ``wait=False`` only if it has."""
        if self.pending is None:
            return
        last = self.records[-1][3]  # the last to close is the last on the stream
        if wait:
            last.synchronize()
        elif not last.query():
            return
        with _totals.lock:
            if self.pending is None:  # summed or forgotten meanwhile
                return
            (parent, root), self.pending = self.pending, None
            _totals.replayed.remove(self)
            for name, inner, start, end in self.records:
                _totals.add(name, inner or parent, root, 0.0, 0.0, start.elapsed_time(end) / 1e3)


class _NoSpans:
    """The spans of a capture that records none."""

    @staticmethod
    def span(name: str, device):
        return _OFF


class _CapturedSpan:
    __slots__ = ("graph", "name", "stream", "parent", "start")

    def __init__(self, graph: GraphSpans, name: str, index: int):
        self.graph, self.name, self.stream = graph, name, torch.cuda.current_stream(index)

    def __enter__(self):
        spans = self.graph.open
        self.parent = spans[-1].name if spans else None
        spans.append(self)
        self.start = _external_event(self.stream)
        return self

    def __exit__(self, *exc):
        end = _external_event(self.stream)
        self.graph.open.pop()
        self.graph.records.append((self.name, self.parent, self.start, end))
        return False


def _external_event(stream) -> torch.cuda.Event:
    """A timing event recorded on ``stream``: in a capture, an event node of
    the graph (not a dependency between streams)."""
    event = torch.cuda.Event(enable_timing=True, external=True)
    event.record(stream)
    return event


_captures = 0  # threads inside capture_spans


@contextlib.contextmanager
def capture_spans(spans: Optional[GraphSpans]):
    """For a block that captures a CUDA graph on this thread: with ``spans``,
    every span opened that times the card records its event pair into the
    graph and into ``spans`` (with or without a profiler) and host-only spans
    are off; with None, every span is off.  Other threads' spans are as
    before."""
    global _captures
    local = _totals.local
    previous = getattr(local, "capture", None)
    local.capture = _NoSpans if spans is None else spans
    with _totals.lock:
        _captures += 1
    try:
        yield spans
    finally:
        local.capture = previous
        with _totals.lock:
            _captures -= 1
