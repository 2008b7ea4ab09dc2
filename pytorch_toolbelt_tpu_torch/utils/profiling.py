"""Profiling and timing (counterpart of ``pytorch_toolbelt_tpu/utils/profiling.py``).

``trace`` records a ``torch.profiler`` trace of the host and the card;
``benchmark`` times a call between CUDA events on the card (with
``device="cpu"``, on the host's clock).  The JAX package's
``describe_compile`` reports XLA's compile statistics and has no
counterpart here.
"""

import contextlib
import os
import time
from typing import Callable, Dict, Union

import torch

__all__ = ["trace", "benchmark", "Timer"]


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
