"""Host spans of the benchmark's own loop: each is a ``record_function``
range for the profiler's timeline (``portbench.<name>``) and a sum of host
seconds by name, from any thread."""

import threading
import time
from collections import defaultdict
from contextlib import contextmanager

from torch.autograd.profiler import record_function

PREFIX = "portbench."


class Spans:
    def __init__(self):
        self.seconds = defaultdict(float)
        self._lock = threading.Lock()

    @contextmanager
    def __call__(self, name: str):
        with record_function(PREFIX + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.seconds[name] += dt

    def reset(self) -> None:
        with self._lock:
            self.seconds.clear()
