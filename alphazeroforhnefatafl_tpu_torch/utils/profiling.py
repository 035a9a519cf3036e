"""Profiling and tracing helpers.

The counterpart of the JAX package's ``utils/profiling.py``, over
``torch.profiler``: any phase of the loop can be captured as a Chrome trace
(TensorBoard's profiler plugin or Perfetto open it), plus a simple
wall-clock scope for coarse step timings.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a profile of the host and, where there is a card, the card;
    the Chrome trace lands in ``log_dir`` as ``*.pt.trace.json``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region that shows up in device traces."""
    with record_function(name):
        yield


class Stopwatch:
    """Accumulating wall-clock scopes: ``with sw("selfplay"): ...``."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return {
            k: {"total_s": round(v, 4), "count": self.counts[k]}
            for k, v in self.totals.items()
        }
