"""Profiling and tracing helpers.

The counterpart of the JAX package's ``utils/profiling.py``, over
``torch.profiler``: any phase of the loop can be captured as a Chrome trace
(TensorBoard's profiler plugin or Perfetto open it), and named spans mark
the program's phases inside such a trace.

A span (:func:`span`) is a ``user_annotation`` range of the host, on the
trace's clock beside the card's kernels, so each stretch in which the card
waits can be put down to what the host was doing. It records only while a
``torch.profiler`` session records the host's activity (``device_trace``,
or any plain ``torch.profiler.profile`` with ``ProfilerActivity.CPU``).
Otherwise it costs one read of the profiler's module-level flag: no
dispatcher call, no NVTX range, no CUDA event, no sync. Under a profile of
the card alone the flag is set but no host callback is registered, and a
span records nothing. Spans never touch a tensor, so what they enclose
computes the same with or without them.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

# A ``RecordFunction`` of the user scope without the dispatcher: the range
# ``torch.profiler.record_function`` opens, at a fifth of its host cost.
_enter = torch._C._autograd._record_function_with_args_enter
_exit = torch._C._autograd._record_function_with_args_exit


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a profile of the host and, where there is a card, the card;
    the Chrome trace lands in ``log_dir`` as ``*.pt.trace.json``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class _Span:
    __slots__ = ("name", "handle")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.handle = _enter(self.name)

    def __exit__(self, *exc):
        _exit(self.handle)


_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span("mcts/wave"): ...``: a named host range in a running
    profiler's trace; a shared no-op context when no profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


#: The JAX package's name for a named region of a trace.
annotate = span
