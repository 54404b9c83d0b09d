"""Tracing and step timing (counterpart of ``fastegnn_tpu/utils/profiling.py``).

- :func:`span`: a named range on the profiler's timeline around a part of
  the program (the train step, a model layer, a kernel's launch path, the
  batcher), recorded only while a ``torch.profiler`` profile runs.
- :func:`profile_trace`: a ``torch.profiler`` trace of a block (the host,
  every thread, and the card's kernels when there is one), written as a
  Chrome trace (``trace.json``, for Perfetto or ``chrome://tracing``).
- :class:`StepTimer`: the intervals between step completions in a run of
  steps, without stalling the host behind the device on every step: on a
  card each mark records a CUDA event, and the times are read once, after
  a ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List

import torch
from torch.autograd import profiler as _profiler

# what span() returns while no profiler records: entered and left at no cost
NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` as a ``record_function``
    range while a profiler runs, and is :data:`NO_SPAN` otherwise.

    The test reads the profiler's process-wide flag, which every thread
    sees: its thread-local state is off in threads the profiler did not
    start (the batcher's prefetch threads), whose ranges it records only
    when it profiles all threads, as :func:`profile_trace` does.  Names are
    constant strings; the spans live in the profiler's memory and are
    written with its trace, on the clock of its kernels and runtime calls.
    """
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return NO_SPAN


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the enclosed block, on every thread, and write
    ``log_dir/trace.json``."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """The intervals between step completions in a run of steps, in ms.

    ``start()`` marks the run's origin, before its first step, and
    ``stop()`` marks each step's end; a step's time runs from the previous
    mark to its own, so the wait for its batch and any stall before it
    count.  On a card the marks are CUDA events, so a step's time runs from
    when the card finished the work before it to when its last kernel ends.
    Usage::

        timer = StepTimer(device)
        timer.start()
        for batch in batches:
            step(batch)
            timer.stop()
        ms = timer.step_ms()     # synchronises once, and starts a new run
    """

    def __init__(self, device=None):
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._marks: List = []

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self) -> None:
        """Start a run: mark its origin, before its first step."""
        self._marks = [self._now()]

    def stop(self) -> None:
        """Mark the end of a step."""
        self._marks.append(self._now())

    def step_ms(self) -> List[float]:
        marks, self._marks = self._marks, []
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
