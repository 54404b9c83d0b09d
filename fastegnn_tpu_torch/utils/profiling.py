"""Tracing and step timing (counterpart of ``fastegnn_tpu/utils/profiling.py``).

- :func:`profile_trace`: a ``torch.profiler`` trace of a block (the host,
  and the card's kernels when there is one), written as a Chrome trace
  (``trace.json``, for Perfetto or ``chrome://tracing``).
- :class:`StepTimer`: per-step times of a run of steps without stalling the
  host behind the device on every step: on a card each mark records a CUDA
  event, and the times are read once, after a ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the enclosed block and write ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """The time of each step between its ``start()`` and ``stop()``, in ms.

    On a card both marks are CUDA events, so a step's time runs from when
    the card reaches its first kernel (or the host issues it, if the card
    is idle) to when its last kernel ends, and waiting for the next batch
    between steps is not counted.  Usage::

        timer = StepTimer(device)
        for batch in batches:
            timer.start()
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
        self._marks.append(self._now())

    stop = start

    def step_ms(self) -> List[float]:
        marks, self._marks = self._marks, []
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(marks[::2], marks[1::2])]
        return [(b - a) * 1e3 for a, b in zip(marks[::2], marks[1::2])]
