"""The profiled window of a ``--trace 1`` run: what ran on the device, when,
and what the host was doing in the device's idle gaps.

The harness wraps the window in the annotation ``bench.window`` and each
step's parts in ``bench.next_batch`` (the wait for the next batch and its
copy to the card) and ``bench.step`` (the train step's dispatch).  From
the profiler's Chrome trace it keeps the device operations (kernels,
copies, fills) inside the window, their union, and the gaps between.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from collections import defaultdict
from typing import List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPANS = ("bench.next_batch", "bench.step")


@dataclasses.dataclass
class Trace:
    window_us: float
    kernels: List[Tuple[str, float, float]]     # (name, start us, duration us), kernels only
    device_ops: List[Tuple[str, float, float]]  # kernels, copies and fills
    busy_us: float                              # union of the device ops in the window
    gaps: List[Tuple[str, float]]               # (host activity, us) longest first


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def parse(events: list) -> Trace:
    win = [e for e in events if e.get("name") == "bench.window" and e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("the trace has no bench.window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    inside = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
              and w0 <= float(e["ts"]) < w1]
    dev = [(e["name"], float(e["ts"]), float(e["dur"])) for e in inside]
    kernels = [d for d, e in zip(dev, inside) if e["cat"] == "kernel"]
    merged = _union([(max(ts, w0), min(ts + dur, w1)) for _, ts, dur in dev])
    busy = sum(b - a for a, b in merged)
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name") in HOST_SPANS]
    gaps = []
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        label = next((name for name, s, t in spans if s <= mid < t), "host other")
        gaps.append((label, b - a))
    gaps.sort(key=lambda g: -g[1])
    return Trace(window_us=w1 - w0, kernels=kernels, device_ops=dev, busy_us=busy, gaps=gaps)


def export_and_parse(prof) -> Trace:
    """Write the profiler's Chrome trace to a temporary file, parse it and
    remove the file."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps by host activity, in seconds, at most ``top`` of each."""
    by_name = defaultdict(float)
    for name, _, dur in tr.device_ops:
        by_name[name[:160]] += dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": [[n, us / 1e6] for n, us in tr.gaps[:top]]}
