"""The program's own spans in a profiled window, and the device time and
host time they account for.

The port names the parts of its train step, model layers, kernel launch
paths and batcher with ``record_function`` ranges while a profiler runs
(``fastegnn_tpu_torch/utils/profiling.py::span``): ``train.step`` around
a step's body, ``step.draw``, ``step.forward``, ``step.loss``,
``step.backward``, ``step.optimizer`` inside it, the model's
``model.embed``, ``layer.*`` and ``tfn.*`` below ``step.forward``,
``ops.*`` around the port's own kernels' launches, ``batcher.*`` in the
batcher.  From the profiler's Chrome trace this module keeps, beside what
``devtrace`` keeps of the same events: every span (name, thread, start,
end, parent), the CUDA API calls (``cuda_runtime`` and ``cuda_driver``
events: name, thread, start, duration, correlation id), each kernel's
correlation id, and the CPU ops' sequence numbers that link a backward op
to the forward op that made it.

**The attribution rule** (:func:`attribute`).  A kernel belongs to the
runtime call that launched it (same correlation id).  The call belongs to
the innermost span enclosing it on its own thread, if that span opened
inside the backward op the call runs in (or the call runs in none);
otherwise, inside a backward op (on the autograd engine's thread on a
card, on the caller's thread on the CPU), to the innermost span that
enclosed the forward op of the same sequence number on the thread that
called ``step()``; failing that, to the ``step.*`` span open on that
thread at the time.  A span that the autograd engine's thread opens (the
launch path of a kernel in a backward) lies under the span the stepping
thread is in meanwhile (``step.backward``).

The six per-layer quantities (:func:`metrics`), per profiled step:
``batch_wait_ms`` (``batcher.wait`` on the stepping thread),
``step_host_ms`` and ``step_launch_wait_ms`` (the mean ``train.step``
split into the host's own work and the time inside CUDA runtime calls
made under it, on the stepping thread and on the autograd engine's),
``step_launches`` (kernels launched under ``train.step``),
``virtual_block_ms`` and ``radial_mlp_ms`` (device time of the kernels
attributed to ``layer.virtual`` and to ``tfn.radial``, forward and
backward).  A quantity whose spans the trace lacks (a program without
them) is None.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from benchmark.devtrace import DEVICE_CATS, _union

RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
STEP = "train.step"
NO_SPAN = "host other"


@dataclasses.dataclass
class Span:
    name: str
    tid: int
    start: float
    end: float
    parent: int          # index in SpanTrace.spans on its thread, -1 for none


@dataclasses.dataclass
class SpanTrace:
    w0: float                                      # the window, us
    w1: float
    spans: List[Span]                              # every user annotation
    calls: List[Tuple[str, int, float, float, int]]  # (name, thread, start, dur, correlation)
    kernels: List[Tuple[str, float, float, int]]   # (name, start, dur, correlation), in the window
    device_ops: List[Tuple[float, float]]          # kernels, copies, fills in the window
    forward: Dict[int, Dict[int, List[float]]]     # thread -> sequence number -> op starts
    backward: Dict[int, List[Tuple[float, float, int]]]  # thread -> (start, end, sequence number)


class _Timeline:
    """The innermost of a thread's properly nested intervals at any time."""

    def __init__(self, intervals: List[Tuple[float, float, int]]):
        cuts = sorted([(a, 1, -b, k) for a, b, k in intervals]
                      + [(b, 0, -a, k) for a, b, k in intervals])
        self.t: List[float] = []
        self.k: List[int] = []
        stack: List[int] = []
        for t, opening, _, k in cuts:
            if opening:
                stack.append(k)
            elif k in stack:
                stack.remove(k)
            if self.t and self.t[-1] == t:
                self.k[-1] = stack[-1] if stack else -1
            else:
                self.t.append(t)
                self.k.append(stack[-1] if stack else -1)

    def at(self, t: float) -> int:
        i = bisect.bisect_right(self.t, t) - 1
        return self.k[i] if i >= 0 else -1

    def segments(self, lo: float, hi: float):
        """``(start, end, key)`` pieces of ``[lo, hi)``, key -1 where none."""
        i = bisect.bisect_right(self.t, lo) - 1
        while lo < hi:
            end = min(self.t[i + 1], hi) if i + 1 < len(self.t) else hi
            yield lo, end, self.k[i] if i >= 0 else -1
            lo, i = end, i + 1


def parse(events: list) -> SpanTrace:
    win = [e for e in events if e.get("name") == "bench.window" and e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    if win:
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
    else:
        w0 = min(float(e["ts"]) for e in xs)
        w1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in xs)
    raw = sorted(((e["name"], e["tid"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in xs if e.get("cat") == "user_annotation"),
                 key=lambda s: (s[1], s[2], -s[3]))
    spans: List[Span] = []
    open_: Dict[int, List[int]] = defaultdict(list)
    for name, tid, a, b in raw:
        stack = open_[tid]
        while stack and spans[stack[-1]].end <= a:
            stack.pop()
        spans.append(Span(name, tid, a, b, stack[-1] if stack else -1))
        stack.append(len(spans) - 1)
    calls = [(e["name"], e["tid"], float(e["ts"]), float(e["dur"]),
              int(e["args"]["correlation"])) for e in xs
             if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {})]
    kernels = [(e["name"], float(e["ts"]), float(e["dur"]), int(e["args"].get("correlation", -1)))
               for e in xs if e.get("cat") == "kernel" and w0 <= float(e["ts"]) < w1]
    device_ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in xs
                  if e.get("cat") in DEVICE_CATS and w0 <= float(e["ts"]) < w1]
    forward: Dict[int, Dict[int, List[float]]] = defaultdict(lambda: defaultdict(list))
    backward: Dict[int, List[Tuple[float, float, int]]] = defaultdict(list)
    for e in xs:
        args = e.get("args", {})
        if e.get("cat") != "cpu_op" or "Sequence number" not in args:
            continue
        seq, ts = int(args["Sequence number"]), float(e["ts"])
        if args.get("Fwd thread id", 0):
            backward[e["tid"]].append((ts, ts + float(e["dur"]), seq))
        else:
            forward[e["tid"]][seq].append(ts)
    for by_seq in forward.values():
        for starts in by_seq.values():
            starts.sort()
    return SpanTrace(w0=w0, w1=w1, spans=spans, calls=calls, kernels=kernels,
                     device_ops=device_ops, forward=forward, backward=backward)


class _Rule:
    """The attribution rule over one trace's timelines."""

    def __init__(self, tr: SpanTrace, caller: Optional[int]):
        self.tr = tr
        by_tid: Dict[int, List[Tuple[float, float, int]]] = defaultdict(list)
        for k, sp in enumerate(tr.spans):
            by_tid[sp.tid].append((sp.start, sp.end, k))
        self.lines = {tid: _Timeline(iv) for tid, iv in by_tid.items()}
        self.bw_lines = {tid: _Timeline([(a, b, k) for k, (a, b, _) in enumerate(nodes)])
                         for tid, nodes in tr.backward.items()}
        self.caller_line = self.lines.get(caller)
        self.fwd = tr.forward.get(caller, {})

    def _step_part(self, t: float) -> int:
        k = self.caller_line.at(t) if self.caller_line else -1
        while k >= 0 and not self.tr.spans[k].name.startswith("step."):
            k = self.tr.spans[k].parent
        return k

    def place(self, tid: int, t: float) -> Tuple[int, str]:
        """``(span index or -1, rule)`` of a host event on ``tid`` at ``t``."""
        own = self.lines[tid].at(t) if tid in self.lines else -1
        b = self.bw_lines[tid].at(t) if tid in self.bw_lines else -1
        node = self.tr.backward[tid][b] if b >= 0 else None
        if own >= 0 and (node is None or self.tr.spans[own].start >= node[0]):
            return own, "own"
        if node is not None and self.caller_line is not None:
            starts = self.fwd.get(node[2], [])
            j = bisect.bisect_right(starts, node[0]) - 1
            k = self.caller_line.at(starts[j]) if j >= 0 else -1
            if k >= 0:
                return k, "seq"
        k = self._step_part(t)
        return k, "step" if k >= 0 else "none"


@dataclasses.dataclass
class Attribution:
    """What :func:`attribute` finds: per runtime call its span (index into
    ``trace.spans``, -1 for none), the rule that placed it (``own``,
    ``seq``, ``step`` or ``none``) and whether it ran under ``train.step``."""

    trace: SpanTrace
    rule: _Rule
    caller: Optional[int]               # the thread that calls step()
    steps: List[Span]                   # the train.step spans in the window
    n_steps: int                        # those, or else the harness's bench.step spans
    parents: List[int]                  # each span's parent, across threads
    call_span: List[int]
    call_rule: List[str]
    call_in_step: List[bool]
    by_corr: Dict[int, int]             # correlation id -> call index

    def names_above(self, k: int) -> List[str]:
        """The span ``k`` and its ancestors' names, innermost first."""
        out = []
        while k >= 0:
            out.append(self.trace.spans[k].name)
            k = self.parents[k]
        return out

    def host_event(self, tid: int, t: float) -> Optional[str]:
        """The span name the rule gives a host event (a CPU op, say) on
        ``tid`` at ``t``, as it would a runtime call there."""
        k, _ = self.rule.place(tid, t)
        return self.trace.spans[k].name if k >= 0 else None


def attribute(tr: SpanTrace) -> Attribution:
    in_window = [sp for sp in tr.spans if tr.w0 <= sp.start < tr.w1]
    steps = [sp for sp in in_window if sp.name == STEP]
    # a program without spans: the harness's steps and thread
    counted = steps or [sp for sp in in_window if sp.name == "bench.step"]
    caller = counted[0].tid if counted else None
    rule = _Rule(tr, caller)
    step_threads = ({caller} | set(tr.backward)) if caller is not None else set()
    # a span the autograd engine's thread opens (a launch path in a
    # backward) lies under the span the stepping thread is in meanwhile
    parents = []
    for sp in tr.spans:
        linked = sp.parent < 0 and sp.tid != caller and sp.tid in tr.backward
        parents.append(rule.caller_line.at(sp.start) if linked and rule.caller_line
                       else sp.parent)
    step_iv = sorted((sp.start, sp.end) for sp in steps)
    step_starts = [a for a, _ in step_iv]
    spans_of, rules, in_step, by_corr = [], [], [], {}
    for i, (_, tid, t, _, corr) in enumerate(tr.calls):
        by_corr[corr] = i
        k, how = rule.place(tid, t)
        j = bisect.bisect_right(step_starts, t) - 1
        spans_of.append(k)
        rules.append(how)
        in_step.append(tid in step_threads and j >= 0 and t < step_iv[j][1])
    return Attribution(trace=tr, rule=rule, caller=caller, steps=steps, n_steps=len(counted),
                       parents=parents, call_span=spans_of, call_rule=rules,
                       call_in_step=in_step, by_corr=by_corr)


def _step_kernels(at: Attribution):
    """``(name, dur, call index)`` of the window's kernels launched under
    ``train.step``."""
    out = []
    for name, _, dur, corr in at.trace.kernels:
        i = at.by_corr.get(corr)
        if i is not None and at.call_in_step[i]:
            out.append((name, dur, i))
    return out


def subtree_us(at: Attribution, name: str) -> Optional[float]:
    """Device us of the kernels attributed to a ``name`` span or to a span
    inside one; None when the trace has no such span."""
    if not any(s.name == name for s in at.trace.spans):
        return None
    total = 0.0
    for _, _, dur, corr in at.trace.kernels:
        i = at.by_corr.get(corr)
        if i is not None and at.call_span[i] >= 0 and name in at.names_above(at.call_span[i]):
            total += dur
    return total


def launch_wait_us(at: Attribution) -> float:
    """Host us inside runtime calls under ``train.step`` (the union of the
    calls' intervals per thread, so a ``cu*`` call inside a ``cuda*``
    call counts once)."""
    per_tid = defaultdict(list)
    for i, (_, tid, t, dur, _) in enumerate(at.trace.calls):
        if at.call_in_step[i]:
            per_tid[tid].append((t, t + dur))
    return sum(b - a for iv in per_tid.values() for a, b in _union(iv))


def runtime_us_by_call(at: Attribution, top: int = 16) -> List[Tuple[str, str, float]]:
    """Host us per step in the runtime calls under ``train.step``, by the
    call's name and the span the rule gives it, largest first."""
    by = defaultdict(float)
    for i, (name, _, _, dur, _) in enumerate(at.trace.calls):
        if at.call_in_step[i]:
            k = at.call_span[i]
            by[name, at.trace.spans[k].name if k >= 0 else NO_SPAN] += dur
    n = max(at.n_steps, 1)
    return sorted(((c, sp, us / n) for (c, sp), us in by.items()), key=lambda r: -r[2])[:top]


def metrics(at: Attribution) -> Dict[str, Optional[float]]:
    """The six per-layer quantities, per profiled step (None where the
    trace lacks their spans)."""
    n = len(at.steps)
    out: Dict[str, Optional[float]] = dict.fromkeys(
        ("batch_wait_ms", "step_host_ms", "step_launch_wait_ms", "step_launches",
         "virtual_block_ms", "radial_mlp_ms"))
    if not n:
        return out
    tr = at.trace
    waits = [s.end - s.start for s in tr.spans
             if s.name == "batcher.wait" and s.tid == at.caller and tr.w0 <= s.start < tr.w1]
    if waits:
        out["batch_wait_ms"] = sum(waits) / n / 1e3
    step_ms = sum(s.end - s.start for s in at.steps) / n / 1e3
    out["step_launch_wait_ms"] = launch_wait_us(at) / n / 1e3
    out["step_host_ms"] = step_ms - out["step_launch_wait_ms"]
    out["step_launches"] = len(_step_kernels(at)) / n
    for key, name in (("virtual_block_ms", "layer.virtual"), ("radial_mlp_ms", "tfn.radial")):
        us = subtree_us(at, name)
        out[key] = None if us is None else us / n / 1e3
    return out


def shares(at: Attribution) -> Dict[str, float]:
    """Of the device time of the kernels launched under ``train.step``: the
    share each rule placed, the share attributed to a span below
    ``train.step``, and the share attributed inside a span below the
    ``step.*`` parts (the model's layers, the launch paths, Adam's own)."""
    ks = _step_kernels(at)
    total = sum(d for _, d, _ in ks)
    out = {"kernel_ms_per_step": total / max(at.n_steps, 1) / 1e3}
    if not total:
        return out
    for rule in ("own", "seq", "step", "none"):
        out[f"by_{rule}"] = sum(d for _, d, i in ks if at.call_rule[i] == rule) / total
    below = inside = 0.0
    for _, d, i in ks:
        names = at.names_above(at.call_span[i]) if at.call_span[i] >= 0 else []
        if STEP in names[1:]:
            below += d
            if not names[0].startswith("step.") and names[0] != STEP:
                inside += d
    out["below_train_step"] = below / total
    out["inside_step_parts"] = inside / total
    return out


def device_us_by_span(at: Attribution, top: int = 24) -> List[Tuple[str, float]]:
    """Device us per step of the kernels by the span they are attributed
    to (innermost), largest first."""
    by = defaultdict(float)
    for _, _, dur, corr in at.trace.kernels:
        i = at.by_corr.get(corr)
        k = at.call_span[i] if i is not None else -1
        by[at.trace.spans[k].name if k >= 0 else NO_SPAN] += dur
    n = max(at.n_steps, 1)
    return sorted(((name, us / n) for name, us in by.items()), key=lambda kv: -kv[1])[:top]


def idle_by_span(at: Attribution) -> Dict[str, float]:
    """Each device idle gap of the window split by the innermost span the
    stepping thread was in at the time, us summed by span name."""
    tr = at.trace
    busy = _union([(max(a, tr.w0), min(b, tr.w1)) for a, b in tr.device_ops])
    edges = [tr.w0] + [x for ab in busy for x in ab] + [tr.w1]
    line = _Timeline([(s.start, s.end, k) for k, s in enumerate(tr.spans) if s.tid == at.caller])
    out: Dict[str, float] = defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        for lo, hi, k in line.segments(a, b):
            out[tr.spans[k].name if k >= 0 else NO_SPAN] += hi - lo
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def idle_line(at: Attribution) -> str:
    """The ``[trace] idle by span`` line: idle ms per profiled step by span."""
    n = max(at.n_steps, 1)
    parts = ", ".join(f"{name} {us / n / 1e3:.3f}" for name, us in idle_by_span(at).items())
    return f"[trace] idle by span (ms per profiled step, {at.n_steps} steps): {parts}"
