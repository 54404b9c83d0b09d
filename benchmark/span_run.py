"""Run one cell as ``run.py --trace 1`` does, and split its profiled window
by the program's own spans (``benchmark/spans.py``).

    python3 benchmark/span_run.py --workload <name> --seed <n> --seconds <s>

The run is the harness's own (``harness.run_cell`` with the trace on);
the profiler's Chrome trace events that ``devtrace.parse`` reads are
parsed a second time by ``spans.parse`` on the way.  Standard error gets
the run's lines, then ``[trace] idle by span`` (each device idle gap's ms
per profiled step by the span the stepping thread was in) and ``[spans]``
lines: the six per-layer quantities of ``spans.metrics``, the mean
``train.step`` against the harness's mean ``bench.step``, the shares of
the step's kernel time by attribution rule, and the device ms per step by
span.  The last line of standard output is the run's result line with a
``spans`` object added.  Without a CUDA card it exits 2; if JAX or the
JAX package got loaded, 3.
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# run as a script, the folder would shadow modules of the same names
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path.pop(0)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import devtrace, manifest, spans  # noqa: E402
from benchmark.run import _T_START, card_line  # noqa: E402


@contextlib.contextmanager
def keeping_spans(store: list):
    """While inside, every trace ``devtrace.parse`` reads is also parsed
    by ``spans.parse`` into ``store``."""
    parse = devtrace.parse

    def both(events):
        store.append(spans.parse(events))
        return parse(events)

    devtrace.parse = both
    try:
        yield
    finally:
        devtrace.parse = parse


def span_summary(st: spans.SpanTrace) -> dict:
    """What the ``spans`` object of the result line holds."""
    at = spans.attribute(st)

    def mean_ms(name):
        d = [s.end - s.start for s in st.spans if s.name == name and st.w0 <= s.start < st.w1]
        return sum(d) / len(d) / 1e3 if d else None

    n = max(at.n_steps, 1)
    return {
        "metrics": spans.metrics(at),
        "train_step_ms": mean_ms(spans.STEP),
        "bench_step_ms": mean_ms("bench.step"),
        "traced_step_ms": (st.w1 - st.w0) / n / 1e3,
        "program_spans": sum(1 for s in st.spans if not s.name.startswith("bench.")),
        "shares": spans.shares(at),
        "device_ms_by_span": [[k, us / 1e3] for k, us in spans.device_us_by_span(at)],
        "runtime_ms_by_call": [[c, sp, us / 1e3] for c, sp, us in spans.runtime_us_by_call(at)],
        "idle_ms_by_span": {k: us / n / 1e3 for k, us in spans.idle_by_span(at).items()},
        "idle_line": spans.idle_line(at),
    }


def traced(workload: str, seed: int, seconds: float, device: str = "cuda",
           t_start=None, root=manifest.ROOT, base=manifest.HERE) -> dict:
    """The result of ``harness.run_cell`` with the trace on, plus ``spans``."""
    from benchmark import harness

    store: list = []
    with keeping_spans(store):
        result = harness.run_cell(workload, seed, seconds, True, device=device,
                                  t_start=t_start, root=root, base=base)
    checks = result.pop("checks")
    result["spans"] = span_summary(store[-1])
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    import argparse

    import torch

    from benchmark import harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    cell = manifest.Cell(args.workload, manifest.load_manifest())
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.say(f"needs {cell.chips} CUDA card(s)")
        return 2
    harness.say(f"[card] {card_line()}; torch {torch.__version__} cuda {torch.version.cuda}")
    result = traced(args.workload, args.seed, args.seconds, t_start=_T_START)
    bad = harness.forbidden_modules()
    if bad:
        harness.say(f"loaded modules that the benchmark may not load: {bad}")
        return 3
    sp = result["spans"]
    harness.say(sp["idle_line"])
    harness.say(f"[spans] per profiled step: {json.dumps(sp['metrics'])}")
    harness.say(f"[spans] train.step {sp['train_step_ms']} ms, bench.step {sp['bench_step_ms']} "
                f"ms, traced step {sp['traced_step_ms']:.3f} ms, {sp['program_spans']} program "
                f"spans; step kernel shares {json.dumps(sp['shares'])}")
    harness.say("[spans] device ms per step by span: " + ", ".join(
        f"{k} {ms:.3f}" for k, ms in sp["device_ms_by_span"]))
    harness.say("[spans] runtime ms per step under train.step by call and span: " + ", ".join(
        f"{c} in {span} {ms:.3f}" for c, span, ms in sp["runtime_ms_by_call"]))
    for name, c in result["checks"].items():
        harness.say(f"check {name} = {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
