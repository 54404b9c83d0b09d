"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the plain
reference beside its limit, which are also the last lines of standard
error.  Without a CUDA card, or with fewer cards than the cell asks for,
it exits 2 and prints no result; if JAX or the JAX package got loaded, it
exits 3 and prints no result.
"""

from __future__ import annotations

import os
import time

_T_START = time.perf_counter()


def _process_age_s() -> float:
    """Seconds since this process started (``/proc``), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_T_START -= _process_age_s()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# run as a script, the folder would shadow modules of the same names
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path.pop(0)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from benchmark import harness, manifest

    cell = manifest.Cell(args.workload, manifest.load_manifest())
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.say(f"needs {cell.chips} CUDA card(s); have "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    harness.say(f"[card] {card_line()}; torch {torch.__version__} cuda {torch.version.cuda}")
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=_T_START)
    bad = harness.forbidden_modules()
    if bad:
        harness.say(f"loaded modules that the benchmark may not load: {bad}")
        return 3
    for name, c in result["checks"].items():
        harness.say(f"check {name} = {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
