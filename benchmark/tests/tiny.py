"""Tiny copies of the benchmark's configurations for the CPU tests: the
same models, widths, losses and limits, on a few hundred particles and a
few graphs, in a folder of their own beside a copy of ``BENCHMARK.json``."""

from __future__ import annotations

import json
from pathlib import Path

from benchmark import manifest

SHRINK = {
    "fastegnn-water3d": lambda c: (c["dataset"].update(n_trajectories=2, n_particles=300,
                                                       n_frames=40, frames=[0, 10, 20]),
                                   c.update(train_pool=6, batch_size=2, radius=0.22)),
    "fasttfn-protein": lambda c: (c["dataset"].update(n_atoms=60, n_frames=40),
                                  c.update(train_pool=6, batch_size=2)),
}


def make(tmp: Path, trace_steps: int = 2) -> Path:
    """Write the tiny folder under ``tmp`` and return it."""
    (tmp / "configs").mkdir(parents=True, exist_ok=True)
    (tmp / "traffic").mkdir(exist_ok=True)
    man = manifest.load_manifest()
    for c in man["configs"]:
        cfg = manifest.read_json(manifest.config_path(c["name"]))
        SHRINK[c["name"]](cfg)
        (tmp / "configs" / f"{c['name']}.json").write_text(json.dumps(cfg))
    for w in man["workloads"]:
        tr = manifest.read_json(manifest.traffic_path(w["traffic"]))
        tr["trace_steps"] = trace_steps
        (tmp / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(tr))
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    return tmp
