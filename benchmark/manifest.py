"""Find a cell's files by the names ``BENCHMARK.json`` gives them.

- a configuration: ``configs/<config>.json``;
- a traffic mix: ``traffic/<traffic>.json``;
- a per-layer metric's reader: ``metrics/<metric>.py`` (``read(ctx)``);
- a configuration's FLOP counter: ``counters/<config>.py``;
- a configuration's plain reference: ``reference/<config>.py``.

Modules whose names hold a ``-`` are loaded from their path.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

_MODULES: Dict[Path, ModuleType] = {}


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """The module in ``path``, loaded once per process."""
    path = path.resolve()
    mod = _MODULES.get(path)
    if mod is None:
        if not path.is_file():
            raise FileNotFoundError(f"no file {path}")
        name = "benchmark._by_name." + "_".join(path.relative_to(HERE).with_suffix("").parts)
        spec = importlib.util.spec_from_file_location(name.replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return mod


def config_path(name: str, base: Path = HERE) -> Path:
    return base / "configs" / f"{name}.json"


def traffic_path(name: str, base: Path = HERE) -> Path:
    return base / "traffic" / f"{name}.json"


def metric_reader(name: str) -> ModuleType:
    return load_module(HERE / "metrics" / f"{name}.py")


def counter(config: str) -> ModuleType:
    return load_module(HERE / "counters" / f"{config}.py")


def reference(config: str) -> ModuleType:
    return load_module(HERE / "reference" / f"{config}.py")


class Cell:
    """One entry of ``workloads`` with its configuration, traffic mix and
    the metrics ``BENCHMARK.json`` asks of it; ``base`` holds ``configs/``
    and ``traffic/`` (this folder, or a test's)."""

    def __init__(self, workload: str, manifest: dict, base: Path = HERE):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.entry = cells[workload]
        self.name = workload
        self.chips = int(self.entry["chips"])
        self.config = read_json(config_path(self.entry["config"], base))
        self.traffic = read_json(traffic_path(self.entry["traffic"], base))
        self.end_to_end = [m for m in manifest["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in manifest["per_layer"] if self._has(m)]

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]
