"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name."""

from __future__ import annotations

import re

import pytest

from benchmark import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MAN = manifest.load_manifest()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= len(MAN["paths"]) <= 16 and all(PATH.match(p) for p in MAN["paths"])
    assert all(_line(w) and not w.startswith("/") and ".." not in w for w in MAN["command"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics_have_units_sources_and_bounds():
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in MAN["end_to_end"]}
    e2e = {m["name"] for m in MAN["end_to_end"]}
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace", "program_span", "program_counter")
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_has_its_files_and_metrics():
    configs = {c["name"]: c for c in MAN["configs"]}
    used = set()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
        cell = manifest.Cell(w["name"], MAN)
        assert cell.config["name"] == w["config"]
        assert manifest.counter(w["config"]).step_flops
        assert manifest.reference(w["config"]).forward
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert manifest.metric_reader(m["name"]).read
        used.add(w["config"])
        assert w["config"] in configs
    assert used == set(configs)
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(MAN["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_configuration_files():
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (manifest.ROOT / c["file"]).is_file()
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        cfg = manifest.read_json(manifest.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
        # no width is cut
        for k in c["reduced"]:
            assert not (k.endswith("_dim") or k.endswith("_rank") or k == "hidden")
        assert cfg["hidden"] == 64 and cfg["virtual_channels"] == 3 and cfg["n_layers"] == 4
