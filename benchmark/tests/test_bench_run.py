"""Whole runs of the cells at a tiny size on the CPU (the harness's look
for a card skipped): the result line's keys, a sound run correct, and
each fault the cells can have planted underneath coming out not correct."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import control, harness, manifest

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


def _run(tiny_dir, cell, seed=2**31 + 11, trace=False):
    return harness.run_cell(cell, seed, 0.3, trace, device="cpu", root=tiny_dir, base=tiny_dir)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_with_the_result_keys(tiny_dir, cell):
    r = _run(tiny_dir, cell)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    want = {m["name"] for m in manifest.Cell(cell, manifest.load_manifest()).end_to_end}
    assert set(r["metrics"]) == want
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    json.dumps(r)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_keys(tiny_dir, cell):
    r = _run(tiny_dir, cell, trace=True)
    assert list(r)[-1] == "checks" and "breakdown" in r
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    per_layer = {m["name"] for m in manifest.Cell(cell, manifest.load_manifest()).per_layer}
    assert set(r["metrics"]) <= per_layer and "dispatch_ms" in r["metrics"]


@pytest.mark.parametrize("fault", control.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_underneath_is_not_correct(tiny_dir, cell, fault):
    with control.fault(fault):
        r = _run(tiny_dir, cell)
    assert not r["correct"], r["checks"]


def test_run_without_a_card_exits_2_and_prints_no_result():
    out = subprocess.run([sys.executable, str(manifest.HERE / "run.py"), "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=manifest.ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 2 and out.stdout == ""
