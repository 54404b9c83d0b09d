"""The control on the card: the reference computed with TF32 on, in the
program's place, comes out not correct at a size a test run holds (TF32
exists only on the card, so this runs there:
``python -m pytest -p no:cacheprovider -m cuda benchmark/tests``)."""

from __future__ import annotations

import pytest

from benchmark import control, manifest

pytestmark = pytest.mark.cuda

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [101, 202, 303])
def test_control_is_not_correct(tiny_dir, cuda, cell, seed):
    limits = manifest.Cell(cell, manifest.load_manifest(tiny_dir), tiny_dir).config["limits"]
    prog = control.readings(cell, seed, "program", device="cuda", root=tiny_dir, base=tiny_dir)
    assert all(prog[k] <= limits[k] for k in limits), prog
    ctl = control.readings(cell, seed, "control", device="cuda", root=tiny_dir, base=tiny_dir)
    assert any(ctl[k] > limits[k] for k in limits), ctl
