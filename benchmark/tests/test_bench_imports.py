"""No module that the benchmark or its reference loads is JAX or the JAX
package: a fresh interpreter runs a tiny cell and the control's readings,
then lists the top-level names of every loaded module, compared whole."""

from __future__ import annotations

import json
import subprocess
import sys
import types

from benchmark import harness, manifest

SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from pathlib import Path
from benchmark import control, harness, manifest
for name in ("counters", "reference"):
    for c in manifest.load_manifest()["configs"]:
        getattr(manifest, name[:-1] if name == "counters" else name)(c["name"])
tiny = Path({tiny!r})
harness.run_cell({cell!r}, 3, 0.2, True, device="cpu", root=tiny, base=tiny)
control.readings({cell!r}, 3, "control", device="cpu", root=tiny, base=tiny)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_nothing_loaded_is_jax_or_the_jax_package(tiny_dir):
    for cell in [w["name"] for w in manifest.load_manifest()["workloads"]]:
        code = SCRIPT.format(root=str(manifest.ROOT), tiny=str(tiny_dir), cell=cell)
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             cwd=manifest.ROOT, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
        assert "fastegnn_tpu_torch" in loaded and "benchmark" in loaded
        assert not loaded & set(harness.FORBIDDEN), loaded & set(harness.FORBIDDEN)


def test_the_check_compares_whole_names():
    fake = {"fastegnn_tpu_torch.models": types.ModuleType("x"),
            "fastegnn_tpu.ops": types.ModuleType("y")}
    sys.modules.update(fake)
    try:
        assert harness.forbidden_modules() == ["fastegnn_tpu"]
    finally:
        for k in fake:
            sys.modules.pop(k)
