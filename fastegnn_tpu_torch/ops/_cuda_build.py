"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``_build/<name>-<hash of the source>.so`` (``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``).  The build
runs on first use, from the sources in the checkout; a library whose source
hash matches is reused.  All missing libraries compile in parallel, one
``nvcc`` per source.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

PKG_ROOT = Path(__file__).resolve().parent.parent
CSRC = PKG_ROOT / "csrc"
BUILD_DIR = PKG_ROOT / "_build"
SOURCES = ("edge_block", "segment_sum")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "cannot be built")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every library in ``names`` that is missing, all in parallel.

    Returns ``{name: ptxas report}`` for the sources compiled by this call
    (register and shared-memory use per kernel).  Raises with nvcc's output
    when a build fails.
    """
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{text}")
            continue
        os.replace(tmp, out)
        reports[name] = text
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def resource_lines(report: str) -> List[str]:
    """The register, shared-memory and spill lines of a ptxas report, each
    prefixed with the kernel it describes."""
    kernel, lines = "?", []
    for line in report.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)", line)
        if m:
            kernel = _unmangled(m.group(1))
        elif "registers" in line or "spill" in line:
            lines.append(f"{kernel}: {line.replace('ptxas info    : ', '').strip()}")
    return lines


def _unmangled(name: str) -> str:
    """The function's own name in an Itanium-mangled ``_Z[N]<len><id>...``."""
    pos = 3 if name.startswith("_ZN") else 2
    last = name
    while pos < len(name) and name[pos].isdigit():
        digits = re.match(r"\d+", name[pos:]).group(0)
        pos += len(digits)
        last = name[pos:pos + int(digits)]
        pos += int(digits)
    return last


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if it is missing."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
