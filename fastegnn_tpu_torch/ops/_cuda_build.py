"""Build the port's native sources and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``_build/<name>-<hash of the source>.so`` (``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``).  The host
library ``native/graphcore.cpp`` builds the same way with ``g++ -O3 -shared
-fPIC -std=c++17`` into ``_build/graphcore-<hash>.so``.  The build runs on
first use, from the sources in the checkout; a library whose source hash
matches is reused.  All missing libraries compile in parallel, one compiler
per source, each into a temporary name moved into place, so that processes
building at once do not clash.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

PKG_ROOT = Path(__file__).resolve().parent.parent
CSRC = PKG_ROOT / "csrc"
BUILD_DIR = PKG_ROOT / "_build"
SOURCES = ("edge_block", "segment_sum")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
HOST_SOURCES = {"graphcore": PKG_ROOT / "native" / "graphcore.cpp"}
GXX = "g++"

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "cannot be built")
    return found


def gxx_path() -> str:
    found = shutil.which(GXX)
    if found is None:
        raise RuntimeError(f"{GXX} not found; the host library cannot be built")
    return found


def source_path(name: str) -> Path:
    return HOST_SOURCES.get(name, CSRC / f"{name}.cu")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source_path(name).read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _command(name: str, out: Path) -> List[str]:
    src = source_path(name)
    if src.suffix == ".cu":
        return [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out), str(src)]
    return [gxx_path(), "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(out), str(src)]


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every library in ``names`` that is missing, all in parallel.

    Returns ``{name: compiler report}`` for the sources compiled by this
    call (for a CUDA source, ptxas's register and shared-memory use per
    kernel).  Raises with the compiler's output when a build fails.
    """
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {source_path(name).name} (exit {proc.returncode})\n{text}")
            continue
        os.replace(tmp, out)
        reports[name] = text
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
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
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib
