"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` compiles on first use, with ``nvcc`` for Hopper
(``sm_90a``), into a shared library with a plain C interface under
``csrc/build/``; the library is loaded with ``ctypes``. A file that
includes no PyTorch header builds in seconds, where
``torch.utils.cpp_extension.load`` takes minutes. The library's name
carries a hash of the compiler's flags, its source and the headers the
sources share (``csrc/*.cuh``), so an edited source never loads a stale
build.

Nothing here runs at import time. A missing ``nvcc`` or a failed build
raises: no caller falls back to a plain version on a build failure.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
#: ``--split-compile=0`` runs the device compiler's optimizations on every
#: core: ``csrc/paged_attention.cu`` holds some 70 kernels (PERF.md §6)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each build this
#: process ran, by kernel source name
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels build only where the CUDA "
        "toolkit is installed"
    )


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _nvcc_command(name: str, out: Path) -> List[str]:
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that has no current build, one
    ``nvcc`` process per source, all started together. Returns each
    library's path; raises with the compiler's output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            _nvcc_command(n, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, paths[n])  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def kernel_sources() -> List[str]:
    """Every kernel source of the package, by name."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load_library(name: str, *, declare: Optional[callable] = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed. ``declare(lib)`` sets the functions' ``argtypes`` and
    ``restype`` once, when the library is first loaded."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            if declare is not None:
                declare(lib)
            _libs[name] = lib
        return lib
