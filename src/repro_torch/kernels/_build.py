"""Build the port's CUDA sources into shared libraries and load them.

Each kernel's ``csrc/*.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``build/repro_torch/`` at the repository root, named by a
hash of its sources and flags, so a changed source builds anew and an
unchanged one loads the library already there.  Nothing builds at import:
the first launch builds, or ``build_all``, which runs one ``nvcc`` for each
library, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Mapping, Sequence

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under the CUDA toolkit that
    ``torch.utils.cpp_extension`` finds.  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels build with the CUDA toolkit "
        "(put nvcc on PATH or set CUDA_HOME)")


def library_path(name: str, sources: Sequence[Path]) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(Path(src).read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(libraries: Mapping[str, Sequence[Path]]) -> Dict[str, float]:
    """Build every library of ``libraries`` (name -> sources) that is not
    built yet, with one ``nvcc`` each, all started together.  Returns each
    library's build seconds (0.0 for one already built).  A failed build
    raises with the compiler's output, after every build has ended."""
    seconds = {name: 0.0 for name in libraries}
    missing = {name: (sources, library_path(name, sources))
               for name, sources in libraries.items()
               if not library_path(name, sources).is_file()}
    if not missing:
        return seconds
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name, (sources, out) in missing.items():
        # build under a private name and rename: a concurrent build never
        # loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [compiler, *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, cmd, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, cmd, tmp, out, t0) in started.items():
        try:
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            if proc.returncode == 0:
                os.replace(tmp, out)
            else:
                failures.append(f"nvcc failed building {name} (exit "
                                f"{proc.returncode}):\n{' '.join(cmd)}\n{log}")
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load_library(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """Build ``sources`` into ``lib<name>`` unless that exact build exists,
    then load it.  A failed build raises with the compiler's output."""
    build_all({name: sources})
    return ctypes.CDLL(str(library_path(name, sources)))
