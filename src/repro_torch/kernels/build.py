"""Build a CUDA source under ``csrc/`` into a shared library and load it.

Route: ``nvcc`` by hand into a library with a plain C interface, bound with
``ctypes`` (no PyTorch headers, so a build takes seconds). Libraries go into
``build/kernels/`` at the repository root (listed in ``.gitignore``), named
by a hash of the source, the ``csrc/*.cuh`` headers and the flags, so an
edited source or header rebuilds and an unchanged one loads from the
earlier build. Nothing is built at import time:
the first wrapper call that needs a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# source name -> what the last build of it in this process reported
BUILD_LOG: Dict[str, dict] = {}
_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and under $CUDA_HOME/bin): the "
            "CUDA kernels of repro_torch build only where the CUDA toolkit is "
            "installed")
    return found


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``; cached per process."""
    if source in _LOADED:
        return _LOADED[source]
    src = CSRC / source
    # the headers under csrc/ count too: an edited header must not load a
    # library built from the old one
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    digest = h.hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if lib_path.exists():
        BUILD_LOG[source] = {"seconds": 0.0, "cached": True, "ptxas": "",
                             "path": str(lib_path)}
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} ({' '.join(cmd)}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)   # atomic: a concurrent loader sees all or nothing
        ptxas = "\n".join(line for line in (proc.stdout + proc.stderr).splitlines()
                          if "ptxas" in line or "spill" in line)
        BUILD_LOG[source] = {"seconds": seconds, "cached": False,
                             "ptxas": ptxas, "path": str(lib_path)}
    lib = ctypes.CDLL(str(lib_path))
    _LOADED[source] = lib
    return lib
