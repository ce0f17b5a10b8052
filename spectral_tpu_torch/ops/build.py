"""Build and load the port's CUDA C++ kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). The build runs at first use,
from the sources in this checkout only, into ``build/spectral_tpu_torch/``
at the root of the checkout; the library's file name carries a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
loads the existing library. A failed build raises: there is no fallback.
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
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "spectral_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> Optional[str]:
    """nvcc on PATH, else the toolkit's default location, else None."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.access(default, os.X_OK) else None


def library_path(name: str) -> Path:
    """Where the library built from csrc/<name>.cu lives."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build_library(name: str) -> dict:
    """Compile csrc/<name>.cu unless its library exists already.

    Returns {"path", "seconds", "log"}; "log" holds nvcc's -Xptxas -v
    report (registers, shared memory, spills) when a build ran."""
    path = library_path(name)
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "log": ""}
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build the {name} CUDA kernel: nvcc was not found on "
            "PATH or at /usr/local/cuda/bin/nvcc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {name} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return {"path": str(path), "seconds": time.perf_counter() - t0,
            "log": proc.stdout + proc.stderr}


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu's library, once per process."""
    path = build_library(name)["path"]
    lib = _LOADED.get(path)
    if lib is None:
        lib = ctypes.CDLL(path)
        _LOADED[path] = lib
    return lib
