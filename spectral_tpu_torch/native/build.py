"""Build the native components with the system C++ toolchain.

The port's counterpart of ``spectral_tpu/native/build.py``. Invoked lazily
on first use (and cached); can also be run directly:
``python -m spectral_tpu_torch.native.build``.

The libraries go to ``build/spectral_tpu_torch/`` at the root of the
checkout, beside the CUDA kernels' (``ops/build.py``), never next to the
sources: each file name carries a hash of its sources and flags, so an
edited source rebuilds, and no name can resolve to the JAX package's
``spectral_tpu/native/libspectpu_png.so``.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys

from spectral_tpu_torch.ops.build import BUILD_DIR

_DIR = os.path.dirname(os.path.abspath(__file__))

CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

TARGETS = {
    "libspectpu_png.so": (["png_encoder.cpp"], ["-lz"]),
}


def lib_path(name: str) -> str:
    """Where target ``name`` is built: its stem, then a digest of its
    sources, flags and libraries."""
    srcs, libs = TARGETS[name]
    h = hashlib.sha256(" ".join(CXX_FLAGS + tuple(libs)).encode())
    for s in srcs:
        with open(os.path.join(_DIR, s), "rb") as fh:
            h.update(fh.read())
    stem = os.path.splitext(name)[0]
    return os.path.join(str(BUILD_DIR), f"{stem}_{h.hexdigest()[:16]}.so")


def build(name: str, verbose: bool = False) -> bool:
    """Compile one target. Returns True when its shared library exists."""
    srcs, libs = TARGETS[name]
    out = lib_path(name)
    if os.path.exists(out):
        return True
    os.makedirs(os.path.dirname(out), exist_ok=True)
    # compile to a unique temp path and os.rename into place: concurrent
    # lazy builds (several encode workers' first encodes at once) would
    # otherwise interleave g++ writes to one -o file, and the corrupt
    # library would pass the existence check forever after
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = (["g++", *CXX_FLAGS, "-o", tmp]
           + [os.path.join(_DIR, s) for s in srcs] + libs)

    def _cleanup():
        try:
            os.remove(tmp)
        except OSError:
            pass

    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        if verbose:
            sys.stderr.write(f"{cmd[0]}: {e}\n")
        _cleanup()
        return False
    if res.returncode != 0:
        if verbose:
            sys.stderr.write(res.stderr)
        _cleanup()
        return False
    try:
        os.rename(tmp, out)          # atomic within the directory
    except OSError:
        _cleanup()
        return os.path.exists(out)   # a concurrent build won the race
    return True


def build_all(verbose: bool = False) -> bool:
    return all(build(name, verbose) for name in TARGETS)


if __name__ == "__main__":
    ok = build_all(verbose=True)
    print("native build:", "ok" if ok else "FAILED")
    sys.exit(0 if ok else 1)
