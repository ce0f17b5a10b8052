"""ctypes binding for the native PNG encoder (png_encoder.cpp)."""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from spectral_tpu_torch.native import build as _build

_lib = None
_load_attempted = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    if not _build.build("libspectpu_png.so"):
        return None
    try:
        lib = ctypes.CDLL(_build.lib_path("libspectpu_png.so"))
        lib.png_encode.restype = ctypes.c_long
        lib.png_encode.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_long]
        lib.png_encode_bound.restype = ctypes.c_long
        lib.png_encode_bound.argtypes = [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int]
        lib.png_encode_pal.restype = ctypes.c_long
        lib.png_encode_pal.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_long]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def encode(arr: np.ndarray, compress_level: int = 6) -> bytes:
    """Encode uint8 (H, W, C) pixels to PNG bytes via the native encoder."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native PNG encoder unavailable")
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w, c = arr.shape
    cap = lib.png_encode_bound(h, w, c)
    out = ctypes.create_string_buffer(cap)
    n = lib.png_encode(arr.ctypes.data_as(ctypes.c_char_p), h, w, c,
                       compress_level, out, cap)
    if n < 0:
        raise RuntimeError(f"native PNG encode failed (code {n})")
    return out.raw[:n]


def encode_palette(indices: np.ndarray, palette: np.ndarray,
                   compress_level: int = 6) -> bytes:
    """Encode uint8 (H, W) palette indices + (N<=256, 3) RGB palette to an
    indexed-color (PLTE) PNG via the native encoder."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native PNG encoder unavailable")
    indices = np.ascontiguousarray(indices, dtype=np.uint8)
    palette = np.ascontiguousarray(palette, dtype=np.uint8)
    if indices.ndim != 2 or palette.ndim != 2 or palette.shape[1] != 3:
        raise ValueError("expected (H, W) indices and (N, 3) palette")
    h, w = indices.shape
    cap = lib.png_encode_bound(h, w, 1) + 3 * palette.shape[0] + 16
    out = ctypes.create_string_buffer(cap)
    n = lib.png_encode_pal(indices.ctypes.data_as(ctypes.c_char_p), h, w,
                           palette.ctypes.data_as(ctypes.c_char_p),
                           palette.shape[0], compress_level, out, cap)
    if n < 0:
        raise RuntimeError(f"native palette PNG encode failed (code {n})")
    return out.raw[:n]
