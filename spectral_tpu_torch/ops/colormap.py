"""Colormap application to packed RGBA words, in PyTorch.

Counterpart of ``spectral_tpu/ops/colormap.py``. A normalized [0, 1] image
maps to the 256-entry LUT of ``spectral_tpu.render.lut`` (matplotlib's
index rule, idx = clip(floor(x * 256), 0, 255), PlotEngine.py:134) and each
pixel becomes one little-endian word R | G<<8 | B<<16 | A<<24.

The JAX package evaluates the channels as piecewise-linear hinge arithmetic
because a TPU has no gather; on a GPU the 256-entry table lookup is the
natural form, and it is byte-exact by construction.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from spectral_tpu.render.lut import get_lut

N_LEVELS = 256


@functools.lru_cache(maxsize=None)
def _packed_lut_np(name: str, opaque: bool) -> np.ndarray:
    lut8 = get_lut(name).astype(np.uint32)
    a = np.uint32(255 << 24) if opaque else np.uint32(0)
    words = lut8[:, 0] | (lut8[:, 1] << 8) | (lut8[:, 2] << 16) | a
    return words.view(np.int32)


_LUT_CACHE: dict = {}


def packed_lut(name: str = "jet", device="cpu",
               opaque: bool = True) -> torch.Tensor:
    """(256,) int32 tensor of packed RGBA words (bit patterns of the uint32
    words), cached per (name, opaque, device)."""
    key = (name, opaque, str(torch.device(device)))
    lut = _LUT_CACHE.get(key)
    if lut is None:
        lut = torch.tensor(_packed_lut_np(name, opaque), device=device)
        _LUT_CACHE[key] = lut
    return lut


def apply_colormap_packed(img: torch.Tensor, name: str = "jet",
                          flip_rows: bool = False,
                          opaque: bool = True) -> torch.Tensor:
    """Colormap to packed little-endian RGBA words: (..., H, W) -> uint32.

    flip_rows=True flips the row axis so row 0 is the highest frequency
    (the PNG row order)."""
    idx = torch.clamp((img * N_LEVELS).to(torch.int32), 0, N_LEVELS - 1)
    out = packed_lut(name, img.device, opaque)[idx]
    if flip_rows:
        out = out.flip(-2)
    return out.view(torch.uint32)


def unpack_rgba(packed) -> np.ndarray:
    """uint32 (..., H, W) -> uint8 (..., H, W, 4) (little-endian view)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(packed, dtype="<u4"))
    return arr.view(np.uint8).reshape(arr.shape + (4,))
