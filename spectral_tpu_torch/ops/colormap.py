"""Colormap application to packed words, in PyTorch.

Counterpart of ``spectral_tpu/ops/colormap.py``. A normalized [0, 1] image
maps to the 256-entry LUT of ``spectral_tpu_torch.render.lut`` (matplotlib's
index rule, idx = clip(floor(x * 256), 0, 255), PlotEngine.py:134). Two
packed forms leave the card: one little-endian RGBA word per pixel
(R | G<<8 | B<<16 | A<<24), or four LUT indices per word for palette PNGs;
uint8 RGB(A) arrays come from :func:`apply_colormap` and
:func:`apply_colormap_rgba`.

The JAX package evaluates the channels as piecewise-linear hinge arithmetic
because a TPU has no gather; on a GPU the 256-entry table lookup is the
natural form, and it is byte-exact by construction.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from spectral_tpu_torch.render.lut import get_lut

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
    out = packed_lut(name, img.device, opaque)[lut_index(img)]
    if flip_rows:
        out = out.flip(-2)
    return out.view(torch.uint32)


def lut_index(img: torch.Tensor, n: int = N_LEVELS) -> torch.Tensor:
    """int32 index of each pixel into an n-entry LUT, clip(floor(x * n), 0,
    n - 1); a NaN pixel takes index 0, as the display kernel and jnp give
    it."""
    level = torch.nan_to_num(img, nan=0.0) * n
    return torch.clamp(level.to(torch.int32), 0, n - 1)


def apply_colormap(img: torch.Tensor, lut: Optional[np.ndarray] = None,
                   name: str = "jet", flip_rows: bool = False
                   ) -> torch.Tensor:
    """Map a normalized image (..., H, W) in [0, 1] to uint8 RGB (..., H,
    W, 3) on img's device, through ``lut`` (an (N, 3) uint8 table) or the
    named colormap's 256 entries.

    flip_rows=True flips the frequency axis so row 0 is the highest
    frequency (the PNG row order)."""
    if lut is None:
        lut = get_lut(name)
    table = torch.tensor(np.asarray(lut), device=img.device)
    rgb = table[lut_index(img, table.shape[0])]
    return rgb.flip(-3) if flip_rows else rgb


def apply_colormap_rgba(img: torch.Tensor, alpha=None, name: str = "jet",
                        flip_rows: bool = False) -> torch.Tensor:
    """:func:`apply_colormap` with an alpha channel: uint8 (..., H, W, 4),
    opaque unless ``alpha`` (in [0, 1], shaped like img or like img with a
    trailing channel axis) is given. The channel axis is added before the
    row flip, so a 2-D mask flips with the image."""
    rgb = apply_colormap(img, name=name, flip_rows=flip_rows)
    if alpha is None:
        a = torch.full(rgb.shape[:-1] + (1,), 255, dtype=torch.uint8,
                       device=rgb.device)
    else:
        a = torch.clamp(torch.as_tensor(alpha, device=rgb.device) * 255.0,
                        0, 255).to(torch.uint8)
        if a.ndim == rgb.ndim - 1:
            a = a[..., None]
        if flip_rows:
            a = a.flip(-3)
    return torch.cat([rgb, a], dim=-1)


def colormap_index_packed(img: torch.Tensor,
                          flip_rows: bool = False) -> torch.Tensor:
    """LUT indices packed four to a little-endian word: (..., H, W) ->
    uint32 (..., H, ceil(W / 4)), the width zero-padded to a multiple of
    4. Pairs with indexed-color (PLTE) PNGs: one byte per pixel leaves the
    card instead of four, at the same colors. :func:`unpack_indices`
    restores (..., H, W) uint8 on the host."""
    idx = lut_index(img)
    if flip_rows:
        idx = idx.flip(-2)
    pad = (-idx.shape[-1]) % 4
    if pad:
        idx = torch.nn.functional.pad(idx, (0, pad))
    q = idx.reshape(idx.shape[:-1] + (idx.shape[-1] // 4, 4))
    words = (q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)
             | (q[..., 3] << 24))
    return words.view(torch.uint32)


def _host_words(packed) -> np.ndarray:
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().view(torch.int32).numpy().view(np.uint32)
    return np.ascontiguousarray(np.asarray(packed, dtype="<u4"))


def unpack_indices(packed, width: int) -> np.ndarray:
    """uint32 (..., H, ceil(W / 4)) -> uint8 (..., H, W) index image."""
    arr = _host_words(packed)
    flat = arr.view(np.uint8).reshape(arr.shape[:-1] + (arr.shape[-1] * 4,))
    return flat[..., :width]


def unpack_rgba(packed) -> np.ndarray:
    """uint32 (..., H, W) -> uint8 (..., H, W, 4) (little-endian view)."""
    arr = _host_words(packed)
    return arr.view(np.uint8).reshape(arr.shape + (4,))
