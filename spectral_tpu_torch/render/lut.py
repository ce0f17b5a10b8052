"""Colormap lookup tables.

The reference renders spectrograms through matplotlib's 'jet' colormap
(``pcolormesh(..., cmap='jet', vmin=0, vmax=1)``, PlotEngine.py:134-135). Here
the colormap is a 256-entry uint8 RGB LUT built host-side from the public
piecewise-linear segment definition and applied on device as a gather
(:mod:`spectral_tpu_torch.ops.colormap`). The byte values match matplotlib's
``colormaps['jet'](linspace(0,1,256), bytes=True)`` exactly (pixel parity,
SURVEY.md §7 hard-part 5).

The port's own copy of ``spectral_tpu/render/lut.py``; the port's tests hold
its tables byte for byte against the JAX package's.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np

# Piecewise-linear segment data: (x, y_below, y_above) triples per channel.
# 'jet' follows the classic MATLAB-style definition (public domain math).
_SEGMENTS: Dict[str, Dict[str, Tuple[Tuple[float, float, float], ...]]] = {
    "jet": {
        "red": ((0.0, 0.0, 0.0), (0.35, 0.0, 0.0), (0.66, 1.0, 1.0),
                 (0.89, 1.0, 1.0), (1.0, 0.5, 0.5)),
        "green": ((0.0, 0.0, 0.0), (0.125, 0.0, 0.0), (0.375, 1.0, 1.0),
                   (0.64, 1.0, 1.0), (0.91, 0.0, 0.0), (1.0, 0.0, 0.0)),
        "blue": ((0.0, 0.5, 0.5), (0.11, 1.0, 1.0), (0.34, 1.0, 1.0),
                  (0.65, 0.0, 0.0), (1.0, 0.0, 0.0)),
    },
    "gray": {
        "red": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
        "green": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
        "blue": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
    },
    "hot": {
        "red": ((0.0, 0.0416, 0.0416), (0.365079, 1.0, 1.0), (1.0, 1.0, 1.0)),
        "green": ((0.0, 0.0, 0.0), (0.365079, 0.0, 0.0),
                   (0.746032, 1.0, 1.0), (1.0, 1.0, 1.0)),
        "blue": ((0.0, 0.0, 0.0), (0.746032, 0.0, 0.0), (1.0, 1.0, 1.0)),
    },
}


def _channel_lut(data, N: int = 256) -> np.ndarray:
    """Piecewise-linear channel table (matplotlib makeMappingArray semantics:
    breakpoints scaled to 0..N-1, integer sample points, y_above on the left
    of a breakpoint, y_below on the right)."""
    arr = np.array(data, dtype=np.float64)
    x = arr[:, 0] * (N - 1)
    y0, y1 = arr[:, 1], arr[:, 2]
    # (N-1)*linspace, NOT arange: the tiny float differences between
    # i/(N-1)*(N-1) and i decide byte rounding, and matplotlib uses linspace
    xind = (N - 1) * np.linspace(0.0, 1.0, N)
    ind = np.searchsorted(x, xind)[1:-1]
    dist = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], dist * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


@functools.lru_cache(maxsize=16)
def get_lut(name: str = "jet", N: int = 256) -> np.ndarray:
    """(N, 3) uint8 RGB LUT. Byte values equal matplotlib's for 'jet'."""
    if name not in _SEGMENTS:
        raise ValueError(f"unknown colormap: {name!r}; have {sorted(_SEGMENTS)}")
    seg = _SEGMENTS[name]
    lut = np.stack([_channel_lut(seg[c], N) for c in ("red", "green", "blue")],
                   axis=1)
    out = (lut * 255).astype(np.uint8)
    # the lru_cache hands the SAME array to every caller: freeze it so an
    # in-place mutation cannot silently corrupt every later palette
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=16)
def get_lut_f32(name: str = "jet", N: int = 256) -> np.ndarray:
    """(N, 3) float32 LUT in [0, 1] (for blending paths)."""
    if name not in _SEGMENTS:  # same friendly error as get_lut
        raise ValueError(f"unknown colormap: {name!r}; have {sorted(_SEGMENTS)}")
    seg = _SEGMENTS[name]
    out = np.stack([_channel_lut(seg[c], N)
                    for c in ("red", "green", "blue")],
                   axis=1).astype(np.float32)
    out.setflags(write=False)
    return out


def available_colormaps():
    return sorted(_SEGMENTS)
