"""Normalization / dB mapping for display, in PyTorch.

Counterpart of ``spectral_tpu/core/scale.py``: the reference's
post-processing (PlotEngine.py:126-131),

    base = max(Sxx)            # or a caller-supplied global_max if > 0
    Sxx_norm = clip(Sxx / (base + 1e-20), 0, 1)
    if log_scale:
        Sxx_db = 10*log10(Sxx_norm + 1e-12); nan_to_num
        rng = max_db - min_db
        Sxx_norm = (Sxx_db - min_db)/rng  if rng > 1e-6 else zeros

Every function reduces over the last two axes (one image) and broadcasts
over any leading batch axes, so a (B, F, T) batch normalizes per image in
one call. Per-image scalars (base, extrema) may be passed as tensors shaped
to broadcast against the image, e.g. (B, 1, 1).

The display map takes the denominator base + 1e-20 as an operand
(:func:`normalize_with_denominator`), so the display kernel can take it,
and the clip's extrema, precomputed per clip (``ops.display_cuda``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

Scalar = Union[float, torch.Tensor]


def _db_of(v: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(
        10.0 * torch.log10(torch.clamp(v / denom, 0.0, 1.0) + 1e-12))


def display_base(base_max: torch.Tensor,
                 global_max: Optional[Scalar] = None) -> torch.Tensor:
    """The display base: base_max (the NaN-propagating max(Sxx), np.max
    semantics), or global_max where that is > 0."""
    if global_max is None:
        return base_max
    gm = torch.as_tensor(global_max, dtype=base_max.dtype,
                         device=base_max.device)
    return torch.where(gm > 0, gm, base_max)


def normalize_with_denominator(sxx: torch.Tensor, denom: torch.Tensor,
                               ext_min: torch.Tensor, ext_max: torch.Tensor,
                               log_scale: bool,
                               has_nan: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """The single implementation of PlotEngine.py:126-131 in the port,
    given denom = base + 1e-20. ext_min/ext_max feed the dB extrema, which
    equal the dB map evaluated at them because the map is monotone;
    has_nan folds in the 0 that nan_to_num assigns NaN pixels."""
    if not log_scale:
        return torch.clamp(sxx / denom, 0.0, 1.0)
    min_db = _db_of(ext_min, denom)
    max_db = _db_of(ext_max, denom)
    if has_nan is not None:
        min_db = torch.where(has_nan, torch.clamp(min_db, max=0.0), min_db)
        max_db = torch.where(has_nan, torch.clamp(max_db, min=0.0), max_db)
    rng = max_db - min_db
    ok = rng > 1e-6
    db = _db_of(sxx, denom)
    rescaled = (db - min_db) / torch.where(ok, rng, 1.0)
    # numpy's division lands the max pixel at exactly 1.0; keep the clip
    # so no rounding path can overshoot the reference's value range
    rescaled = torch.clamp(rescaled, 0.0, 1.0)
    return torch.where(ok, rescaled, torch.zeros_like(db))


def _display_map(sxx: torch.Tensor, base_max: torch.Tensor,
                 ext_min: torch.Tensor, ext_max: torch.Tensor,
                 log_scale: bool, global_max: Optional[Scalar],
                 has_nan: Optional[torch.Tensor]) -> torch.Tensor:
    return normalize_with_denominator(
        sxx, display_base(base_max, global_max) + 1e-20, ext_min, ext_max,
        log_scale, has_nan)


def _image_reduce(sxx: torch.Tensor, op) -> torch.Tensor:
    return op(sxx, dim=(-2, -1), keepdim=True)


def normalize(sxx: torch.Tensor, log_scale: bool = False,
              global_max: Optional[Scalar] = None) -> torch.Tensor:
    """Map a PSD image (..., F, T) to the [0, 1] display image.

    global_max is used as the base only if > 0, else max(Sxx) (the
    reference's global_max argument, PlotEngine.py:126)."""
    nan = torch.isnan(sxx)
    all_nan = _image_reduce(nan, torch.all)
    # nanmin / nanmax: NaN pixels ignored; an all-NaN image gives NaN
    ext_min = torch.where(
        all_nan, torch.nan,
        _image_reduce(torch.where(nan, torch.inf, sxx), torch.amin))
    ext_max = torch.where(
        all_nan, torch.nan,
        _image_reduce(torch.where(nan, -torch.inf, sxx), torch.amax))
    return _display_map(sxx, _image_reduce(sxx, torch.amax), ext_min,
                        ext_max, log_scale, global_max,
                        _image_reduce(nan, torch.any) if log_scale else None)


def normalize_from_stats(sxx: torch.Tensor, own_min: torch.Tensor,
                         own_max: torch.Tensor, log_scale: bool = False,
                         global_max: Optional[Scalar] = None
                         ) -> torch.Tensor:
    """:func:`normalize` with the image's min/max supplied by the caller
    (reduced inside the STFT kernel). Identical output for finite PSDs."""
    return _display_map(sxx, own_max, own_min, own_max, log_scale,
                        global_max, None)


def normalize_batch(sxx_batch: torch.Tensor, log_scale: bool = False,
                    share_max: bool = False) -> torch.Tensor:
    """Normalize a freq-major batch (B, F, T) per image. share_max=True uses
    one base across the batch (the reference's global_max workflow,
    PlotEngine.py:78,110,126); the dB rescale stays per image."""
    return normalize(sxx_batch, log_scale,
                     torch.amax(sxx_batch) if share_max else None)
