"""Time-domain waveform rasterization, in PyTorch.

Counterpart of ``spectral_tpu/render/waveform.py`` (an XLA program there,
no Pallas kernel). Replaces the reference's batch signal PNG export, which
re-renders each sweep through matplotlib at dpi=3000
(ExportManager.export_batch_signals_to_png, ExportManager.py:113-189). A
waveform image is a min/max envelope fill: each pixel column covers a fixed
time bin, and the signal's min and max within the bin define the vertical
span of lit pixels. The masks and bytes are the JAX package's: the same
float32 arithmetic in the same order.

Reference semantics preserved as options: fixed x-limit window (the reference
hardcodes 0-300 s, :178), shared symmetric y-limits across a batch (global
max-amplitude pass, :126-144, :179), black line on transparent background
(:175, savefig(transparent=True) :184).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _nanmin(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """jnp.nanmin: NaN ignored, an all-NaN slice gives NaN."""
    nan = torch.isnan(x)
    out = torch.amin(torch.where(nan, torch.inf, x), dim=dim, keepdim=keepdim)
    return torch.where(torch.all(nan, dim=dim, keepdim=keepdim), torch.nan,
                       out)


def _nanmax(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """jnp.nanmax: NaN ignored, an all-NaN slice gives NaN."""
    nan = torch.isnan(x)
    out = torch.amax(torch.where(nan, -torch.inf, x), dim=dim,
                     keepdim=keepdim)
    return torch.where(torch.all(nan, dim=dim, keepdim=keepdim), torch.nan,
                       out)


def waveform_image(x: torch.Tensor, height: int = 800, width: int = 2400,
                   y_limit: Optional[float] = None,
                   n_samples_visible: Optional[int] = None) -> torch.Tensor:
    """Render (..., n) signals to (..., height, width) boolean line masks on
    x's device.

    y_limit: symmetric vertical scale (default: per-signal max |x|; pass the
    batch-global max to reproduce the reference's shared y-scale).
    n_samples_visible: how many samples span the x-axis (default: all n;
    pass int(300 * fs) to reproduce the reference's fixed 0-300 s window —
    signals shorter than the window leave the remaining columns empty).
    """
    n = x.shape[-1]
    vis = n_samples_visible if n_samples_visible is not None else n
    spc = max(1, -(-vis // width))          # samples per column (ceil)
    total = spc * width
    # truncate at the requested window before padding: total rounds vis up
    # to a column multiple, and slicing x[..., :total] would render up to
    # spc - 1 samples past the window edge (the reference's xlim is a hard
    # cut)
    cut = min(vis, n)
    x32 = x.to(torch.float32)
    # pad with NaN so out-of-range columns produce empty spans
    xp = torch.nn.functional.pad(x32[..., :cut], (0, total - cut),
                                 value=float("nan"))
    cols = xp.reshape(x.shape[:-1] + (width, spc))
    cmin = _nanmin(cols, -1)                           # (..., W)
    cmax = _nanmax(cols, -1)

    if y_limit is None:
        # per-signal max |x| over the full signal (the reference's
        # amplitude pass, ExportManager.py:126-144), not over the visible
        # window, which would rescale truncated renders
        ylim = _nanmax(torch.abs(x32), -1, keepdim=True)      # (..., 1)
    else:
        ylim = torch.tensor(y_limit, dtype=torch.float32, device=x.device)
    ylim = torch.clamp(ylim, min=1e-30)

    # pixel row y (0 = top) covers amplitude a(y) = ylim * (1 - 2*(y+.5)/H)
    rows = torch.arange(height, dtype=torch.float32, device=x.device)
    ys = 1.0 - 2.0 * (rows + 0.5) / height
    lim = ylim[..., None]                                     # (..., 1, 1)
    amp = ys[:, None] * lim                                   # (..., H, 1)
    # column span grown by half a pixel so the line is always >= 1 px thick
    half_px = lim / height
    lo = cmin[..., None, :] - half_px
    hi = cmax[..., None, :] + half_px
    return (amp >= lo) & (amp <= hi)


def waveform_rgba(x: torch.Tensor, height: int = 800, width: int = 2400,
                  y_limit: Optional[float] = None,
                  n_samples_visible: Optional[int] = None,
                  color: Tuple[int, int, int] = (0, 0, 0),
                  transparent: bool = True) -> torch.Tensor:
    """Render signals to uint8 RGBA images (..., H, W, 4): colored line on a
    transparent (or white) background, mirroring the reference's black-line
    transparent export."""
    mask = waveform_image(x, height, width, y_limit, n_samples_visible)
    c = torch.tensor(color, dtype=torch.uint8, device=x.device)
    bg = torch.tensor([255, 255, 255], dtype=torch.uint8, device=x.device)
    rgb = torch.where(mask[..., None], c, bg)
    alpha = torch.where(mask, 255, 0 if transparent else 255
                        ).to(torch.uint8)[..., None]
    return torch.cat([rgb, alpha], dim=-1)
