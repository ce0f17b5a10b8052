"""The display epilogue: a Triton kernel and its plain version.

Port of the jnp tail of ``spectral_tpu/ops/stft_pallas.py::pallas_pipeline_fn``
(``normalize_from_stats`` -> dB -> clip -> colormap pack). One pass over the
frame-major (B, T, F) PSD writes the freq-major (B, F, T) display image and
its packed RGBA words, given each clip's PSD extrema from the STFT kernel.

What bounds it on this card: memory. Per pixel it reads 4 bytes and writes
8 (about 1.3 GB in and 2.6 GB out at the headline batch) against a handful
of flops and one 256-entry table lookup. Its one hard part is the transpose
from frame-major to freq-major: each program owns a 64 x 64 (frames x bins)
tile, loads it along bins and stores it along frames, and Triton stages the
layout change through shared memory, so both sides stay coalesced.

The display base comes from ``core.scale.display_params`` on (B,) tensors,
shared with the plain version; the kernel evaluates the dB extrema at the
clip's PSD min and max with the same libdevice log10 as its pixels, and
divides with round-to-nearest (``div_rn``), so the max pixel lands at
exactly 1.0 as the reference's numpy division does.

:func:`display_epilogue` takes the kernel for CUDA tensors and the plain
version for CPU tensors, and only because they lie on the CPU.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from spectral_tpu_torch.core.scale import display_params, normalize_from_stats
from spectral_tpu_torch.ops.colormap import apply_colormap_packed, packed_lut

BLOCK_T = 64
BLOCK_F = 64
MAX_CLIPS = 65535            # the grid's second axis

launches = 0                 # kernel launches, for run-time proof of the path

# Triton's language modules, bound by _kernel() on first use: importing this
# module must work where triton is not installed.
tl = None
libdevice = None


def _display_kernel(psd_ptr, params_ptr, lut_ptr, img_ptr, rgb_ptr, T, F,
                    n_f_tiles,
                    LOG_SCALE: tl.constexpr, FLIP_IMAGE: tl.constexpr,
                    WITH_RGB: tl.constexpr, BLOCK_T: tl.constexpr,
                    BLOCK_F: tl.constexpr):
    tile = tl.program_id(0)
    b = tl.program_id(1)
    t = (tile // n_f_tiles) * BLOCK_T + tl.arange(0, BLOCK_T)
    f = (tile % n_f_tiles) * BLOCK_F + tl.arange(0, BLOCK_F)
    mask = (t[:, None] < T) & (f[None, :] < F)
    clip = b.to(tl.int64) * T * F
    v = tl.load(psd_ptr + clip + t[:, None] * F + f[None, :], mask=mask,
                other=0.0)
    # params[b] = (base + 1e-20, PSD min, PSD max); clips to [0, 1] keep
    # NaN, as jnp.clip does
    base = tl.load(params_ptr + b * 3)
    norm = libdevice.div_rn(v, base)
    norm = tl.where(norm != norm, norm,
                    tl.minimum(tl.maximum(norm, 0.0), 1.0))
    if LOG_SCALE:
        # the dB extrema are the dB map at the PSD extrema, evaluated here
        # with the same log10 as the pixels, so the max pixel is exactly 1
        lo = libdevice.div_rn(tl.load(params_ptr + b * 3 + 1), base)
        lo = tl.where(lo != lo, lo, tl.minimum(tl.maximum(lo, 0.0), 1.0))
        min_db = 10.0 * libdevice.log10(lo + 1e-12)
        min_db = tl.where(min_db != min_db, 0.0, min_db)     # nan_to_num
        hi = libdevice.div_rn(tl.load(params_ptr + b * 3 + 2), base)
        hi = tl.where(hi != hi, hi, tl.minimum(tl.maximum(hi, 0.0), 1.0))
        max_db = 10.0 * libdevice.log10(hi + 1e-12)
        max_db = tl.where(max_db != max_db, 0.0, max_db)
        rng = max_db - min_db
        db = 10.0 * libdevice.log10(norm + 1e-12)
        db = tl.where(db != db, 0.0, db)
        r = libdevice.div_rn(db - min_db, tl.where(rng > 1e-6, rng, 1.0))
        r = tl.where(r != r, r, tl.minimum(tl.maximum(r, 0.0), 1.0))
        img = tl.where(rng > 1e-6, r, 0.0)
    else:
        img = norm
    if FLIP_IMAGE:
        rows = F - 1 - f
    else:
        rows = f
    tl.store(img_ptr + clip + rows[None, :] * T + t[:, None], img, mask=mask)
    if WITH_RGB:
        # matplotlib's index rule; a NaN pixel takes index 0 as in torch/jnp
        level = tl.where(img != img, 0.0, img) * 256.0
        idx = tl.minimum(tl.maximum(level.to(tl.int32), 0), 255)
        word = tl.load(lut_ptr + idx)
        # packed words always put the highest frequency in row 0
        tl.store(rgb_ptr + clip + (F - 1 - f)[None, :] * T + t[:, None],
                 word, mask=mask)


@functools.lru_cache(maxsize=1)
def _kernel():
    """Import triton and JIT-wrap the kernel (compiled at first launch)."""
    global tl, libdevice
    import triton
    import triton.language as triton_language
    from triton.language.extra import libdevice as triton_libdevice
    tl, libdevice = triton_language, triton_libdevice
    return triton.jit(_display_kernel)


def clip_params(pmin: torch.Tensor, pmax: torch.Tensor,
                share_max: bool = False) -> torch.Tensor:
    """(B, 3) float32 per-clip operands of the kernel: the display base
    plus 1e-20 (the clip's max, or the batch max under share_max when it
    is > 0), and the clip's PSD min and max."""
    gm = torch.amax(pmax) if share_max else None
    base = display_params(pmax, pmin, pmax, False, gm)[0]
    return torch.stack([(base + 1e-20).expand(pmax.shape), pmin, pmax],
                       dim=1).float().contiguous()


def display_epilogue_reference(psd: torch.Tensor, pmin: torch.Tensor,
                               pmax: torch.Tensor, *, log_scale: bool,
                               share_max: bool = False,
                               flip_image: bool = False,
                               colormap: Optional[str] = "jet"
                               ) -> Tuple[torch.Tensor,
                                          Optional[torch.Tensor]]:
    """The plain version: psd (B, T, F) and extrema (B,) -> image (B, F, T)
    float (display-flipped when flip_image) and packed RGBA words (B, F, T)
    uint32 with row 0 the highest frequency (None without a colormap)."""
    gm = torch.amax(pmax) if share_max else None
    img = normalize_from_stats(psd.transpose(1, 2), pmin[:, None, None],
                               pmax[:, None, None], log_scale, gm)
    if flip_image:
        img = img.flip(1)
    img = img.contiguous()
    rgb = (apply_colormap_packed(img, colormap, flip_rows=not flip_image)
           if colormap else None)
    return img, rgb


def _display_epilogue_triton(psd, pmin, pmax, log_scale, share_max,
                             flip_image, colormap):
    global launches
    kernel = _kernel()
    if psd.device.type != "cuda":
        raise ValueError(f"the display kernel takes CUDA tensors, "
                         f"got {psd.device}")
    if psd.dtype != torch.float32 or not psd.is_contiguous():
        raise TypeError("the display kernel takes a contiguous float32 PSD")
    B, T, F = psd.shape
    if pmin.shape != (B,) or pmax.shape != (B,):
        raise ValueError(f"pmin/pmax must have shape ({B},)")
    if B > MAX_CLIPS:
        raise ValueError(f"at most {MAX_CLIPS} clips per launch, got {B}")
    params = clip_params(pmin, pmax, share_max)
    image = torch.empty((B, F, T), dtype=torch.float32, device=psd.device)
    rgb = (torch.empty((B, F, T), dtype=torch.int32, device=psd.device)
           if colormap else None)
    if B * T * F:
        n_f_tiles = -(-F // BLOCK_F)
        grid = (-(-T // BLOCK_T) * n_f_tiles, B)
        # without a colormap the kernel reads no LUT and writes no words;
        # any valid pointers fill those two slots
        lut = packed_lut(colormap, psd.device) if colormap else params
        with torch.cuda.device(psd.device):
            kernel[grid](psd, params, lut, image,
                         rgb if colormap else image, T, F, n_f_tiles,
                         LOG_SCALE=bool(log_scale),
                         FLIP_IMAGE=bool(flip_image),
                         WITH_RGB=bool(colormap), BLOCK_T=BLOCK_T,
                         BLOCK_F=BLOCK_F, num_warps=4)
        launches += 1
    return image, (rgb.view(torch.uint32) if colormap else None)


def display_epilogue(psd: torch.Tensor, pmin: torch.Tensor,
                     pmax: torch.Tensor, *, log_scale: bool,
                     share_max: bool = False, flip_image: bool = False,
                     colormap: Optional[str] = "jet"
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Display image and packed words from a PSD and its extrema; see
    :func:`display_epilogue_reference` for the layouts. share_max uses the
    batch's largest max as every clip's base (the reference's global_max)."""
    if psd.device.type == "cpu":
        return display_epilogue_reference(
            psd, pmin, pmax, log_scale=log_scale, share_max=share_max,
            flip_image=flip_image, colormap=colormap)
    return _display_epilogue_triton(psd, pmin, pmax, log_scale, share_max,
                                    flip_image, colormap)
