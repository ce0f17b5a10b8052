"""The display epilogue: a Triton kernel and its plain version.

Port of the jnp tail of ``spectral_tpu/ops/stft_pallas.py::pallas_pipeline_fn``
(``normalize_from_stats`` -> dB -> clip -> colormap pack). One pass over the
frame-major (B, T, F) PSD writes the freq-major (B, F, T) display image and
its packed words, given each clip's PSD extrema from the STFT kernel. The
words are either one RGBA word per pixel (``apply_colormap_packed``) or, in
palette mode, four LUT indices per word with the width padded to a multiple
of 4 (``colormap_index_packed``, the dataset export's default), computed
from the same index the RGBA words take.

What bounds it on this card: memory. Per pixel it reads 4 bytes and writes
8 (about 1.3 GB in and 2.6 GB out at the headline batch) against a handful
of flops and one 256-entry table lookup. The float image store is optional
(``with_image``): the dataset export reads back only the words, so in
palette mode without the image a pixel costs 4 bytes in and one out. Its
one hard part is the transpose
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
from spectral_tpu_torch.ops.colormap import (apply_colormap_packed,
                                             colormap_index_packed,
                                             packed_lut)

BLOCK_T = 64
BLOCK_F = 64
MAX_CLIPS = 65535            # the grid's second axis

# kernel launches per output mode, for run-time proof of the path
launches = {"rgba": 0, "palette": 0}

# Triton's language modules, bound by _kernel() on first use: importing this
# module must work where triton is not installed.
tl = None
libdevice = None


def _display_kernel(psd_ptr, params_ptr, lut_ptr, img_ptr, words_ptr, T, F,
                    n_f_tiles, W4,
                    LOG_SCALE: tl.constexpr, FLIP_IMAGE: tl.constexpr,
                    STORE_IMAGE: tl.constexpr,
                    WORDS: tl.constexpr, BLOCK_T: tl.constexpr,
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
    if STORE_IMAGE:
        if FLIP_IMAGE:
            rows = F - 1 - f
        else:
            rows = f
        tl.store(img_ptr + clip + rows[None, :] * T + t[:, None], img,
                 mask=mask)
    # matplotlib's index rule; a NaN pixel takes index 0 as in torch/jnp
    level = tl.where(img != img, 0.0, img) * 256.0
    idx = tl.minimum(tl.maximum(level.to(tl.int32), 0), 255)
    # packed words always put the highest frequency in row 0
    if WORDS == 1:
        word = tl.load(lut_ptr + idx)
        tl.store(words_ptr + clip + (F - 1 - f)[None, :] * T + t[:, None],
                 word, mask=mask)
    if WORDS == 2:
        # four indices per little-endian word: frame t lands in byte t % 4
        # of word t // 4; frames past T pad with index 0. The tile starts
        # at a multiple of 4 frames, so its words are whole.
        shift = ((t % 4) * 8).to(tl.uint32)
        byte = tl.where(mask, idx, 0).to(tl.uint32) << shift[:, None]
        word = tl.sum(tl.reshape(byte, (BLOCK_T // 4, 4, BLOCK_F)), axis=1)
        t4 = (tile // n_f_tiles) * (BLOCK_T // 4) + tl.arange(0, BLOCK_T // 4)
        tl.store(words_ptr + b.to(tl.int64) * F * W4
                 + (F - 1 - f)[None, :] * W4 + t4[:, None],
                 word.to(tl.int32, bitcast=True),
                 mask=(t4[:, None] < W4) & (f[None, :] < F))


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
                               colormap: Optional[str] = "jet",
                               palette: bool = False,
                               with_image: bool = True
                               ) -> Tuple[Optional[torch.Tensor],
                                          Optional[torch.Tensor]]:
    """The plain version: psd (B, T, F) and extrema (B,) -> image (B, F, T)
    float (display-flipped when flip_image; None unless with_image) and
    packed words with row 0 the highest frequency: RGBA words (B, F, T)
    uint32 from the colormap (None without one), or under palette LUT
    indices four to a word, (B, F, ceil(T / 4)) uint32, whatever the
    colormap."""
    gm = torch.amax(pmax) if share_max else None
    img = normalize_from_stats(psd.transpose(1, 2), pmin[:, None, None],
                               pmax[:, None, None], log_scale, gm)
    if flip_image:
        img = img.flip(1)
    img = img.contiguous()
    if palette:
        words = colormap_index_packed(img, flip_rows=not flip_image)
    else:
        words = (apply_colormap_packed(img, colormap,
                                       flip_rows=not flip_image)
                 if colormap else None)
    return (img if with_image else None), words


def _display_epilogue_triton(psd, pmin, pmax, log_scale, share_max,
                             flip_image, colormap, palette, with_image):
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
    image = (torch.empty((B, F, T), dtype=torch.float32, device=psd.device)
             if with_image else None)
    W4 = -(-T // 4)
    mode = 2 if palette else (1 if colormap else 0)
    words = (torch.empty((B, F, W4), dtype=torch.int32, device=psd.device)
             if palette else
             torch.empty((B, F, T), dtype=torch.int32, device=psd.device)
             if colormap else None)
    if B * T * F:
        n_f_tiles = -(-F // BLOCK_F)
        grid = (-(-T // BLOCK_T) * n_f_tiles, B)
        # the kernel reads the LUT only for RGBA words, writes words only
        # in modes 1 and 2 and the image only under with_image; any valid
        # pointers fill the unused slots
        lut = packed_lut(colormap, psd.device) if mode == 1 else params
        with torch.cuda.device(psd.device):
            kernel[grid](psd, params, lut,
                         params if image is None else image,
                         params if words is None else words, T, F,
                         n_f_tiles, W4, LOG_SCALE=bool(log_scale),
                         FLIP_IMAGE=bool(flip_image),
                         STORE_IMAGE=bool(with_image), WORDS=mode,
                         BLOCK_T=BLOCK_T, BLOCK_F=BLOCK_F, num_warps=4)
        launches["palette" if palette else "rgba"] += 1
    return image, (None if words is None else words.view(torch.uint32))


def display_epilogue(psd: torch.Tensor, pmin: torch.Tensor,
                     pmax: torch.Tensor, *, log_scale: bool,
                     share_max: bool = False, flip_image: bool = False,
                     colormap: Optional[str] = "jet", palette: bool = False,
                     with_image: bool = True
                     ) -> Tuple[Optional[torch.Tensor],
                                Optional[torch.Tensor]]:
    """Display image and packed words from a PSD and its extrema; see
    :func:`display_epilogue_reference` for the layouts. share_max uses the
    batch's largest max as every clip's base (the reference's global_max).
    with_image=False skips the image (returned as None): the kernel then
    writes only the words."""
    if psd.device.type == "cpu":
        return display_epilogue_reference(
            psd, pmin, pmax, log_scale=log_scale, share_max=share_max,
            flip_image=flip_image, colormap=colormap, palette=palette,
            with_image=with_image)
    return _display_epilogue_triton(psd, pmin, pmax, log_scale, share_max,
                                    flip_image, colormap, palette, with_image)
