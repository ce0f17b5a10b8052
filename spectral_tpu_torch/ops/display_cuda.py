"""The display tail: two CUDA kernels and their plain versions.

Counterpart of the jnp tail of
``spectral_tpu/ops/stft_pallas.py::pallas_pipeline_fn`` (K3, :456-495) and
of the ``with_stats`` reduction of ``stft_psd_pallas`` (:447-451). Two
kernels in ``csrc/display.cu``, each launched once per batch after the
STFT kernel:

- :func:`clip_stats` reads the waveform and the STFT kernel's per-row
  (min, max) partials once and gives each clip's PSD extrema, its
  ``finite`` health flag and the display map's operands (B, 3) =
  ``(base + 1e-20, pmin, pmax)`` (:func:`clip_params`). The flag is the JAX
  package's rule: the extrema are finite, and the clip is not a total
  float32 underflow, a clip whose detrended amplitude ``adet = max |x -
  mean|`` lies in (0, 1e-10) while its every bin rounds to zero. The mean
  is the float64 sum rounded once to float32, so a pure-DC clip's mean is
  its sample, ``adet`` is 0 and the clip stays healthy, as the contract
  says.
- :func:`display_map` maps the frame-major (B, T, F) PSD in one pass to
  the freq-major (B, F, T) display image (optional, ``with_image``) and
  its packed words: one RGBA word per pixel, or, in palette mode (the
  dataset export's), four LUT indices per word with the width padded to a
  multiple of 4. Row 0 of the words is always the highest frequency.

What bounds them on this card: memory. clip_stats reads 4 bytes a sample
(655 MB at the display spine's 1024 clips of 10 s) and the partials; the
display map reads 4 bytes a pixel and writes 8 (RGBA and the image) or one
(palette words alone). The kernels' designs are in the source's note.

:func:`clip_stats` and :func:`display_map` take their kernels for CUDA
tensors and their plain versions (:func:`clip_stats_reference`,
:func:`display_map_reference`) for CPU tensors, and only because those lie
on the CPU. On a CUDA tensor they launch or raise.

The gradient: a PSD that requires grad (with grad enabled) gives an image
with a gradient (:class:`_DisplayGrad`), whose backward is the image's
adjoint through ``core.scale.normalize``: each pixel's own term, and the
clip's sums through its operands (the base, its min and its max, which
:func:`clip_stats` reduced from the PSD's partials) added at the pixels
that are the extrema, split evenly among ties; under ``share_max`` the
base's sum goes to the batch's largest pixels. ``display.cu``'s backward
for a CUDA tensor (:func:`display_backward`: a small kernel zeroes its
counts, then one pass over the pixels whose blocks that complete a clip
add its extrema's shares), its plain version
(:func:`display_backward_reference`) for a CPU tensor. The words, the
flag and the extrema carry no gradient, and ``params`` receives none: the
backward reads them as the PSD's own operands and carries their
derivative to the PSD's extrema.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from spectral_tpu_torch.core.scale import display_base, normalize_with_denominator
from spectral_tpu_torch.ops import build
from spectral_tpu_torch.ops.colormap import (apply_colormap_packed,
                                             colormap_index_packed,
                                             packed_lut)

KERNEL = "display"
# display_map_launch's output modes
MODES = {"none": 0, "rgba": 1, "palette": 2}

# kernel launches, for run-time proof of the path: clip_stats, and the
# display map by its words
launches = {"clip_stats": 0, "rgba": 0, "palette": 0}
# the backward's launches (a count a call of its kernels)
grad_launches = {"display_backward": 0}
# 10 / ln 10, the dB map's slope (DB_SLOPE in csrc/display.cu)
DB_SLOPE = 10.0 / math.log(10.0)


class ClipStats(NamedTuple):
    """Per-clip results of :func:`clip_stats`, each (B,) but ``params``."""
    pmin: torch.Tensor
    pmax: torch.Tensor
    finite: torch.Tensor
    params: torch.Tensor     # (B, 3): base + 1e-20, pmin, pmax


_LIB: list = []


def _library() -> ctypes.CDLL:
    """The display kernels' library, built and loaded at first use, then
    kept for the process."""
    if _LIB:
        return _LIB[0]
    lib = build.load_library(KERNEL)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.clip_stats_workspace_bytes.argtypes = [i32, i64]
    lib.clip_stats_workspace_bytes.restype = i64
    lib.clip_stats_launch.argtypes = [ptr] * 3 + [i32, i64, i32, i32, i32] + [
        ptr] * 6
    lib.clip_stats_launch.restype = i32
    lib.display_map_launch.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
    lib.display_map_launch.restype = i32
    lib.display_backward_workspace_bytes.argtypes = [i32, i32, i32]
    lib.display_backward_workspace_bytes.restype = i64
    lib.display_backward_launch.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
    lib.display_backward_launch.restype = i32
    lib.display_error_string.argtypes = [i32]
    lib.display_error_string.restype = ctypes.c_char_p
    _LIB.append(lib)
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + _library().display_error_string(err).decode())


def clip_params(pmin: torch.Tensor, pmax: torch.Tensor,
                share_max: bool = False) -> torch.Tensor:
    """(B, 3) per-clip operands of the display map: the display base plus
    1e-20 (the clip's max, or the batch max under share_max when it is >
    0), and the clip's PSD min and max."""
    base = display_base(pmax, torch.amax(pmax) if share_max else None)
    return torch.stack([base + 1e-20, pmin, pmax], dim=1).contiguous()


def clip_stats_reference(x: torch.Tensor, parts: torch.Tensor,
                         share_max: bool = False) -> ClipStats:
    """The plain version of :func:`clip_stats`: x (B, n) and the STFT
    kernel's partials (2, n_tiles, B, T) (min, then max, of each frame's
    bins in each frequency tile). The extrema are NaN-propagating, and 0
    when T is 0, as the STFT kernel's with_stats gives them."""
    B, n = x.shape
    if parts.shape[-1] == 0 or parts.shape[1] == 0:
        pmin = pmax = x.new_zeros(B)
    else:
        pmin = torch.amin(parts[0], dim=(0, 2))
        pmax = torch.amax(parts[1], dim=(0, 2))
    mean = (x.double().sum(dim=-1) / n).to(x.dtype)
    adet = (torch.amax(torch.abs(x - mean[:, None]), dim=-1) if n
            else torch.full_like(mean, torch.nan))
    underflow = (pmax == 0) & (adet > 0) & (adet < 1e-10)
    finite = torch.isfinite(pmin) & torch.isfinite(pmax) & ~underflow
    return ClipStats(pmin, pmax, finite, clip_params(pmin, pmax, share_max))


def _clip_stats_cuda(x, parts, share_max):
    lib = _library()
    if x.device.type != "cuda":
        raise ValueError(f"the clip_stats kernel takes CUDA tensors, got "
                         f"{x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError("the clip_stats kernel takes a contiguous float32 "
                        "(B, n) waveform")
    B, n = x.shape
    _, n_tiles, pb, T = parts.shape
    if (parts.device != x.device or parts.dtype != torch.float32
            or not parts.is_contiguous() or pb != B):
        raise ValueError(f"partials (2, n_tiles, {B}, T) float32 on "
                         f"{x.device} expected, got {tuple(parts.shape)} "
                         f"{parts.dtype} on {parts.device}")
    pmin = torch.empty(B, dtype=torch.float32, device=x.device)
    pmax = torch.empty_like(pmin)
    finite = torch.empty(B, dtype=torch.bool, device=x.device)
    params = torch.empty((B, 3), dtype=torch.float32, device=x.device)
    if B:
        work = torch.empty(lib.clip_stats_workspace_bytes(B, n),
                           dtype=torch.uint8, device=x.device)
        rows = parts.numel() > 0
        with torch.cuda.device(x.device):
            err = lib.clip_stats_launch(
                x.data_ptr(), parts[0].data_ptr() if rows else None,
                parts[1].data_ptr() if rows else None, B, n, T,
                n_tiles if rows else 0, int(share_max), work.data_ptr(),
                pmin.data_ptr(), pmax.data_ptr(), finite.data_ptr(),
                params.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
        _raise_on(err, "clip_stats")
        launches["clip_stats"] += 1
    return ClipStats(pmin, pmax, finite, params)


def clip_stats(x: torch.Tensor, parts: torch.Tensor,
               share_max: bool = False) -> ClipStats:
    """Per-clip PSD extrema, health flag and display operands from the
    waveform x (B, n) and the STFT kernel's partials (2, n_tiles, B, T):
    one kernel launch for CUDA tensors; see :func:`clip_stats_reference`."""
    if x.device.type == "cpu":
        return clip_stats_reference(x, parts, share_max)
    return _clip_stats_cuda(x, parts, share_max)


def display_map_reference(psd: torch.Tensor, params: torch.Tensor, *,
                          log_scale: bool, flip_image: bool = False,
                          colormap: Optional[str] = "jet",
                          palette: bool = False, with_image: bool = True
                          ) -> Tuple[Optional[torch.Tensor],
                                     Optional[torch.Tensor]]:
    """The plain version of :func:`display_map`: psd (B, T, F) and the
    per-clip operands (B, 3) -> image (B, F, T) float (display-flipped when
    flip_image; None unless with_image) and packed words with row 0 the
    highest frequency: RGBA words (B, F, T) uint32 from the colormap (None
    without one), or under palette LUT indices four to a word, (B, F,
    ceil(T / 4)) uint32, whatever the colormap."""
    p = params[:, :, None, None]
    img = normalize_with_denominator(psd.transpose(1, 2), p[:, 0], p[:, 1],
                                     p[:, 2], log_scale)
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


def _display_map_cuda(psd, params, log_scale, flip_image, colormap, palette,
                      with_image):
    lib = _library()
    if psd.device.type != "cuda":
        raise ValueError(f"the display kernel takes CUDA tensors, got "
                         f"{psd.device}")
    if psd.dtype != torch.float32 or not psd.is_contiguous():
        raise TypeError("the display kernel takes a contiguous float32 PSD")
    B, T, F = psd.shape
    if (params.shape != (B, 3) or params.dtype != torch.float32
            or not params.is_contiguous() or params.device != psd.device):
        raise ValueError(f"params must be a contiguous ({B}, 3) float32 "
                         f"tensor on {psd.device}")
    mode = "palette" if palette else ("rgba" if colormap else "none")
    dev = psd.device
    image = (torch.empty((B, F, T), dtype=torch.float32, device=dev)
             if with_image else None)
    words = (torch.empty((B, F, -(-T // 4)), dtype=torch.int32, device=dev)
             if palette else
             torch.empty((B, F, T), dtype=torch.int32, device=dev)
             if colormap else None)
    if B * T * F and (image is not None or words is not None):
        lut = packed_lut(colormap, dev) if mode == "rgba" else None
        with torch.cuda.device(dev):
            err = lib.display_map_launch(
                psd.data_ptr(), params.data_ptr(),
                None if lut is None else lut.data_ptr(),
                None if image is None else image.data_ptr(),
                None if words is None else words.data_ptr(), B, T, F,
                MODES[mode], int(bool(log_scale)), int(bool(with_image)),
                int(bool(flip_image)), torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(err, "display map")
        launches["palette" if palette else "rgba"] += 1
    return image, (None if words is None else words.view(torch.uint32))


def _display_forward(psd, params, log_scale, flip_image, colormap, palette,
                     with_image):
    if psd.device.type == "cpu":
        return display_map_reference(
            psd, params, log_scale=log_scale, flip_image=flip_image,
            colormap=colormap, palette=palette, with_image=with_image)
    return _display_map_cuda(psd, params, log_scale, flip_image, colormap,
                             palette, with_image)


def _clip_slope(a: torch.Tensor) -> torch.Tensor:
    """jnp.clip(a, 0, 1)'s derivative as jax.grad gives it: 1 inside, 0
    outside, 0.5 at either bound (``display.cu::clip_slope``)."""
    return torch.where((a > 0.0) & (a < 1.0), 1.0,
                       torch.where((a == 0.0) | (a == 1.0), 0.5, 0.0))


def _db_grad(v: torch.Tensor, d: torch.Tensor):
    """db(v) = 10 log10(clip(v / d, 0, 1) + 1e-12) and its derivatives by
    v and by d, times the clip's derivative at v / d, in float64, as
    ``display.cu::db_grad``."""
    u = v / d
    y = torch.clamp(u, 0.0, 1.0) + 1e-12
    dv = _clip_slope(u) * (DB_SLOPE / y / d)
    return 10.0 * torch.log10(y), dv, -(dv * u)


def display_backward_reference(g: torch.Tensor, psd: torch.Tensor,
                               params: torch.Tensor, *, log_scale: bool,
                               flip_image: bool = False,
                               share_max: bool = False) -> torch.Tensor:
    """The plain version of the display backward kernels: the gradient of
    the PSD (B, T, F) from the image's g (B, F, T) (rows flipped under
    flip_image), in float64 from the map's inputs, rounded once to psd's
    dtype. A pixel's own term, then the clip's sums through its operands
    (base + 1e-20, min, max: ``params``) added at its extrema, split
    evenly among ties; under share_max the base's sum of every clip at the
    batch's largest pixels (when that max is > 0). Clips whose dB range is
    at most 1e-6 (a zero image) get a zero gradient. The clips' derivative
    is jax.grad's, 0.5 at a bound (torch.clamp's 1 there gives the same
    gradient wherever the extrema are not tied)."""
    s = psd.double()
    G = (g.flip(1) if flip_image else g).transpose(1, 2).double()
    p = params.double()[:, :, None, None]
    d, lo, hi = p[:, 0], p[:, 1], p[:, 2]
    n_lo = (s == lo).sum(dim=(1, 2), dtype=torch.float64)
    n_hi = (s == hi).sum(dim=(1, 2), dtype=torch.float64)
    if not log_scale:
        u = s / d
        h = _clip_slope(u)
        inside = h != 0.0
        q = h * (G / d)
        own = torch.where(inside, q, 0.0)
        c_d = torch.where(inside, -(q * u), 0.0).sum(dim=(1, 2))
        c_lo = c_hi = torch.zeros_like(n_lo)
    else:
        db_lo, dv_lo, dd_lo = _db_grad(lo, d)
        db_hi, dv_hi, dd_hi = _db_grad(hi, d)
        rng = db_hi - db_lo
        db, dv, dd = _db_grad(s, d)
        r = (db - db_lo) / rng
        h = _clip_slope(r)
        inside = (h != 0.0) & (rng > 1e-6)
        k = torch.where(inside, h * (G / rng), 0.0)
        a_lo = k * (r - 1.0)
        a_hi = -(k * r)
        own = torch.where(inside, k * dv, 0.0)
        c_d = torch.where(inside, k * dd + a_lo * dd_lo + a_hi * dd_hi,
                          0.0).sum(dim=(1, 2))
        c_lo = torch.where(inside, a_lo * dv_lo, 0.0).sum(dim=(1, 2))
        c_hi = torch.where(inside, a_hi * dv_hi, 0.0).sum(dim=(1, 2))
    top = torch.amax(params[:, 2]) if share_max else None
    batch_base = top is not None and bool(top > 0)
    at_lo = torch.where(n_lo > 0, c_lo / n_lo, 0.0)
    at_hi = c_hi if batch_base else c_hi + c_d
    at_hi = torch.where(n_hi > 0, at_hi / n_hi, 0.0)
    if batch_base:
        holds = params[:, 2] == top
        tot_n = n_hi[holds].sum()
        if tot_n > 0:
            at_hi = at_hi + torch.where(holds, c_d.sum() / tot_n, 0.0)
    dpsd = (own + torch.where(s == lo, at_lo[:, None, None], 0.0)
            + torch.where(s == hi, at_hi[:, None, None], 0.0))
    return dpsd.to(psd.dtype)


def _display_backward_cuda(g, psd, params, log_scale, flip_image,
                           share_max):
    lib = _library()
    g = g.contiguous()
    B, T, F = psd.shape
    if g.dtype != torch.float32 or tuple(g.shape) != (B, F, T):
        raise ValueError(f"the display backward takes a ({B}, {F}, {T}) "
                         f"float32 gradient, got {tuple(g.shape)} {g.dtype}")
    dpsd = torch.empty_like(psd)
    if B * T * F:
        work = torch.empty(lib.display_backward_workspace_bytes(B, T, F),
                           dtype=torch.uint8, device=psd.device)
        with torch.cuda.device(psd.device):
            err = lib.display_backward_launch(
                g.data_ptr(), psd.data_ptr(), params.data_ptr(),
                dpsd.data_ptr(), work.data_ptr(), B, T, F,
                int(bool(log_scale)), int(bool(flip_image)),
                int(bool(share_max)),
                torch.cuda.current_stream(psd.device).cuda_stream)
        _raise_on(err, "display backward")
        grad_launches["display_backward"] += 1
    return dpsd


def display_backward(g: torch.Tensor, psd: torch.Tensor,
                     params: torch.Tensor, *, log_scale: bool,
                     flip_image: bool = False,
                     share_max: bool = False) -> torch.Tensor:
    """The gradient of the PSD from the image's: the backward kernel
    for a CUDA tensor, the plain version
    (:func:`display_backward_reference`) for a CPU tensor."""
    if psd.device.type == "cpu":
        return display_backward_reference(g, psd, params,
                                          log_scale=log_scale,
                                          flip_image=flip_image,
                                          share_max=share_max)
    return _display_backward_cuda(g, psd, params, log_scale, flip_image,
                                  share_max)


class _DisplayGrad(torch.autograd.Function):
    """The display image as a differentiable function of the PSD; the
    words carry no gradient and params receives none."""

    @staticmethod
    def forward(ctx, psd, params, log_scale, flip_image, colormap, palette,
                share_max):
        ctx.save_for_backward(psd, params)
        ctx.opts = (log_scale, flip_image, share_max)
        image, words = _display_forward(psd, params, log_scale, flip_image,
                                        colormap, palette, True)
        if words is not None:
            ctx.mark_non_differentiable(words)
        return image, words

    @staticmethod
    def backward(ctx, g, _):
        psd, params = ctx.saved_tensors
        log_scale, flip_image, share_max = ctx.opts
        return (display_backward(g, psd, params, log_scale=log_scale,
                                 flip_image=flip_image, share_max=share_max),
                None, None, None, None, None, None)


def display_map(psd: torch.Tensor, params: torch.Tensor, *, log_scale: bool,
                flip_image: bool = False, colormap: Optional[str] = "jet",
                palette: bool = False, with_image: bool = True,
                share_max: bool = False
                ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Display image and packed words from a PSD and its per-clip operands
    (:func:`clip_stats`'s ``params``, or :func:`clip_params`); see
    :func:`display_map_reference` for the layouts. with_image=False skips
    the image (returned as None): the kernel then writes only the words.
    A PSD that requires grad gives an image with a gradient
    (:class:`_DisplayGrad`); share_max says that params' base is the
    batch's (``clip_stats(..., share_max=True)``), which only the gradient
    reads."""
    if with_image and psd.requires_grad and torch.is_grad_enabled():
        return _DisplayGrad.apply(psd, params, log_scale, flip_image,
                                  colormap, palette, share_max)
    return _display_forward(psd, params, log_scale, flip_image, colormap,
                            palette, with_image)
