"""The batched display spectrogram pipeline.

Counterpart of ``spectral_tpu/parallel/sharding.py::batched_spectrogram_fn``
and the reference app's reason to exist (PlotEngine.py:113-135):

    waveform (B, n) -> STFT/PSD kernel (PSD + per-frame extrema; the
                       fmin/fmax band's bins alone)
                    [-> mel kernel (the mel band's rows + their per-frame
                       extrema), with n_mels]
                    -> clip_stats kernel (per-clip extrema, finite flag,
                       display operands)
                    -> display kernel (normalize, dB rescale, jet index,
                       packed words)

On CUDA tensors the stages are the port's hand-written kernels
(``ops.stft_cuda``, ``ops.mel_cuda``, ``ops.display_cuda``), one launch
each: three a call, four with the mel branch (whose STFT launch then
writes no extrema). On CPU tensors they are their plain versions. The
outputs and layouts are the JAX function's:

    psd            (B, T, F) float32, frame-major, never flipped; F the
                   band's bins (cfg.fmin/fmax), or with n_mels the full
                   band (the pre-mel spectrum, not the displayed one)
    mel            (B, T, M) float32, with n_mels: the mel rows whose
                   centres lie in the band
    image          (B, F or M, T) float32, the displayed rows (the band's
                   bins, or the mel rows), display-flipped when flip_image
                   (left out under with_image=False)
    rgb_packed     (B, F or M, T) uint32, row 0 always the highest
                   frequency
    finite         (B,) bool, the per-clip health flag of the displayed
                   rows

plus, in palette mode (the dataset export's pixels, the JAX package's
``colormap_index_packed`` of the image) in place of rgb_packed:

    index_packed   (B, F, ceil(T / 4)) uint32, four LUT indices per word,
                   row 0 always the highest frequency
"""

from __future__ import annotations

from typing import Optional

import torch

from spectral_tpu_torch.config import SpecConfig
from spectral_tpu_torch.core.mel import mel_centers, mel_filterbank
from spectral_tpu_torch.core.stft import (band_row_slice, ensure_real_waveform,
                                          freq_axis)
from spectral_tpu_torch.ops.display_cuda import clip_stats, display_map
from spectral_tpu_torch.ops.mel_cuda import mel_project, mel_spans
from spectral_tpu_torch.ops.stft_cuda import (check_supported, stft_psd,
                                              stft_psd_partials)
from spectral_tpu_torch.utils.device import resolve_device


def batched_spectrogram_fn(fs: float, cfg: SpecConfig, *,
                           colormap: Optional[str] = "jet",
                           share_max: bool = False,
                           flip_image: bool = False,
                           palette: bool = False,
                           with_image: bool = True,
                           device="cuda"):
    """Build the batch pipeline (B, n) -> dict of outputs (module docstring).

    ``device`` names where the pipeline runs ('cuda', the default, 'cuda:N'
    or 'cpu'); the input is moved there, and asking for CUDA without a card
    raises here. share_max normalizes every clip against the batch's
    largest PSD value (the reference's global_max, PlotEngine.py:78,110,
    126); the dB rescale stays per clip. palette=True returns
    index_packed instead of rgb_packed. with_image=False leaves the float
    image out, so the display kernel writes only the packed words (what
    the dataset export reads back). A config the STFT kernel cannot
    compute raises NotImplementedError here, on every device.

    cfg.fmin/fmax mask rows before normalization, as the reference does
    (PlotEngine.py:114-127: mask, then base = max over the masked band):
    the STFT kernel computes the band's bins alone. With cfg.n_mels the
    mask applies to the mel-centre axis instead, and the mel kernel
    computes those mel rows of the full-band PSD. An empty band, or one
    that is not contiguous (a two-sided spectrum), raises ValueError here
    with the JAX package's text."""
    check_supported(cfg)
    dev = resolve_device(device)
    # static band-row slices (reference mask, PlotEngine.py:114-115)
    if cfg.n_mels:
        band = None
        m_lo, m_hi = band_row_slice(
            mel_centers(cfg.n_mels, fs, cfg.mel_fmin, cfg.mel_fmax,
                        cfg.mel_htk), cfg.fmin, cfg.fmax) or (0, cfg.n_mels)
        fb = mel_filterbank(cfg.n_mels, cfg.n_freqs, fs, cfg.mel_fmin,
                            cfg.mel_fmax, cfg.mel_htk)
        spans = mel_spans(fb[m_lo:m_hi], dev)
    else:
        band = band_row_slice(freq_axis(cfg, fs), cfg.fmin, cfg.fmax)
        if band is not None and not cfg.onesided:
            raise ValueError("band slicing requires a one-sided spectrum")

    def spectrum(x):
        """The displayed rows and their partials, and the outputs beside
        them: the banded PSD, or the full-band PSD and the mel rows."""
        if not cfg.n_mels:
            psd, parts = stft_psd_partials(x, fs, cfg, band)
            return psd, parts, {"psd": psd}
        psd = stft_psd(x, fs, cfg)
        mel, parts = mel_project(psd, spans)
        return mel, parts, {"psd": psd, "mel": mel}

    def fn(xb) -> dict:
        x = ensure_real_waveform(torch.as_tensor(xb, device=dev))
        if x.ndim != 2:
            raise ValueError(f"expected a (B, n) batch, got shape "
                             f"{tuple(x.shape)}")
        x = x.contiguous()
        shown, parts, out = spectrum(x)
        stats = clip_stats(x, parts, share_max)
        image, words = display_map(shown, stats.params,
                                   log_scale=cfg.log_scale,
                                   flip_image=flip_image, colormap=colormap,
                                   palette=palette, with_image=with_image)
        out["finite"] = stats.finite
        if with_image:
            out["image"] = image
        if palette:
            out["index_packed"] = words
        elif colormap:
            out["rgb_packed"] = words
        return out

    return fn
