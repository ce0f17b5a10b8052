"""The batched display spectrogram pipeline.

Counterpart of ``spectral_tpu/parallel/sharding.py::batched_spectrogram_fn``
and the reference app's reason to exist (PlotEngine.py:113-135):

    waveform (B, n) -> STFT/PSD kernel (PSD + per-frame extrema)
                    -> clip_stats kernel (per-clip extrema, finite flag,
                       display operands)
                    -> display kernel (normalize, dB rescale, jet index,
                       packed words)

On CUDA tensors the three stages are the port's hand-written kernels
(``ops.stft_cuda``, ``ops.display_cuda``), one launch each; on CPU tensors
they are their plain versions. The outputs and layouts are the JAX function's:

    psd            (B, T, F) float32, frame-major, never flipped
    image          (B, F, T) float32, display-flipped when flip_image
                   (left out under with_image=False)
    rgb_packed     (B, F, T) uint32, row 0 always the highest frequency
    finite         (B,) bool, the per-clip health flag

plus, in palette mode (the dataset export's pixels, the JAX package's
``colormap_index_packed`` of the image) in place of rgb_packed:

    index_packed   (B, F, ceil(T / 4)) uint32, four LUT indices per word,
                   row 0 always the highest frequency
"""

from __future__ import annotations

from typing import Optional

import torch

from spectral_tpu_torch.config import SpecConfig
from spectral_tpu_torch.core.stft import ensure_real_waveform
from spectral_tpu_torch.ops.display_cuda import clip_stats, display_map
from spectral_tpu_torch.ops.stft_cuda import check_supported, stft_psd_partials
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
    compute raises NotImplementedError here, on every device."""
    check_supported(cfg)
    dev = resolve_device(device)

    def fn(xb) -> dict:
        x = ensure_real_waveform(torch.as_tensor(xb, device=dev))
        if x.ndim != 2:
            raise ValueError(f"expected a (B, n) batch, got shape "
                             f"{tuple(x.shape)}")
        x = x.contiguous()
        psd, parts = stft_psd_partials(x, fs, cfg)
        stats = clip_stats(x, parts, share_max)
        image, words = display_map(psd, stats.params,
                                   log_scale=cfg.log_scale,
                                   flip_image=flip_image, colormap=colormap,
                                   palette=palette, with_image=with_image)
        out = {"psd": psd, "finite": stats.finite}
        if with_image:
            out["image"] = image
        if palette:
            out["index_packed"] = words
        elif colormap:
            out["rgb_packed"] = words
        return out

    return fn
