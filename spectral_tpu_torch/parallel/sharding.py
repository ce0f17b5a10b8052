"""The batched display spectrogram pipeline.

Counterpart of ``spectral_tpu/parallel/sharding.py::batched_spectrogram_fn``
and the reference app's reason to exist (PlotEngine.py:113-135):

    waveform (B, n) -> STFT/PSD kernel (PSD + per-clip extrema)
                    -> display kernel (normalize, dB rescale, jet index,
                       packed words)

On CUDA tensors both stages are the port's hand-written kernels
(``ops.stft_cuda``, ``ops.display_triton``); on CPU tensors they are their
plain versions. The outputs and layouts are the JAX function's:

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
from spectral_tpu_torch.ops.display_triton import display_epilogue
from spectral_tpu_torch.ops.stft_cuda import check_supported, stft_psd
from spectral_tpu_torch.utils.device import resolve_device


def finite_flags(x: torch.Tensor, pmin: torch.Tensor,
                 pmax: torch.Tensor) -> torch.Tensor:
    """Per-clip health of the displayed spectrum (the rule of the JAX
    package's ``pallas_pipeline_fn``): the PSD extrema are finite (inf
    overflows and NaN samples poison them), and the clip is not a total
    float32 underflow — a tiny-but-real clip (detrended amplitude under
    1e-10) whose every bin rounds to zero. Exact silence and pure DC stay
    healthy."""
    adet = torch.amax(torch.abs(x - torch.mean(x, dim=-1, keepdim=True)),
                      dim=-1)
    underflow = (pmax == 0) & (adet > 0) & (adet < 1e-10)
    return torch.isfinite(pmin) & torch.isfinite(pmax) & ~underflow


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
        psd, pmin, pmax = stft_psd(x, fs, cfg, with_stats=True)
        image, words = display_epilogue(psd, pmin, pmax,
                                        log_scale=cfg.log_scale,
                                        share_max=share_max,
                                        flip_image=flip_image,
                                        colormap=colormap, palette=palette,
                                        with_image=with_image)
        out = {"psd": psd, "finite": finite_flags(x, pmin, pmax)}
        if with_image:
            out["image"] = image
        if palette:
            out["index_packed"] = words
        elif colormap:
            out["rgb_packed"] = words
        return out

    return fn
