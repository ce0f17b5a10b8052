"""Parameter-sweep grids: many (nperseg, hop, window) combos on one signal.

Counterpart of ``spectral_tpu/parallel/sweep_grid.py`` (BASELINE.json
config 3: "16 combos of (n_fft in 256..4096, hop, window fn) over one
clip"). The signal is uploaded to the card once and shared by every
config; each config is one launch of its route's STFT kernel on that
buffer (``ops/stft_cuda.py``), which folds the window and the detrend into
its own transform, so the JAX package's window-stacked DFT matrices and
its Cooley-Tukey engine have no counterpart here. On a CPU tensor each
config runs the kernel's plain version.

Centered configs pad the shared buffer on the card once a pad
(``core.stft.center_pad``, keyed by nperseg // 2 and the pad mode), as
the JAX package pads once a group, and launch on the padded buffer;
nperseg past 32,768 (ROADMAP [large-nperseg]) raises NotImplementedError.
A config with nfft > nperseg runs on the route of its nfft.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from spectral_tpu_torch.config import SpecConfig
from spectral_tpu_torch.core.stft import (center_pad, ensure_real_waveform,
                                          power_spectrogram)
from spectral_tpu_torch.ops.stft_cuda import check_supported
from spectral_tpu_torch.utils.device import DeviceLike, resolve_device


def _shape_key(cfg: SpecConfig) -> Tuple:
    # the JAX package's group key: configs that differ only in the window
    # give PSDs of one shape (the grid's groups, which the card's timing
    # reports one by one)
    return (cfg.nperseg, cfg.hop_, cfg.nfft_, cfg.detrend, cfg.scaling,
            cfg.center, cfg.pad_mode, cfg.onesided, cfg.precision)


def sweep_grid(x, fs: float, configs: Sequence[SpecConfig],
               device: DeviceLike = "cuda") -> List[torch.Tensor]:
    """Compute PSD spectrograms for every config over one signal (..., n).

    Returns one frame-major PSD tensor (..., T, F) per config, in the
    configs' order, on the device: the card unless ``device='cpu'`` (a
    CUDA signal's own). The signal is put there once; each config is one
    launch of its route's kernel, whose result is bitwise
    ``power_spectrogram`` of that config. A non-PSD mode raises the JAX
    package's ValueError; a config the kernels cannot compute (nperseg >
    32,768) raises NotImplementedError naming its ROADMAP item, before any
    work."""
    for cfg in configs:
        if cfg.mode != "psd":
            # the fused (re^2 + im^2) * weights form IS the PSD; magnitude/
            # complex configs would silently get PSD values back
            raise ValueError("sweep_grid supports mode='psd' configs only")
        check_supported(cfg)
    x = ensure_real_waveform(x)
    if not x.is_cuda:
        dev = resolve_device(device)
        if dev.type != "cpu":
            x = x.to(dev, torch.float32)
    padded: Dict[Tuple, torch.Tensor] = {}
    out = []
    for cfg in configs:
        if not cfg.center:
            out.append(power_spectrogram(x, fs, cfg))
            continue
        key = (cfg.nperseg // 2, cfg.pad_mode)
        if key not in padded:
            padded[key] = center_pad(x, cfg)
        out.append(power_spectrogram(padded[key], fs,
                                     dataclasses.replace(cfg, center=False)))
    return out


def default_grid(n_ffts=(256, 1024, 2048, 4096),
                 windows=("hann", "hamming", ("tukey", 0.25), "blackman"),
                 hop_divisor: int = 4) -> List[SpecConfig]:
    """The 16-combo north-star grid: n_fft x window, hop = n_fft / divisor.

    Spans the full BASELINE.json config-3 range "n_fft in 256..4096"."""
    out = []
    for n in n_ffts:
        for w in windows:
            out.append(SpecConfig(nperseg=n, hop=n // hop_divisor, window=w,
                                  detrend="none"))
    return out
