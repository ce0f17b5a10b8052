"""Mel filterbank and its plain projection, in PyTorch.

Counterpart of ``spectral_tpu/core/mel.py``. The reference has no mel path
(it masks linear-frequency PSD rows, PlotEngine.py:114-115); the
north-star configs (BASELINE.json config 2: 128-bin mel spectrograms)
need one. The filterbank is a host (n_mels, n_freqs) float64 matrix:
HTK mel (2595 log10(1 + f/700)) or Slaney's (linear below 1 kHz, log
above) with Slaney's area normalization, the conventions of librosa and
torchaudio.

:func:`hz_to_mel`, :func:`mel_to_hz`, :func:`mel_centers` and
:func:`mel_filterbank` are the JAX package's numpy float64 code, unchanged
(that module imports jax, so the port keeps its own copy), so both
packages start from bitwise-identical filterbanks. :func:`apply_mel` is
the plain version of the mel projection kernel (``ops.mel_cuda``): a
float64 product, rounded once to the PSD's dtype.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


def hz_to_mel(f, htk: bool = False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1000 Hz (mel = 3f/200), log above
    f_min, f_sp = 0.0, 200.0 / 3.0
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = f >= min_log_hz
    mels = np.where(above, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def mel_to_hz(m, htk: bool = False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3.0
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = m >= min_log_mel
    freqs = np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)
    return freqs


def mel_centers(n_mels: int, fs: float, fmin: float = 0.0,
                fmax: Optional[float] = None, htk: bool = False
                ) -> np.ndarray:
    """Center frequencies (Hz) of the mel filters — the frequency axis a
    mel spectrogram is plotted/masked against (api/session.py uses it as
    last_f for mel plots)."""
    mel_max = fmax if fmax is not None else fs / 2.0
    pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(mel_max, htk),
                      n_mels + 2)
    return mel_to_hz(pts[1:-1], htk)


@functools.lru_cache(maxsize=32)
def mel_filterbank(n_mels: int, n_freqs: int, fs: float, fmin: float = 0.0,
                   fmax: Optional[float] = None, htk: bool = False,
                   norm: bool = True) -> np.ndarray:
    """Triangular mel filterbank, shape (n_mels, n_freqs), float64.

    n_freqs = nfft//2 + 1 bins spanning [0, fs/2]. norm=True applies Slaney
    area normalization (2 / bandwidth).
    """
    if fmax is None:
        fmax = fs / 2.0
    # a degenerate or out-of-range mel span would otherwise produce NaN
    # (Slaney enorm = 2/0) or silently all-zero top filters (triangles
    # entirely above Nyquist, where no FFT bins exist)
    if fmin < 0:
        raise ValueError("mel fmin must be >= 0")
    if fmax <= fmin:
        raise ValueError(f"mel fmax ({fmax}) must be greater than "
                         f"fmin ({fmin})")
    if fmax > fs / 2.0 + 1e-9:
        raise ValueError(f"mel fmax ({fmax}) exceeds Nyquist ({fs / 2.0})")
    fft_freqs = np.linspace(0.0, fs / 2.0, n_freqs)

    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)

    fb = np.zeros((n_mels, n_freqs), dtype=np.float64)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    for m in range(n_mels):
        lower = -ramps[m] / max(fdiff[m], 1e-12)
        upper = ramps[m + 2] / max(fdiff[m + 1], 1e-12)
        fb[m] = np.maximum(0.0, np.minimum(lower, upper))
    if norm:
        enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
        fb *= enorm[:, None]
    return fb


def apply_mel(psd: torch.Tensor, fb) -> torch.Tensor:
    """Apply a mel filterbank (M, F) to a frame-major PSD: (..., T, F) ->
    (..., T, M) in psd's dtype.

    The product is float64 (so TF32 never enters), every bin times every
    weight as the JAX package's dense product does, so a non-finite bin
    where a weight is zero makes that row NaN (0 * inf), and it is rounded
    once to psd's dtype. fb is a numpy array or a tensor."""
    fbt = torch.as_tensor(fb, dtype=torch.float64, device=psd.device)
    return torch.matmul(psd.double(), fbt.T).to(psd.dtype)


def mel_spectrogram(psd: torch.Tensor, fs: float, n_mels: int,
                    fmin: float = 0.0, fmax: Optional[float] = None,
                    htk: bool = False) -> torch.Tensor:
    """Frame-major PSD (..., T, F) -> mel spectrogram (..., T, n_mels)."""
    n_freqs = psd.shape[-1]
    fb = mel_filterbank(n_mels, n_freqs, fs, fmin, fmax, htk)
    return apply_mel(psd, fb)
