"""Spectrogram configuration.

The reference threads a per-plot ``settings`` dict with keys
``{combine, draw_raw, draw_proc, mode_raw, mode_proc, nperseg, fmin, fmax, log_scale}``
(assembled at GUI.py:421-431, consumed at PlotEngine.py:112 and :96-98) plus the
implicit scipy defaults of ``scipy.signal.spectrogram`` (PlotEngine.py:113):
Tukey(0.25) periodic window, noverlap = nperseg // 8, nfft = nperseg,
detrend='constant', scaling='density', mode='psd', one-sided.

Here that becomes one frozen (hashable) dataclass covering both the
scipy-compatible mode and a generalized mode (explicit hop, hann/hamming/...,
optional mel filterbank, optional center padding).

The port's own copy of ``spectral_tpu/config.py`` (``SpecConfig`` and
``ViewSettings``): the same fields, defaults, validation and JSON form, so
a config serialized by one package loads in the other
(``SpecConfig.from_json(cfg.to_json())``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple, Union

# A window is either a name ("hann") or a (name, param) pair ("tukey", 0.25).
WindowSpec = Union[str, Tuple[str, float]]


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Static configuration for STFT / spectrogram computation.

    Hashable and immutable so it can be passed as a jit static argument.
    """

    nperseg: int = 1024
    # hop between frame starts. None => scipy default: nperseg - nperseg // 8
    # (scipy noverlap default is nperseg // 8; PlotEngine.py:113 uses defaults).
    hop: Optional[int] = None
    nfft: Optional[int] = None  # None => nperseg (scipy default: no zero padding)
    window: WindowSpec = ("tukey", 0.25)  # scipy.signal.spectrogram default
    detrend: str = "constant"  # 'constant' | 'none' (scipy default: 'constant')
    scaling: str = "density"  # 'density' | 'spectrum'
    mode: str = "psd"  # 'psd' | 'magnitude' | 'complex'
    onesided: bool = True
    # Generalized (librosa-style) framing: pad so frame k is centered at k*hop.
    # scipy-compat mode (the reference) uses center=False with no padding.
    center: bool = False
    pad_mode: str = "reflect"  # used only when center=True
    # Frequency band mask applied to rows before normalization
    # (PlotEngine.py:114-115). None = no mask.
    fmin: Optional[float] = None
    fmax: Optional[float] = None
    # Display post-processing (PlotEngine.py:126-131).
    log_scale: bool = False
    # Optional mel filterbank (north-star extension; absent in the reference).
    n_mels: Optional[int] = None
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None  # None => fs / 2
    mel_htk: bool = False  # False => Slaney-style mel + normalization
    # Precision tier: 'accurate' (the 1e-3 dB display contract) or 'fast'
    # (a display-only tier). The port runs both at the contract precision,
    # as the JAX package's Pallas kernel does, until the fast tier lands
    # (ROADMAP [fast-tier]).
    precision: str = "accurate"

    def __post_init__(self):
        if isinstance(self.window, list):  # defensive: keep hashable
            object.__setattr__(self, "window", tuple(self.window))
        if self.detrend not in ("constant", "linear", "none"):
            raise ValueError(f"unsupported detrend: {self.detrend!r}")
        if self.scaling not in ("density", "spectrum"):
            raise ValueError(f"unsupported scaling: {self.scaling!r}")
        if self.mode not in ("psd", "magnitude", "complex"):
            raise ValueError(f"unsupported mode: {self.mode!r}")
        if self.nperseg < 1:
            raise ValueError("nperseg must be >= 1")
        if self.precision not in ("accurate", "fast"):
            # a typo here must not silently select the bf16 display tier:
            # stft.matmul_precision branches on == 'accurate'
            raise ValueError(f"unsupported precision: {self.precision!r} "
                             "(expected 'accurate' or 'fast')")
        # validate the window eagerly so bad configs fail at construction.
        # One source of truth: actually build a tiny window through the same
        # code path the STFT uses — any spec get_window cannot construct
        # (unknown name, missing kaiser beta, non-numeric param) raises its
        # friendly error here instead of mid-compute.
        from spectral_tpu_torch.core import windows as _w
        _w.get_window(self.window, 8)
        if self.n_mels is not None:
            if self.n_mels < 1:
                raise ValueError("n_mels must be >= 1")
            if self.mel_fmin < 0:
                raise ValueError("mel_fmin must be >= 0")
            if self.mel_fmax is not None and self.mel_fmax <= self.mel_fmin:
                raise ValueError("mel_fmax must be greater than mel_fmin")
        if self.hop is not None and self.hop < 1:
            raise ValueError("hop must be >= 1")
        if self.nfft is not None and self.nfft < self.nperseg:
            # scipy raises the same way; without this, rfft(n=nfft) would
            # silently CROP each windowed frame and return wrong PSDs
            raise ValueError("nfft must be greater than or equal to nperseg")

    # ---- derived quantities ------------------------------------------------

    @property
    def noverlap_(self) -> int:
        return self.nperseg - self.hop_

    @property
    def hop_(self) -> int:
        if self.hop is not None:
            return self.hop
        # scipy.signal.spectrogram default: noverlap = nperseg // 8
        return self.nperseg - self.nperseg // 8

    @property
    def nfft_(self) -> int:
        return self.nfft if self.nfft is not None else self.nperseg

    @property
    def n_freqs(self) -> int:
        return self.nfft_ // 2 + 1 if self.onesided else self.nfft_

    # ---- constructors ------------------------------------------------------

    @classmethod
    def scipy_default(cls, nperseg: int = 1024, *, fmin: Optional[float] = None,
                      fmax: Optional[float] = None, log_scale: bool = False,
                      **kw) -> "SpecConfig":
        """The reference's exact configuration (PlotEngine.py:113 defaults)."""
        return cls(nperseg=nperseg, hop=None, window=("tukey", 0.25),
                   detrend="constant", scaling="density", mode="psd",
                   fmin=fmin, fmax=fmax, log_scale=log_scale, **kw)

    @classmethod
    def north_star(cls, n_fft: int = 1024, hop: int = 256,
                   window: WindowSpec = "hann", **kw) -> "SpecConfig":
        """BASELINE.json config-1 style: Hann, explicit hop, no detrend."""
        return cls(nperseg=n_fft, hop=hop, window=window, detrend="none", **kw)

    # ---- (de)serialization (replaces the reference's QSettings persistence,
    #       GUI.py:190-224, for headless use) ---------------------------------

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        if isinstance(d["window"], tuple):
            d["window"] = list(d["window"])
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "SpecConfig":
        d = json.loads(s)
        if isinstance(d.get("window"), list):
            d["window"] = tuple(d["window"])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ViewSettings:
    """The non-numeric half of the reference's per-plot settings dict
    (GUI.py:421-431): which signals to draw / combine and how."""

    combine: bool = False
    draw_raw: bool = True
    draw_proc: bool = True
    mode_raw: str = "Signal"  # 'Signal' | 'Spectrogram' | 'Both'
    mode_proc: str = "Signal"
