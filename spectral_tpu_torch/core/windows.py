"""Window functions.

The reference relies on scipy's default window for ``scipy.signal.spectrogram``
(PlotEngine.py:113): a *periodic* Tukey window with alpha = 0.25. The north-star
configs additionally need Hann / Hamming. Windows are built host-side in float64
with numpy (they are folded into the host DFT constants), matching
scipy.signal.get_window numerically.

The port's own copy of ``spectral_tpu/core/windows.py``, unchanged in its
arithmetic, so both packages build bitwise-identical windows.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np

WindowSpec = Union[str, Tuple[str, float]]


def _hann_sym(M: int) -> np.ndarray:
    if M == 1:
        return np.ones(1)
    n = np.arange(M, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (M - 1))


def _hamming_sym(M: int) -> np.ndarray:
    if M == 1:
        return np.ones(1)
    n = np.arange(M, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (M - 1))


def _blackman_sym(M: int) -> np.ndarray:
    if M == 1:
        return np.ones(1)
    n = np.arange(M, dtype=np.float64)
    fac = 2.0 * np.pi * n / (M - 1)
    return 0.42 - 0.5 * np.cos(fac) + 0.08 * np.cos(2.0 * fac)


def _bartlett_sym(M: int) -> np.ndarray:
    if M == 1:
        return np.ones(1)
    n = np.arange(M, dtype=np.float64)
    return 1.0 - np.abs(2.0 * n / (M - 1) - 1.0)


def _tukey_sym(M: int, alpha: float) -> np.ndarray:
    """Tukey (tapered cosine) window, symmetric, matching scipy.signal.windows.tukey."""
    if M == 1:
        return np.ones(1)
    if alpha <= 0:
        return np.ones(M, dtype=np.float64)
    if alpha >= 1.0:
        return _hann_sym(M)
    n = np.arange(0, M, dtype=np.float64)
    width = int(math.floor(alpha * (M - 1) / 2.0))
    n1 = n[0:width + 1]
    n3 = n[M - width - 1:]
    w1 = 0.5 * (1.0 + np.cos(np.pi * (-1.0 + 2.0 * n1 / alpha / (M - 1))))
    # middle section: indices (width+1) .. (M-width-2) inclusive
    w2 = np.ones(max(M - 2 * width - 2, 0), dtype=np.float64)
    w3 = 0.5 * (1.0 + np.cos(np.pi * (-2.0 / alpha + 1.0 + 2.0 * n3 / alpha / (M - 1))))
    return np.concatenate([w1, w2, w3])


def _cosine_sum_sym(coeffs):
    """Cosine-sum window family (blackman-harris, nuttall, flattop...)."""
    def build(M: int) -> np.ndarray:
        if M == 1:
            return np.ones(1)
        n = np.arange(M, dtype=np.float64)
        fac = 2.0 * np.pi * n / (M - 1)
        w = np.zeros(M, dtype=np.float64)
        for k, a in enumerate(coeffs):
            w += ((-1.0) ** k) * a * np.cos(k * fac)
        return w
    return build


_SYM_BUILDERS = {
    "boxcar": lambda M: np.ones(M, dtype=np.float64),
    "rect": lambda M: np.ones(M, dtype=np.float64),
    "hann": _hann_sym,
    "hanning": _hann_sym,
    "hamming": _hamming_sym,
    "blackman": _blackman_sym,
    "bartlett": _bartlett_sym,
    # scipy coefficient sets
    "blackmanharris": _cosine_sum_sym(
        [0.35875, 0.48829, 0.14128, 0.01168]),
    "nuttall": _cosine_sum_sym(
        [0.3635819, 0.4891775, 0.1365995, 0.0106411]),
    "flattop": _cosine_sum_sym(
        [0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368]),
}


def parse_window(window: WindowSpec):
    """Normalize a window spec to (name, param); param is None when the spec
    carries no parameter. 'tukey:0.25' style also accepted."""
    if isinstance(window, tuple):
        name, param = window
        # a None param means "no parameter" (same as a bare name), so the
        # parameterized branches can raise their friendly errors instead of
        # float(None) blowing up with an opaque TypeError here
        return str(name).lower(), (None if param is None else float(param))
    name = str(window).lower()
    if ":" in name:
        base, param = name.split(":", 1)
        return base, float(param)
    return name, None


def get_window(window: WindowSpec, M: int, periodic: bool = True) -> np.ndarray:
    """Build a window of length M (float64).

    periodic=True matches scipy.signal.get_window(..., fftbins=True), which is
    what scipy.signal.spectrogram uses internally: the symmetric window of
    length M+1 with the last sample dropped.
    """
    name, param = parse_window(window)
    L = M + 1 if periodic and M > 1 else M

    if name == "tukey":
        # no parameter -> scipy's spectrogram default alpha 0.25; an
        # explicit alpha (including 0 = boxcar) is honored as given
        w = _tukey_sym(L, 0.25 if param is None else param)
    elif name == "kaiser":
        if param is None:
            raise ValueError("kaiser window requires a beta parameter, "
                             "e.g. ('kaiser', 14.0)")
        w = np.kaiser(L, param)
    elif name in _SYM_BUILDERS:
        w = _SYM_BUILDERS[name](L)
    else:
        raise ValueError(f"unknown window: {window!r}")

    if periodic and M > 1:
        w = w[:-1]
    return np.ascontiguousarray(w, dtype=np.float64)
