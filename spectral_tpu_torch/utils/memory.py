"""Bounded-memory guard for long-lived processes.

Counterpart of ``spectral_tpu/utils/memory.py``: the same RSS reading,
threshold and hysteresis; only what a trim drops differs. JAX caches one
compiled executable per (program, shape); the port compiles nothing at
run time, and what grows instead is its per-config caches: the STFT
kernels' operands on each device (``ops/stft_cuda._CONSTANTS``, least
recently used first out past ``stft_cuda.CONSTANTS_BUDGET`` bytes a
device: a (nperseg, nfft // 2 + 1) float64 pair of matrices per config
on the GEMM route and in the other routes' plain versions, 33.6 MB at
nperseg 1024 and nfft 4096, 537 MB at 8192), the host constants behind
them (the ``lru_cache``s of ``core/stft.py`` and ``core/mel.py``) and
the packed colormaps (``ops/colormap.py``), plus the blocks PyTorch's
CUDA allocator keeps for reuse. A worker serving ever-new configs grows
through them up to those bounds.

``maybe_trim_caches`` is the backstop: when RSS crosses a threshold it
drops them all; the next call of each config rebuilds its constants (host
work of milliseconds to seconds at nperseg 8192, no kernel rebuild) and
memory is bounded. Wired into the serve worker per request (cli.py) and
the session after each plot and detection (api/session.py); threshold
from SPECTRAL_TPU_MAX_RSS_MB (0/unset = disabled for the session path;
serve defaults to 8192).
"""

from __future__ import annotations

import os
from typing import Optional

_ENV = "SPECTRAL_TPU_MAX_RSS_MB"


def rss_mb() -> float:
    """Resident set size of this process in MB (Linux)."""
    try:
        with open(f"/proc/{os.getpid()}/status") as fh:
            for line in fh:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024.0
    except OSError:  # pragma: no cover - non-Linux
        pass
    return 0.0


def env_threshold_mb() -> float:
    """The SPECTRAL_TPU_MAX_RSS_MB threshold; 0 = disabled."""
    try:
        return float(os.environ.get(_ENV, "0") or 0)
    except ValueError:
        return 0.0


def trim_caches() -> None:
    """Drop every per-config cache of the port: the STFT kernels' device
    operands, the host constants behind them, the filterbanks and the
    packed colormaps, then the CUDA allocator's cached blocks where CUDA
    is initialised. Tensors a caller still holds stay valid: a cache
    drops its references only."""
    import torch
    from spectral_tpu_torch.core import mel, stft
    from spectral_tpu_torch.ops import colormap, stft_cuda
    stft_cuda._CONSTANTS.clear()
    for fn in (stft._window_f64, stft.dft_matrices, stft.fft_twiddles,
               stft.fft_plan, stft.bluestein_plan, stft.bluestein_split_plan,
               mel.mel_filterbank,
               colormap._packed_lut_np):
        fn.cache_clear()
    colormap._LUT_CACHE.clear()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


_post_trim_rss = 0.0


def maybe_trim_caches(max_rss_mb: Optional[float] = None) -> bool:
    """Trim when RSS exceeds the threshold. Returns True if trimmed.

    max_rss_mb None -> SPECTRAL_TPU_MAX_RSS_MB (0/unset disables).

    Hysteresis: the allocator may not return freed pages to the OS, so
    RSS can sit above the threshold right after a trim. Re-trimming then
    would rebuild every config's constants per call for zero benefit —
    after a trim, the next one fires only once RSS exceeds BOTH the
    threshold and 110% of the post-trim level (i.e. the caches
    demonstrably grew again).
    """
    global _post_trim_rss
    limit = env_threshold_mb() if max_rss_mb is None else max_rss_mb
    if not limit or limit <= 0:
        return False
    now = rss_mb()
    if now <= limit or now <= _post_trim_rss * 1.1:
        return False
    trim_caches()
    _post_trim_rss = rss_mb()
    return True
