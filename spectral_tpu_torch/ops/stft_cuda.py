"""Fused STFT/PSD: the CUDA kernel's wrapper and its plain version.

Counterpart of ``spectral_tpu/ops/stft_pallas.py``. The kernel
(``csrc/stft_psd.cu``) replaces ``stft_psd_pallas`` with its ``with_stats``
and ``log10_out`` modes: framing, the window- and detrend-folded real DFT,
|X|² times the one-sided PSD weights, and the per-clip PSD extrema, with no
frame tensor written to memory.

:func:`stft_psd` takes the kernel for a CUDA tensor and the plain version
(:func:`stft_psd_reference`) for a CPU tensor, and only because the tensor
lies on the CPU. On a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from spectral_tpu.config import SpecConfig
from spectral_tpu_torch.core.stft import (dense_power, dft_matrices,
                                          ensure_real_waveform, frame_signal,
                                          num_frames, onesided_weights)
from spectral_tpu_torch.ops import build

KERNEL = "stft_psd"
MAX_NPERSEG = 1024
MAX_CLIPS = 65535            # the grid's z extent

launches = 0                 # kernel launches, for run-time proof of the path


class DftConstants(NamedTuple):
    """The kernel's operands: folded DFT matrices (K, F) and weights (F,)."""
    a_re: torch.Tensor
    a_im: torch.Tensor
    wts: torch.Tensor


def unsupported_reason(cfg: SpecConfig) -> Optional[str]:
    """Why the kernel cannot compute cfg (naming the ROADMAP item that will
    bring it), or None when it can."""
    if cfg.mode != "psd" or cfg.center or cfg.nfft_ != cfg.nperseg:
        return ("the STFT kernel computes uncentered PSD with nfft == "
                "nperseg; other modes arrive with ROADMAP queue 1 item 8 "
                "(the extended modes)")
    if cfg.n_mels is not None or cfg.fmin is not None or cfg.fmax is not None:
        return ("the mel branch and the fmin/fmax band mask arrive with "
                "ROADMAP queue 1 item 5 (the rest of the main-path pipeline)")
    if cfg.nperseg > MAX_NPERSEG:
        return (f"nperseg {cfg.nperseg} > {MAX_NPERSEG}: larger transforms "
                "arrive with ROADMAP queue 1 item 8 (nperseg 2048-8192, "
                "queue 2 K2)")
    return None


def kernel_supported(cfg: SpecConfig) -> bool:
    """The semantic conditions of the JAX package's ``pallas_supported``
    (nfft == nperseg, PSD mode, uncentered, no mel, no band mask), plus
    nperseg <= 1024 until larger sizes are checked on the card."""
    return unsupported_reason(cfg) is None


def check_supported(cfg: SpecConfig) -> None:
    reason = unsupported_reason(cfg)
    if reason is not None:
        raise NotImplementedError(reason)


def constants_from_numpy(a_re: np.ndarray, a_im: np.ndarray,
                         wts: np.ndarray, device,
                         dtype: torch.dtype = torch.float32) -> DftConstants:
    """Host f64 constants (``dft_matrices(cfg)``, ``onesided_weights(cfg,
    fs)`` of either package) -> the kernel's operands on ``device``. The
    numpy arrays are copied, never shared."""
    def put(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return DftConstants(put(a_re), put(a_im), put(wts))


_CONSTANTS: dict = {}


def dft_constants(cfg: SpecConfig, fs: float, device,
                  dtype: torch.dtype = torch.float32) -> DftConstants:
    """The operands for (cfg, fs), cached per device and dtype."""
    key = (cfg, float(fs), str(torch.device(device)), dtype)
    consts = _CONSTANTS.get(key)
    if consts is None:
        a_re, a_im = dft_matrices(cfg)
        consts = constants_from_numpy(a_re, a_im, onesided_weights(cfg, fs),
                                      device, dtype)
        _CONSTANTS[key] = consts
    return consts


def _empty_result(B: int, F: int, like: torch.Tensor, with_stats: bool):
    empty = like.new_zeros((B, 0, F))
    if with_stats:
        return empty, like.new_zeros(B), like.new_zeros(B)
    return empty


def stft_psd_reference(x: torch.Tensor, consts: DftConstants,
                       cfg: SpecConfig, *, log10_out: bool = False,
                       with_stats: bool = False):
    """The plain version of the kernel: (B, n) -> (B, T, F) PSD, plus
    (pmin, pmax) of shape (B,) under with_stats (NaN-propagating, like
    jnp.min/jnp.max). Computes in x's dtype on x's device."""
    B = x.shape[0]
    if num_frames(x.shape[-1], cfg.nperseg, cfg.hop_) <= 0:
        return _empty_result(B, cfg.n_freqs, x, with_stats)
    p = dense_power(frame_signal(x, cfg.nperseg, cfg.hop_),
                    consts.a_re.to(x.dtype), consts.a_im.to(x.dtype),
                    consts.wts.to(x.dtype))
    if log10_out:
        p = torch.log10(p + 1e-20)
    if with_stats:
        return p, torch.amin(p, dim=(1, 2)), torch.amax(p, dim=(1, 2))
    return p


def _library() -> ctypes.CDLL:
    lib = build.load_library(KERNEL)
    if lib.stft_psd_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.stft_psd_launch.argtypes = [ptr] * 7 + [
            i32, ctypes.c_longlong, i32, i32, i32, i32, i32, i32, ptr]
        lib.stft_psd_launch.restype = i32
        lib.stft_psd_partials.argtypes = [i32, i32]
        lib.stft_psd_partials.restype = i32
        lib.stft_psd_error_string.argtypes = [i32]
        lib.stft_psd_error_string.restype = ctypes.c_char_p
    return lib


def _stft_psd_cuda(x: torch.Tensor, fs: float, cfg: SpecConfig,
                   log10_out: bool, with_stats: bool):
    global launches
    lib = _library()
    if x.dtype != torch.float32:
        raise TypeError(f"the STFT kernel computes in float32, got {x.dtype}; "
                        "cast the waveform explicitly")
    if x.device.type != "cuda":
        raise ValueError(f"the STFT kernel takes CUDA tensors, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("the STFT kernel needs a contiguous (B, n) waveform")
    B, n = x.shape
    if B > MAX_CLIPS:
        raise ValueError(f"at most {MAX_CLIPS} clips per launch, got {B}")
    T = num_frames(n, cfg.nperseg, cfg.hop_)
    F = cfg.n_freqs
    if T <= 0:
        return _empty_result(B, F, x, with_stats)
    consts = dft_constants(cfg, fs, x.device)
    out = torch.empty((B, T, F), dtype=torch.float32, device=x.device)
    parts = (torch.empty((2, B, lib.stft_psd_partials(T, F)),
                         dtype=torch.float32, device=x.device)
             if with_stats else None)
    with torch.cuda.device(x.device):
        err = lib.stft_psd_launch(
            x.data_ptr(), consts.a_re.data_ptr(), consts.a_im.data_ptr(),
            consts.wts.data_ptr(), out.data_ptr(),
            parts[0].data_ptr() if with_stats else None,
            parts[1].data_ptr() if with_stats else None,
            B, n, T, F, cfg.nperseg, cfg.hop_, int(log10_out),
            int(with_stats), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("stft_psd kernel launch failed: "
                           + lib.stft_psd_error_string(err).decode())
    launches += 1
    if with_stats:
        return out, torch.amin(parts[0], dim=1), torch.amax(parts[1], dim=1)
    return out


def stft_psd(x, fs: float, cfg: SpecConfig, *, log10_out: bool = False,
             with_stats: bool = False):
    """Fused PSD spectrogram: (n,) or (B, n) -> (B?, T, F) float32.

    with_stats=True also returns each clip's PSD min and max, (B?,) each,
    NaN-propagating, for ``core.scale.normalize_from_stats``; it cannot be
    combined with log10_out. A config outside :func:`kernel_supported`
    raises NotImplementedError on every device."""
    if with_stats and log10_out:
        raise ValueError("with_stats computes linear-PSD extrema; "
                         "combine with log10_out is unsupported")
    check_supported(cfg)
    x = ensure_real_waveform(x)
    if x.ndim == 1:
        out = stft_psd(x[None], fs, cfg, log10_out=log10_out,
                       with_stats=with_stats)
        return tuple(o[0] for o in out) if with_stats else out[0]
    if x.ndim != 2:
        raise ValueError(f"expected a (n,) or (B, n) waveform, got {x.ndim}-D")
    if x.device.type == "cpu":
        return stft_psd_reference(x, dft_constants(cfg, fs, x.device,
                                                   x.dtype), cfg,
                                  log10_out=log10_out, with_stats=with_stats)
    return _stft_psd_cuda(x, fs, cfg, log10_out, with_stats)
