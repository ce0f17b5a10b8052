"""STFT / power-spectral-density core in PyTorch: host constants and the
plain dense route.

Counterpart of the host and plain half of ``spectral_tpu/core/stft.py``.
The numerical contract is the same: ``scipy.signal.spectrogram(...,
scaling="density", mode="psd")`` (PlotEngine.py:113), computed as two real
GEMMs against DFT matrices with the window and the detrend folded in.

The host constants (window, PSD weights, axes, folded DFT matrices) are the
JAX package's numpy f64 code, unchanged, over the port's own copy of the
windows, so both packages start from bitwise-identical constants; the FFT
kernels' twiddle tables and plans (:func:`fft_twiddles`, :func:`fft_plan`,
:func:`bluestein_plan`) are the port's own. Framing is a
``Tensor.unfold`` view; the JAX package's gcd slice-and-concat framing
works around the TPU compiler and has no counterpart here.

What this module computes on a CPU tensor is the plain version of the CUDA
STFT/PSD kernel (``spectral_tpu_torch.ops.stft_cuda``); on a CUDA tensor
its PSD entry points launch that kernel. The reference-parity entry point
:func:`spectrogram` and the band mask (:func:`band_row_slice`,
:func:`mask_band_rows`, :func:`effective_config`) are the JAX package's.
The centered framing and the non-PSD modes raise until their ROADMAP
item.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import warnings
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from spectral_tpu_torch.config import SpecConfig
from spectral_tpu_torch.core.windows import get_window


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------

def num_frames(n: int, nperseg: int, hop: int) -> int:
    """Number of complete frames (scipy boundary=None: trailing rest dropped)."""
    if n < nperseg:
        return 0
    return (n - nperseg) // hop + 1


def ensure_real_waveform(x) -> torch.Tensor:
    """Coerce a waveform to a real float tensor of at least 32 bits.

    Array-likes are accepted. bool, integer and sub-32-bit float inputs
    (int16 PCM, float16, bfloat16) promote to float32 before any arithmetic;
    float32 and float64 pass through. Complex and 0-d inputs are refused,
    as in the JAX package."""
    x = torch.as_tensor(x)
    if x.ndim == 0:
        raise ValueError("waveform must have at least one axis (got a "
                         "scalar); pass a 1-D signal or a (..., n) batch")
    if x.is_complex():
        raise ValueError(
            f"real-valued waveform required, got {x.dtype} (complex "
            "STFT output is cfg.mode='complex'; complex inputs are not "
            "supported)")
    if not x.is_floating_point() or torch.finfo(x.dtype).bits < 32:
        x = x.to(torch.float32)
    return x


def frame_signal(x, nperseg: int, hop: int) -> torch.Tensor:
    """Overlapping frames as a view: (..., n) -> (..., nframes, nperseg)."""
    x = ensure_real_waveform(x)
    if num_frames(x.shape[-1], nperseg, hop) <= 0:
        return x.new_zeros(x.shape[:-1] + (0, nperseg))
    return x.unfold(-1, nperseg, hop)


# ---------------------------------------------------------------------------
# Window / scaling constants (host-side, float64)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _window_f64(cfg: SpecConfig) -> np.ndarray:
    return get_window(cfg.window, cfg.nperseg, periodic=True)


def _require_fs(fs: float) -> float:
    """Reject nonpositive / non-finite sampling rates: every fs formula
    divides by it."""
    try:
        f = float(fs)
    except (TypeError, ValueError):
        raise ValueError(
            f"sampling rate must be a positive finite number, got {fs!r}")
    if not (math.isfinite(f) and f > 0):
        raise ValueError(
            f"sampling rate must be a positive finite number, got {fs!r}")
    return f


def psd_scale(cfg: SpecConfig, fs: float) -> float:
    """Scalar PSD scale: 'density' -> 1/(fs*sum(w^2)); 'spectrum' -> 1/sum(w)^2."""
    fs = _require_fs(fs)
    w = _window_f64(cfg)
    if cfg.scaling == "density":
        return float(1.0 / (fs * np.sum(w * w)))
    return float(1.0 / (np.sum(w) ** 2))


def onesided_weights(cfg: SpecConfig, fs: float) -> np.ndarray:
    """Per-bin multiplier combining the PSD scale and scipy's one-sided
    doubling of interior bins (DC, and Nyquist for even nfft, not doubled)."""
    scale = psd_scale(cfg, fs)
    nb = cfg.n_freqs
    wts = np.full(nb, scale, dtype=np.float64)
    if cfg.onesided and cfg.mode == "psd":
        if cfg.nfft_ % 2 == 0:
            wts[1:-1] *= 2.0
        else:
            wts[1:] *= 2.0
    return wts


def freq_axis(cfg: SpecConfig, fs: float) -> np.ndarray:
    """Frequency bin centers (np.fft.rfftfreq semantics)."""
    fs = _require_fs(fs)
    if cfg.onesided:
        return np.fft.rfftfreq(cfg.nfft_, d=1.0 / fs)
    return np.fft.fftfreq(cfg.nfft_, d=1.0 / fs)


def time_axis(cfg: SpecConfig, fs: float, n: int) -> np.ndarray:
    """Frame-center times: t[k] = (nperseg/2 + k*hop)/fs (scipy spectrogram);
    k*hop/fs when center=True."""
    fs = _require_fs(fs)
    nf = num_frames(n + (2 * (cfg.nperseg // 2) if cfg.center else 0),
                    cfg.nperseg, cfg.hop_)
    k = np.arange(nf, dtype=np.float64)
    if cfg.center:
        return k * cfg.hop_ / fs
    return (cfg.nperseg / 2.0 + k * cfg.hop_) / fs


@functools.lru_cache(maxsize=16)
def dft_matrices(cfg: SpecConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Window-folded real-DFT matrices A_re, A_im of shape (nperseg, n_freqs),
    float64, with the constant or linear detrend projection folded in:

        X_re = f @ A_re,  X_im = f @ A_im
        A[n,k] = w[n] c/s(-2π n k / nfft);  A <- (I - P) A  (detrend)

    The arrays are cached and shared: copy before handing them to torch."""
    N = cfg.nperseg
    nfft = cfg.nfft_
    w = _window_f64(cfg)
    n = np.arange(N, dtype=np.float64)[:, None]
    k = np.arange(cfg.n_freqs, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * n * k / nfft
    a_re = w[:, None] * np.cos(ang)
    a_im = w[:, None] * np.sin(ang)
    if cfg.detrend == "constant":
        a_re = a_re - np.mean(a_re, axis=0, keepdims=True)
        a_im = a_im - np.mean(a_im, axis=0, keepdims=True)
    elif cfg.detrend == "linear":
        ns = np.arange(N, dtype=np.float64)[:, None]
        Q = np.linalg.qr(np.concatenate([np.ones((N, 1)), ns], axis=1))[0]
        a_re = a_re - Q @ (Q.T @ a_re)
        a_im = a_im - Q @ (Q.T @ a_im)
    return np.ascontiguousarray(a_re), np.ascontiguousarray(a_im)


@functools.lru_cache(maxsize=16)
def fft_twiddles(nfft: int) -> np.ndarray:
    """The FFT kernel's twiddle table, stage by stage: (nfft - 1, 2)
    float64 rows (cos, sin), row h - 1 + k holding W_2h^k = exp(-2πi k /
    2h) for k < h, h = 1, 2, 4, ..., nfft / 2 (the radix-2 stage that
    combines values h apart).

    Every row is a row of numpy's table of (cos, sin) of -2π j / nfft,
    j < nfft / 2, at j = k · nfft / 2h, bitwise; the stage order lets the
    kernel's neighbouring threads read neighbouring rows. The array is
    cached and shared: copy before handing it to torch."""
    ang = -2.0 * np.pi * np.arange(nfft // 2, dtype=np.float64) / nfft
    base = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    spans = [1 << b for b in range(nfft.bit_length() - 1)]
    j = np.concatenate([np.arange(h) * (nfft // (2 * h)) for h in spans])
    return np.ascontiguousarray(base[j])


# The largest odd radix the mixed-radix plan gives a direct stage
# (MIX_MAX_RADIX in ops/csrc/stft_psd.cu); a transform length that is a
# prime past it takes a Rader stage instead (:func:`fft_plan`)
MAX_MIXED_RADIX = 255


class FftPlan(NamedTuple):
    """The mixed-radix FFT kernels' plan for nperseg K (:func:`fft_plan`):
    a transform of N points, the N = K/2 packed values of a real frame for
    even K, the N = K values of a complex pair of frames for odd K."""
    stages: np.ndarray         # (S, 4) int32: radix p, span L, twiddle row,
                               # root row of each stage, in stage order; with
                               # a Rader stage, the (N - 1)-point
                               # sub-transform's
    perm: np.ndarray           # (N,) int32: value m goes to slot perm[m];
                               # with a Rader stage also the output map
    twiddles: np.ndarray       # (rows, 2) float64 (cos, sin), stage-ordered
    split: int                 # first of the N split-step rows W_K^g (even
                               # K); -1 for odd K, which has no split step
    rader: int                 # first of the N - 1 rows of the Rader
                               # stage's kernel, in slot order; -1 without
    generator: int             # the Rader stage's primitive root mod N; 0


def fft_radices(m: int) -> Tuple[int, ...]:
    """m's prime factors in the stage order: odd primes descending, then
    the twos."""
    odd = []
    twos = 0
    while m % 2 == 0:
        m //= 2
        twos += 1
    p = 3
    while m > 1:
        while m % p == 0:
            odd.append(p)
            m //= p
        p += 2
    return tuple(sorted(odd, reverse=True)) + (2,) * twos


def transform_length(nfft: int) -> int:
    """The FFT kernels' transform length for nperseg nfft: nfft/2 packed
    values for even nfft, nfft for odd."""
    return nfft // 2 if nfft % 2 == 0 else nfft


def rader_prime(n: int) -> bool:
    """Whether an n-point transform takes a Rader stage: n is a prime past
    :data:`MAX_MIXED_RADIX`."""
    return n > MAX_MIXED_RADIX and fft_radices(n) == (n,)


def plan_radices(nfft: int) -> Tuple[int, ...]:
    """The radices of :func:`fft_plan`'s stages for nperseg nfft: the
    transform length's (:func:`transform_length`) prime factors, or with a
    Rader stage those of the length less one."""
    n = transform_length(nfft)
    return fft_radices(n - 1 if rader_prime(n) else n)


def primitive_root(p: int) -> int:
    """The smallest generator of the multiplicative group mod prime p."""
    qs = set(fft_radices(p - 1))
    return next(g for g in range(2, p)
                if all(pow(g, (p - 1) // q, p) != 1 for q in qs))


def _rows(j, nfft: int) -> np.ndarray:
    """numpy's float64 (cos, sin) of -2π j / nfft, the integer j reduced
    exactly mod nfft."""
    ang = -2.0 * np.pi * (np.asarray(j, np.int64) % nfft) / nfft
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1)


def _dit_plan(n: int, nfft: int):
    """The decimation-in-time stages of an n-point transform (n divides
    nfft), their twiddle and root rows as angles over nfft, and the load
    order: (stages, perm, row blocks, rows)."""
    factors = fft_radices(n)
    blocks, stages, row, L = [], [], 0, 1
    for p in factors:
        q, k = np.meshgrid(np.arange(1, p), np.arange(L), indexing="ij")
        blocks.append(_rows((q * k).ravel() % (L * p) * (nfft // (L * p)),
                            nfft))
        tw_row, row = row, row + (p - 1) * L
        root_row = row
        if p % 2:
            blocks.append(_rows(np.arange(p) * (nfft // p), nfft))
            row += p
        stages.append((p, L, tw_row, root_row))
        L *= p
    perm = np.zeros(n, np.int64)
    m = np.arange(n)
    span = n
    for p in reversed(factors):
        span //= p
        perm += (m % p) * span
        m //= p
    return np.asarray(stages, np.int32).reshape(-1, 4), perm, blocks, row


@functools.lru_cache(maxsize=16)
def fft_plan(nfft: int) -> FftPlan:
    """Host plan of the mixed-radix FFT kernels for nperseg nfft = K: a
    transform of N points (:func:`transform_length`), decimation in time,
    whose stages take N's prime factors in :func:`fft_radices` order (odd
    primes descending, then the twos), stage s of radix p and span L (the
    product of the radices before it) combining p transforms of L points,
    values L apart, into one of L·p points.

    - ``perm``: the load order, the mixed-radix digit reversal: value m
      lands at slot (m mod p_last)·(N/p_last) + the same rule for m div
      p_last over the stages before the last.
    - ``twiddles``: every row is (cos, sin) of -2π j / K for an integer j
      reduced exactly mod K, in numpy float64, unrounded. Stage s holds,
      from row ``stages[s, 2]``, the (p - 1)·L inter-stage twiddles
      W_Lp^(q·k) at row (q - 1)·L + k (q = 1..p-1, k < L), and for an odd
      radix, from row ``stages[s, 3]``, the p roots W_p^i (i < p); for
      even K the last N rows, from row ``split``, are the split step's
      W_K^g, g < N.

    When N is a prime p past :data:`MAX_MIXED_RADIX` (:func:`rader_prime`),
    Rader's algorithm turns its transform into a cyclic convolution of
    length P = p - 1, which the stages above compute. With g the smallest
    primitive root mod p and x_q = x[g^q]:

        X[0] = x[0] + Σ_q x_q,   X[g^j] = x[0] + V[j],
        V = DFT_P(DFT_P(x_q) · b̂),   b̂ = DFT_P(W_p^(g^-q)) / P,

    the inverse transform of the convolution theorem read backwards (V[j]
    is its output at -j). In the kernel, P-point stages of the plan's
    radices run in reverse order transposed (decimation in frequency:
    natural order in, digit-reversed out), the product with b̂ is taken in
    slot order, and the same stages run forwards (digit-reversed in,
    natural out). So ``perm`` maps value n = g^q to slot q and 0 to slot
    P, and is also the output map (X[f] reads slot perm[f], f > 0);
    ``stages`` are the P-point sub-plan's, with rows as angles over P;
    from row ``rader`` the P rows of b̂ in numpy float64 (``np.fft.fft``
    of numpy's cos and sin) sit at slot perm_P[k], perm_P the sub-plan's
    digit reversal; the split rows, for even K, follow.

    No (K, F) matrix is built. The arrays are cached and shared: copy
    before handing them to torch."""
    if nfft < 3:
        raise ValueError(f"the mixed-radix plan needs nfft >= 3, got {nfft}")
    n = transform_length(nfft)
    g = 0
    rader = -1
    if rader_prime(n):
        P = n - 1
        stages, sub_perm, blocks, row = _dit_plan(P, P)
        g = primitive_root(n)
        gq = np.ones(P, np.int64)
        for q in range(1, P):
            gq[q] = gq[q - 1] * g % n
        perm = np.empty(n, np.int64)
        perm[0] = P
        perm[gq] = np.arange(P)
        b = _rows(gq[(-np.arange(P)) % P], n)
        bhat = np.fft.fft(b[:, 0] + 1j * b[:, 1]) / P
        slots = np.empty(P, np.complex128)
        slots[sub_perm] = bhat
        blocks.append(np.stack([slots.real, slots.imag], axis=1))
        rader, row = row, row + P
    else:
        stages, perm, blocks, row = _dit_plan(n, nfft)
    split = -1
    if nfft % 2 == 0:
        blocks.append(_rows(np.arange(n), nfft))
        split = row
    return FftPlan(stages, perm.astype(np.int32),
                   np.ascontiguousarray(np.concatenate(blocks)), split,
                   rader, g)


# The most complex float64 values one block of the Bluestein kernel holds in
# shared memory (BLUE_MAX_BLOCK_POINTS in ops/csrc/stft_psd.cu, the largest
# 2, 3, 5, 7-smooth number whose buffer fits the card's 227 KB beside the
# kernel's static arrays): a convolution longer than this runs on a cluster
# of two blocks, half each
BLUESTEIN_BLOCK_POINTS = 14406
BLUESTEIN_RADICES = (2, 3, 5, 7)


def _smooth(m: int) -> bool:
    """Whether m's prime factors are all in :data:`BLUESTEIN_RADICES`."""
    for p in BLUESTEIN_RADICES:
        while m % p == 0:
            m //= p
    return m == 1


def bluestein_length(n: int) -> int:
    """M, the Bluestein kernel's convolution length for an n-point
    transform: the smallest number >= 2n - 1 whose prime factors are 2, 3,
    5 and 7, or past :data:`BLUESTEIN_BLOCK_POINTS` (a cluster of two
    blocks) the smallest even one, so that the plan's last stage is the
    radix-2 stage that joins the two halves."""
    m = 2 * n - 1
    while not _smooth(m):
        m += 1
    if m > BLUESTEIN_BLOCK_POINTS:
        m += m % 2
        while not _smooth(m):
            m += 2
    return m


class BluesteinPlan(NamedTuple):
    """The Bluestein kernel's plan for nperseg K (:func:`bluestein_plan`):
    an N-point transform (:func:`transform_length`) as a cyclic
    convolution of M points."""
    n: int                     # N, the transform length
    m: int                     # M, the convolution length
    ranks: int                 # blocks that hold the M slots: 1 or 2
    stages: np.ndarray         # (S, 4) int32: M's stages, as in FftPlan
    perm: np.ndarray           # (M,) int32: M's digit reversal; DFT index
                               # j lies at slot perm[j] after the stages
                               # in frequency
    twiddles: np.ndarray       # (rows, 2) float64 (cos, sin)
    bhat: int                  # first of the M rows of b̂, in slot order
    chirp: int                 # first of the N rows of the chirp w_i
    split: int                 # first of the N split-step rows W_K^g (even
                               # K); -1 for odd K


@functools.lru_cache(maxsize=16)
def bluestein_plan(nfft: int) -> BluesteinPlan:
    """Host plan of the Bluestein kernel for nperseg nfft = K: the N-point
    transform of :func:`fft_plan` (N = K/2 packed values, or K for a pair
    of odd frames) for any N, by Bluestein's identity n k = (n² + k² -
    (k - n)²) / 2:

        X[k] = w_k Σ_n (x_n w_n) conj(w_(k-n)),   w_n = exp(-iπ n² / N),

    a cyclic convolution of length M (:func:`bluestein_length`) of a_n =
    x_n w_n (n < N, zero to M) with b, the M-periodic conj(w): b_m =
    conj(w_m) for m < N, b_(M-m) = conj(w_m) for 0 < m < N, else 0. The
    kernel runs M's stages (the generator of :func:`fft_plan`, radices 2,
    3, 5 and 7) in frequency (natural order in, digit-reversed out), takes
    each slot times its row of b̂ (numpy's float64 DFT of b, times 1/M,
    laid out at slot perm[j]) and conjugates it, runs the stages in time
    (digit-reversed in, natural out), so that slot k holds conj(y_k) for
    the convolution y, and reads X[k] = w_k conj(slot k) for k < N. The
    conjugation makes the forward stages compute the inverse transform,
    and leaves the outputs in slots 0..N-1.

    Every row is numpy's float64 (cos, sin) of an integer phase reduced
    exactly: the stage rows as :func:`fft_plan`'s over M, the chirp at
    -2π (n² mod 2N) / 2N, the split rows (even K) at -2π g / K. Rows:
    M's stages and roots, then b̂ (``bhat``), the chirp (``chirp``) and
    the split step (``split``). No (K, F) matrix is built. The arrays are
    cached and shared: copy before handing them to torch."""
    if nfft < 3:
        raise ValueError(f"the Bluestein plan needs nfft >= 3, got {nfft}")
    n = transform_length(nfft)
    m = bluestein_length(n)
    stages, perm, blocks, row = _dit_plan(m, m)
    idx = np.arange(n, dtype=np.int64)
    chirp = _rows(idx * idx, 2 * n)
    conj_w = chirp[:, 0] - 1j * chirp[:, 1]
    b = np.zeros(m, np.complex128)
    b[:n] = conj_w
    b[m - idx[1:]] = conj_w[1:]
    slots = np.empty(m, np.complex128)
    slots[perm] = np.fft.fft(b) / m
    blocks.append(np.stack([slots.real, slots.imag], axis=1))
    bhat, row = row, row + m
    blocks.append(chirp)
    chirp_row, row = row, row + n
    split = -1
    if nfft % 2 == 0:
        blocks.append(_rows(idx, nfft))
        split = row
    return BluesteinPlan(n, m, 1 if m <= BLUESTEIN_BLOCK_POINTS else 2,
                         stages, perm.astype(np.int32),
                         np.ascontiguousarray(np.concatenate(blocks)), bhat,
                         chirp_row, split)


# ---------------------------------------------------------------------------
# The plain dense route
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def ieee_fp32_dots() -> Iterator[None]:
    """Run float32 matrix products in full IEEE float32 (TF32 off).

    TF32 keeps a 10-bit mantissa, far outside the 1e-3 dB display contract.
    torch's default is already "highest"; this pins it for the contract
    dots whatever the caller set globally, and restores the caller's
    setting afterwards."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def dense_dft(frames: torch.Tensor, a_re: torch.Tensor,
              a_im: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., T, nperseg) frames -> (X_re, X_im), (..., T, F) each, as
    matmuls in the operands' dtype: IEEE float32 (TF32 off) for float32
    operands, float64 for float64 ones (the STFT kernel's precision,
    ``ops.stft_cuda``)."""
    with ieee_fp32_dots():
        return torch.matmul(frames, a_re), torch.matmul(frames, a_im)


def dense_power(frames: torch.Tensor, a_re: torch.Tensor,
                a_im: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """(..., T, nperseg) frames -> (..., T, F) PSD: (X_re² + X_im²) · wts,
    computed in the operands' dtype (:func:`dense_dft`)."""
    xr, xi = dense_dft(frames, a_re, a_im)
    return (xr * xr + xi * xi) * wts


def _require_dense_psd(cfg: SpecConfig) -> None:
    if cfg.center or cfg.mode != "psd":
        raise NotImplementedError(
            "the port computes uncentered PSD spectrograms only; centered "
            "framing and the magnitude/complex modes arrive with ROADMAP "
            "[ext-modes] (the extended modes)")


def _dense_psd(x: torch.Tensor, fs: float, cfg: SpecConfig,
               band: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The plain dense route in x's float dtype on x's device: frame-major
    (..., T, F), or only the bins band = (lo, hi), whose matrix columns
    and weights are sliced before the product (each kept bin is the same
    dot product as the full band's)."""
    a_re, a_im = dft_matrices(cfg)
    wts = onesided_weights(cfg, fs)
    if band is not None:
        a_re, a_im = a_re[:, band[0]:band[1]], a_im[:, band[0]:band[1]]
        wts = wts[band[0]:band[1]]

    def const(a: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.ascontiguousarray(a), dtype=x.dtype,
                            device=x.device)

    return dense_power(frame_signal(x, cfg.nperseg, cfg.hop_),
                       const(a_re), const(a_im), const(wts))


def _kernel_psd(x: torch.Tensor, fs: float, cfg: SpecConfig,
                band: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The route's STFT/PSD kernel on a tensor off the CPU, (..., n) ->
    (..., T, F or hi - lo): the leading axes flattened into the kernel's
    clips and restored."""
    from spectral_tpu_torch.ops import stft_cuda   # it imports this module
    lead = x.shape[:-1]
    p = stft_cuda.stft_psd(x.reshape(-1, x.shape[-1]).contiguous(), fs, cfg,
                           band=band)
    return p.reshape(lead + p.shape[-2:])


def power_spectrogram(x, fs: float, cfg: SpecConfig,
                      band: Optional[Tuple[int, int]] = None
                      ) -> torch.Tensor:
    """PSD spectrogram, frame-major: (..., n) -> (..., nframes, n_freqs).

    On a CPU tensor, the dense window/detrend-folded DFT route of the JAX
    package's ``power_spectrogram(use_matmul=True)``, computed in x's
    float dtype (the plain version). On a CUDA tensor, one launch of the
    route's STFT/PSD kernel (``ops.stft_cuda.stft_psd``), which takes
    float32 and the configs it computes, and raises on anything else.
    band=(lo, hi) returns only those bins, as
    :func:`power_spectrogram_fm` does."""
    return power_spectrogram_fm(x, fs, cfg, band=band).transpose(-1, -2)


def power_spectrogram_fm(x, fs: float, cfg: SpecConfig,
                         flip_freqs: bool = False,
                         band: Optional[Tuple[int, int]] = None
                         ) -> torch.Tensor:
    """Freq-major PSD: (..., n) -> (..., n_freqs, nframes), the display
    layout; flip_freqs=True puts the highest frequency in row 0.
    band=(lo, hi) returns only those bins of the unflipped one-sided axis
    (the reference's row mask, PlotEngine.py:114-115), flipped within the
    band under flip_freqs: the kernel and the plain version compute only
    those bins, each bitwise the full band's. Device and dtype as
    :func:`power_spectrogram`."""
    _require_dense_psd(cfg)
    if band is not None and not cfg.onesided:
        raise ValueError("band slicing requires a one-sided spectrum")
    x = ensure_real_waveform(x)
    if x.device.type == "cpu":
        p = _dense_psd(x, fs, cfg, band)
    else:
        p = _kernel_psd(x, fs, cfg, band)
    p = p.transpose(-1, -2)
    return p.flip(-2) if flip_freqs else p


def effective_config(cfg: SpecConfig, n: int) -> SpecConfig:
    """scipy's short-signal auto-shrink: nperseg greater than the signal
    length shrinks to the length (with scipy's UserWarning text), and the
    scipy-default hop/noverlap recompute from the shrunk nperseg — so a
    signal shorter than nperseg yields ONE frame like the reference, not
    an empty spectrogram. Scoped to scipy-compat semantics (hop=None,
    center=False); generalized explicit-hop configs keep their static
    shape and yield zero frames, as num_frames documents."""
    if 0 < n < cfg.nperseg and cfg.hop is None and not cfg.center:
        warnings.warn(f"nperseg = {cfg.nperseg} is greater than input "
                      f"length  = {n}, using nperseg = {n}", UserWarning)
        return dataclasses.replace(cfg, nperseg=n)
    return cfg


def spectrogram(x, fs: float, cfg: SpecConfig
                ) -> Tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """Reference-parity spectrogram: returns (f, t, Sxx), Sxx freq-major
    (..., n_masked_freqs, nframes) on x's device, f and t host numpy.

    Mirrors PlotEngine._plot_spectrogram's compute portion
    (PlotEngine.py:113-115): the scipy call (after scipy's short-signal
    shrink, :func:`effective_config`) and the frequency-band row mask
    [cfg.fmin, cfg.fmax], applied before anything else (before any
    normalization). A contiguous band on a one-sided axis is computed
    alone (``power_spectrogram_fm(band=...)``); an empty one gives no rows,
    as the reference's mask does. PSD mode only: the magnitude and complex
    modes arrive with ROADMAP [ext-modes]."""
    x = ensure_real_waveform(x)
    cfg = effective_config(cfg, x.shape[-1])
    if cfg.mode == "complex":
        raise NotImplementedError(
            "mode='complex' (the complex STFT) arrives with ROADMAP "
            "[ext-modes] (the extended modes)")
    _require_dense_psd(cfg)
    f = freq_axis(cfg, fs)
    t = time_axis(cfg, fs, x.shape[-1])
    if cfg.fmin is None and cfg.fmax is None:
        return f, t, power_spectrogram_fm(x, fs, cfg)
    idx = _band_rows(f, cfg.fmin, cfg.fmax)
    if cfg.onesided and idx.size and idx[-1] - idx[0] + 1 == idx.size:
        band = (int(idx[0]), int(idx[-1]) + 1)
        return f[band[0]:band[1]], t, power_spectrogram_fm(x, fs, cfg,
                                                           band=band)
    f, sxx = mask_band_rows(f, power_spectrogram_fm(x, fs, cfg), cfg.fmin,
                            cfg.fmax)
    return f, t, sxx


def _band_rows(f: np.ndarray, fmin: Optional[float],
               fmax: Optional[float]) -> np.ndarray:
    """The rows of f inside [fmin, fmax] (None: unbounded), ascending."""
    lo = fmin if fmin is not None else -np.inf
    hi = fmax if fmax is not None else np.inf
    return np.where((f >= lo) & (f <= hi))[0]


def band_row_slice(f: np.ndarray, fmin: Optional[float],
                   fmax: Optional[float]) -> Optional[Tuple[int, int]]:
    """Static (lo, hi) row slice of the reference's frequency mask
    (PlotEngine.py:114-115) on a monotone frequency axis; None = no mask.
    Raises on an empty band (a dataset export should refuse instead of
    writing blank images; interactive callers that need the reference's
    empty-band early-return check emptiness themselves first) and on a
    non-contiguous mask (two-sided fftfreq ordering — use
    :func:`mask_band_rows`' gather fallback there)."""
    if fmin is None and fmax is None:
        return None
    idx = _band_rows(f, fmin, fmax)
    if idx.size == 0:
        raise ValueError(
            f"the requested band [{fmin}, {fmax}] Hz contains no "
            f"frequency rows (axis spans {f[0]:.6g}..{f[-1]:.6g} Hz)")
    if idx.size != int(idx[-1]) - int(idx[0]) + 1:
        raise ValueError("band mask is non-contiguous on this frequency "
                         "axis (two-sided spectra are not supported here)")
    return int(idx[0]), int(idx[-1]) + 1


def mask_band_rows(f: np.ndarray, sxx, fmin: Optional[float],
                   fmax: Optional[float]):
    """Apply the reference's frequency row mask (PlotEngine.py:114-115) to a
    freq-major spectrogram (..., F, T), a numpy array or a tensor: a slice
    where the masked band is contiguous (one-sided spectra), a gather where
    it is not (two-sided fftfreq ordering). Returns (f masked, sxx
    masked)."""
    idx = _band_rows(f, fmin, fmax)
    f = f[idx]
    axis = sxx.ndim - 2
    if idx.size == 0:
        return f, sxx[..., :0, :]
    if bool(np.all(np.diff(idx) == 1)):
        return f, sxx[..., int(idx[0]):int(idx[-1]) + 1, :]
    if isinstance(sxx, np.ndarray):
        return f, np.take(sxx, idx, axis=axis)
    return f, torch.index_select(
        sxx, axis, torch.as_tensor(idx, dtype=torch.long, device=sxx.device))
