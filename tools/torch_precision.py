"""Precision evidence for the PyTorch port's STFT kernel
(``spectral_tpu_torch/ops/stft_cuda.py``), and the scipy display oracle
that its checks compare against.

    python3 tools/torch_precision.py [--seeds N] [--only NAME ...]

The kernel's accumulation orders are emulated in numpy on the CPU. The
first table gives, for each config on one clip (seed 0), the display error
against scipy in float64 of four ways to accumulate each PSD output over
the nperseg samples of a frame:

- ``fp32 chain``: one float32 FMA chain over ascending k, A in float32
  (exact products, one rounding per step), the epilogue rounded per step;
- ``fp32 16-sums``: float32 chains over 16-sample blocks, summed in a
  float32 chain;
- ``f64, A f32``: float64 accumulation of the float32 A;
- ``f64, A f64``: float64 accumulation of the host's float64 A, the
  epilogue in float64 (the kernel's arithmetic).

The second table repeats the float32 chain and the float64 route over
seeds 0 to N-1 (default 100): whether a float32 chain breaks the 1e-3 dB
contract depends on the clip, through the depth of its deepest bin. Its
last two columns are the FFT routes in float64: the radix-2 FFT kernel's
exact butterfly order and twiddle table (``psd_fft``) at the powers of
two, and the mixed-radix kernel's stages, load order and twiddle rows
(``psd_mixed_fft``) at the other configs (``MIXED_SWEEP``, where the
float32 chain is not emulated: it is a question of the GEMM design, and
at 8160 its emulation would take hours). Its last rows
(``LINEAR_SWEEP``) hold both FFT models to scipy under linear detrend on
ramp clips, the mixed-radix model at 1024 too (its plan is then all
radix-2 stages), and ``ODD_SWEEP`` holds the odd kernel's model
(``psd_odd_fft``, two frames a transform, a Rader stage at the primes)
and the mixed-radix model's Rader stage (8186) to scipy, on pairs clips
too: a zero, a NaN and a 1e-6 frame beside loud ones, compared on the
frames scipy computes finite; ``BLUESTEIN_SWEEP`` does the same for the
Bluestein kernel's model (``psd_bluestein``) at 563-8189. ``--only NAME
...`` runs the sweep's rows whose names contain one of the words, without
the first table.

Each PSD is rounded to float32, as the kernel stores it. The display error
is ``bench.py``'s formula, max |Δimage| times the image's dB range, with
the display itself computed in float64 so that it measures the PSD alone.
Clips are white noise of 8·nperseg samples, with or without a +3 offset,
or with a trend rising from 3 to 43 over the clip (ramp clips,
:func:`trend`).

scipy is an oracle here, as in ``bench.py`` and the tests; the port's
package never imports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from spectral_tpu_torch.config import SpecConfig  # noqa: E402
from spectral_tpu_torch.core.stft import (  # noqa: E402
    MAX_MIXED_RADIX, _window_f64, bluestein_plan, dft_matrices, fft_plan,
    fft_twiddles, onesided_weights, plan_radices)

FS = 16000.0
CONTRACT_DB = 1e-3
F32_MAX = float(np.finfo(np.float32).max)


def log_display(p: np.ndarray):
    """bench.py's log display of a PSD in float64: (image in [0, 1], its
    dB range)."""
    p = np.asarray(p, np.float64)
    db = np.nan_to_num(10.0 * np.log10(np.clip(p / (p.max() + 1e-20),
                                               0.0, 1.0) + 1e-12))
    rng = db.max() - db.min()
    return (db - db.min()) / rng, rng


def scipy_psd(x64: np.ndarray, cfg: SpecConfig, fs: float = FS):
    """scipy.signal.spectrogram's (F, T) PSD of a float64 clip at cfg's
    framing, window and detrend."""
    from scipy.signal import spectrogram
    _f, _t, sxx = spectrogram(
        x64, fs=fs, window=cfg.window, nperseg=cfg.nperseg,
        noverlap=cfg.nperseg - cfg.hop_, nfft=cfg.nperseg,
        detrend=False if cfg.detrend == "none" else cfg.detrend,
        scaling="density", mode="psd")
    return sxx


def scipy_display(x64: np.ndarray, cfg: SpecConfig, fs: float = FS):
    """The oracle of the display contract: :func:`scipy_psd` through
    :func:`log_display`. Returns the (F, T) image and its dB range."""
    return log_display(scipy_psd(x64, cfg, fs))


def display_error_db(psd_tf: np.ndarray, x64: np.ndarray,
                     cfg: SpecConfig) -> float:
    """bench.py's display error of a (F, T) PSD against scipy in float64,
    both displays computed in float64. A clip with NaN samples is compared
    on the frames that scipy computes finite, when the PSD has NaN in
    exactly the other frames (else the error is inf)."""
    ref = scipy_psd(x64, cfg)
    bad = np.isnan(ref).any(axis=0)
    if not np.array_equal(bad, np.isnan(psd_tf).any(axis=0)):
        return float("inf")
    img_ref, rng = log_display(ref[:, ~bad])
    img, _ = log_display(psd_tf[:, ~bad])
    return float(np.max(np.abs(img - img_ref)) * rng)


def frames_of(x: np.ndarray, cfg: SpecConfig) -> np.ndarray:
    """(T, nperseg) float32 frames of a float32 clip."""
    T = (x.shape[-1] - cfg.nperseg) // cfg.hop_ + 1
    idx = np.arange(T)[:, None] * cfg.hop_ + np.arange(cfg.nperseg)[None]
    return x[idx]


def psd_fp32_chain(frames: np.ndarray, a_re: np.ndarray, a_im: np.ndarray,
                   wts: np.ndarray, block: int = 0) -> np.ndarray:
    """(T, F) float32 PSD from float32 FMA chains over ascending k; block
    > 0 sums float32 chains over block-sample pieces in a float32 chain."""
    a_re = a_re.astype(np.float32).astype(np.float64)
    a_im = a_im.astype(np.float32).astype(np.float64)
    f = frames.astype(np.float64)

    def chain(lo, hi):
        re = np.zeros((f.shape[0], a_re.shape[1]), np.float32)
        im = np.zeros_like(re)
        for k in range(lo, hi):
            re = (re + f[:, k:k + 1] * a_re[k]).astype(np.float32)
            im = (im + f[:, k:k + 1] * a_im[k]).astype(np.float32)
        return re, im

    K = f.shape[1]
    if block:
        re = np.zeros((f.shape[0], a_re.shape[1]), np.float32)
        im = np.zeros_like(re)
        for k0 in range(0, K, block):
            pr, pi = chain(k0, min(K, k0 + block))
            re, im = re + pr, im + pi
    else:
        re, im = chain(0, K)
    return (re * re + im * im) * wts.astype(np.float32)


def psd_f64(frames: np.ndarray, a_re: np.ndarray, a_im: np.ndarray,
            wts: np.ndarray, a_dtype=np.float64) -> np.ndarray:
    """(T, F) PSD accumulated in float64 from A rounded to a_dtype, the
    epilogue in float64, rounded once to float32."""
    f = frames.astype(np.float64)
    re = f @ a_re.astype(a_dtype).astype(np.float64)
    im = f @ a_im.astype(a_dtype).astype(np.float64)
    return ((re * re + im * im) * wts).astype(np.float32)


def bit_reverse(k: int) -> np.ndarray:
    """bitrev(p) for p < k, k a power of two: the FFT kernel's load order
    (``__brev(p) >> (32 - log2 k)``)."""
    bits = k.bit_length() - 1
    p = np.arange(k)
    r = np.zeros_like(p)
    for b in range(bits):
        r |= ((p >> b) & 1) << (bits - 1 - b)
    return r


def detrended(f: np.ndarray, detrend: str) -> np.ndarray:
    """The FFT kernels' detrend of float64 frames (T, K), before the window
    (``csrc/stft_psd.cu::frame_line``): none, f; constant, f - mean;
    linear, f - mean - slope·(i - c) with c = (K - 1)/2, mean = Σ x / K and
    slope = Σ (i - c)·x / D, D = K (K² - 1)/12, the least-squares line
    against the centred index. What differs from the card: the sums are
    numpy's, not the kernel's block reduction."""
    if detrend == "none":
        return f
    K = f.shape[-1]
    mean = f.sum(axis=-1, keepdims=True) / K
    if detrend == "constant":
        return f - mean
    d = np.arange(K) - (K - 1) / 2.0
    slope = (f * d).sum(axis=-1, keepdims=True) / (K * (K * K - 1.0) / 12.0)
    return f - mean - slope * d


def psd_fft(frames: np.ndarray, window: np.ndarray, twiddles: np.ndarray,
            wts: np.ndarray, detrend: str = "none",
            round_f32: bool = True) -> np.ndarray:
    """(T, F) PSD by the FFT kernel's arithmetic
    (``csrc/stft_psd.cu::stft_fft_psd_kernel``), in float64, K = nperseg,
    M = K/2:

    - v = (frame - line) · window, the line the frame's mean under
      constant detrend, its least-squares line under linear, 0 under none
      (:func:`detrended`);
    - z[m] = v[2m] + i v[2m + 1], stored in bit-reversed order;
    - an M-point radix-2 decimation-in-time FFT whose stage h combines
      z[i0] and z[i0 + h] (i0 = 2h·(j div h) + j mod h) with the twiddle
      table's row h - 1 + (j mod h), W_2h^(j mod h);
    - the split step: for bin f (g = min(f, K - f)), E = (Z[g] + conj
      Z[M - g]) / 2, O = -i (Z[g] - conj Z[M - g]) / 2 (indices mod M),
      X = E + W_K^g O with W_K^g the table's row M - 1 + g (-1 at g = M);
    - (re² + im²)·w, inf past float32's range, rounded once to float32
      unless round_f32 is False.

    window, twiddles and wts are the kernel's host operands
    (``ops/stft_cuda.py::fft_constants``). What differs from the card:
    the detrend's sums are numpy's, not the kernel's block reduction;
    numpy rounds the products where the card may fuse them (FMA); the
    kernel's swizzle of shared-memory addresses moves values, not
    arithmetic."""
    f = frames.astype(np.float64)
    K = f.shape[-1]
    M = K // 2
    F = wts.shape[0]
    v = detrended(f, detrend) * window
    i = bit_reverse(M)
    re, im = v[:, 0::2][:, i], v[:, 1::2][:, i]
    j = np.arange(M // 2)
    h = 1
    while h < M:
        k = j & (h - 1)
        i0 = ((j - k) << 1) + k
        i1 = i0 + h
        wr, wi = twiddles[h - 1 + k, 0], twiddles[h - 1 + k, 1]
        ar, ai, br, bi = re[:, i0], im[:, i0], re[:, i1], im[:, i1]
        tr = wr * br - wi * bi
        ti = wr * bi + wi * br
        re[:, i0], im[:, i0] = ar + tr, ai + ti
        re[:, i1], im[:, i1] = ar - tr, ai - ti
        h *= 2
    fb = np.arange(F)
    g = np.minimum(fb, K - fb)
    a, b = g % M, (M - g) % M
    ar, ai, br, bi = re[:, a], im[:, a], re[:, b], im[:, b]
    er, ei = 0.5 * (ar + br), 0.5 * (ai - bi)
    o_r, o_i = 0.5 * (ai + bi), 0.5 * (br - ar)
    last = np.minimum(g, M - 1)
    wr = np.where(g < M, twiddles[M - 1 + last, 0], -1.0)
    wi = np.where(g < M, twiddles[M - 1 + last, 1], 0.0)
    xr = er + (wr * o_r - wi * o_i)
    xi = ei + (wr * o_i + wi * o_r)
    s = xr * xr + xi * xi
    p = np.where(s > F32_MAX, np.inf, s * wts)
    return p.astype(np.float32) if round_f32 else p


def _cmul(wr, wi, yr, yi):
    """(wr + i wi)(yr + i yi) as the kernels compute it."""
    return wr * yr - wi * yi, wr * yi + wi * yr


def _stages(re: np.ndarray, im: np.ndarray, plan, n: int,
            dif: bool = False) -> None:
    """The plan's stages on (T, n) contiguous arrays in place: decimation
    in time in plan order, or with ``dif`` each stage transposed in
    reverse order (decimation in frequency: the butterfly's DFT first,
    then the twiddles on its outputs). Per stage (p, L), on each group g
    of L·p slots and each k < L (the butterfly (g, k) reads and writes
    slots g·L·p + k + q·L, q < p):

    - p = 2: t = W y_1, (y_0 + t, y_0 - t), W the stage's row k; in
      frequency (y_0 + y_1, W (y_0 - y_1));
    - odd p: y_q <- W_q y_q for q >= 1 (row (q - 1)·L + k) when L > 1;
      then with a_q = y_q + y_(p-q), b_q = y_q - y_(p-q) and the root row
      (c, s) at (q·m mod p), for m = 0..(p-1)/2 and q = 1..(p-1)/2 in
      ascending order: A = y_0 + Σ a_q c, B = Σ b_q s, out[m] = A + i B
      and out[p - m] = A - i B; in frequency the twiddles multiply
      out[m] (m >= 1) instead."""
    tw = plan.twiddles
    T = re.shape[0]
    order = plan.stages.tolist()
    for p, L, tw_row, root_row in (order[::-1] if dif else order):
        G = n // (L * p)
        # slot of (group g, value q, k): g·L·p + q·L + k, as (T, G, p, L)
        zr = re.reshape(T, G, p, L)
        zi = im.reshape(T, G, p, L)
        if p == 2:
            wr, wi = tw[tw_row:tw_row + L, 0], tw[tw_row:tw_row + L, 1]
            if dif:
                ar, ai = zr[:, :, 0].copy(), zi[:, :, 0].copy()
                br, bi = zr[:, :, 1].copy(), zi[:, :, 1].copy()
                zr[:, :, 0], zi[:, :, 0] = ar + br, ai + bi
                zr[:, :, 1], zi[:, :, 1] = _cmul(wr, wi, ar - br, ai - bi)
                continue
            tr, ti = _cmul(wr, wi, zr[:, :, 1], zi[:, :, 1])
            ar, ai = zr[:, :, 0].copy(), zi[:, :, 0].copy()
            zr[:, :, 0], zi[:, :, 0] = ar + tr, ai + ti
            zr[:, :, 1], zi[:, :, 1] = ar - tr, ai - ti
            continue
        w = tw[tw_row:tw_row + (p - 1) * L].reshape(p - 1, L, 2)
        if L > 1 and not dif:
            zr[:, :, 1:], zi[:, :, 1:] = _cmul(w[..., 0], w[..., 1],
                                               zr[:, :, 1:], zi[:, :, 1:])
        h = (p - 1) // 2
        roots = tw[root_row:root_row + p]
        m = np.arange(h + 1)
        # (T, G, h + 1, L): A and B of outputs m = 0..h
        Ar = np.repeat(zr[:, :, :1], h + 1, axis=2)
        Ai = np.repeat(zi[:, :, :1], h + 1, axis=2)
        Br = np.zeros_like(Ar)
        Bi = np.zeros_like(Ar)
        for q in range(1, h + 1):
            c = roots[(q * m) % p, 0][:, None]
            s = roots[(q * m) % p, 1][:, None]
            yr, yi = zr[:, :, q:q + 1], zi[:, :, q:q + 1]
            xr, xi = zr[:, :, p - q:p - q + 1], zi[:, :, p - q:p - q + 1]
            Ar = Ar + (yr + xr) * c
            Ai = Ai + (yi + xi) * c
            Br = Br + (yr - xr) * s
            Bi = Bi + (yi - xi) * s
        zr[:, :, :h + 1], zi[:, :, :h + 1] = Ar - Bi, Ai + Br
        zr[:, :, p - h:], zi[:, :, p - h:] = ((Ar + Bi)[:, :, :0:-1],
                                              (Ai - Br)[:, :, :0:-1])
        if L > 1 and dif:
            zr[:, :, 1:], zi[:, :, 1:] = _cmul(w[..., 0], w[..., 1],
                                               zr[:, :, 1:], zi[:, :, 1:])


def _transform(re: np.ndarray, im: np.ndarray, plan, n: int):
    """The n-point transform of the values the plan's load order put in
    the (T, n) slots re + i im, in natural order, as the kernels compute
    it (``csrc/stft_psd.cu``: the mixed-radix kernel's passes, and the
    pass engine's ``conv_forward``/``conv_transform``, which group the
    same stages into passes): the plan's stages, or with
    a Rader stage (``plan.rader >= 0``, P = n - 1, x0 in slot P) the
    P-point stages in frequency, X[0] = x0 + slot 0, the product with the
    b̂ rows in slot order, the stages in time, and X[f] = x0 + slot
    perm[f] for f > 0."""
    if plan.rader < 0:
        _stages(re, im, plan, n)
        return re, im
    P = n - 1
    x0r, x0i = re[:, P].copy(), im[:, P].copy()
    sr, si = re[:, :P].copy(), im[:, :P].copy()
    _stages(sr, si, plan, P, dif=True)
    sum_r, sum_i = x0r + sr[:, 0], x0i + si[:, 0]
    b = plan.twiddles[plan.rader:plan.rader + P]
    sr, si = _cmul(b[:, 0], b[:, 1], sr, si)
    _stages(sr, si, plan, P)
    zr = np.empty_like(re)
    zi = np.empty_like(im)
    zr[:, 0], zi[:, 0] = sum_r, sum_i
    zr[:, 1:] = x0r[:, None] + sr[:, plan.perm[1:]]
    zi[:, 1:] = x0i[:, None] + si[:, plan.perm[1:]]
    return zr, zi


def _power(xr, xi, wts, round_f32):
    s = xr * xr + xi * xi
    p = np.where(s > F32_MAX, np.inf, s * wts)
    return p.astype(np.float32) if round_f32 else p


def psd_mixed_fft(frames: np.ndarray, window: np.ndarray, plan,
                  wts: np.ndarray, detrend: str = "none",
                  round_f32: bool = True) -> np.ndarray:
    """(T, F) PSD by the mixed-radix FFT kernel's arithmetic
    (``csrc/stft_psd.cu::stft_mixed_fft_psd_kernel``, and with a Rader
    stage the odd kernel's PACKED form on the pass engine), in float64,
    with ``plan`` = ``core/stft.py::fft_plan(nperseg)``, K = nperseg even,
    M = K/2. The kernels group the plan's stages into passes (radix-2
    stages up to four in registers, a generic prime's outputs blocked over
    warps), which moves values, not arithmetic: each butterfly's
    expressions and the order of its sums are these
    (``tests/test_torch_mixed_registers.py`` and, for the Rader plans,
    ``tests/test_torch_conv_registers.py`` transcribe the passes and hold
    them to this model bit for bit):

    - v = (frame - line) · window (:func:`detrended`); z[m] = v[2m] + i
      v[2m + 1] stored at slot perm[m] (the mixed-radix digit reversal, or
      with a Rader stage the Rader order);
    - the M-point transform (:func:`_transform`, :func:`_stages`);
    - the split step and the epilogue of :func:`psd_fft` with indices
      reduced mod M (g = M reads slot 0 and takes W = -1).

    What differs from the card: the detrend's sums are numpy's, not the
    kernel's block reduction, and numpy rounds the products where the card
    may fuse them (FMA)."""
    f = frames.astype(np.float64)
    T, K = f.shape
    M = K // 2
    v = detrended(f, detrend) * window
    re = np.empty((T, M))
    im = np.empty((T, M))
    re[:, plan.perm] = v[:, 0::2]
    im[:, plan.perm] = v[:, 1::2]
    re, im = _transform(re, im, plan, M)
    return _split_psd(re, im, plan.twiddles[plan.split:], K, wts, round_f32)


def _split_psd(re: np.ndarray, im: np.ndarray, split: np.ndarray, K: int,
               wts: np.ndarray, round_f32: bool) -> np.ndarray:
    """The split step and the PSD epilogue of the even-K FFT kernels
    (``split_psd_epilogue``) on the (T, M) transform Z of the packed
    frames, M = K/2, in natural order: for bin f (g = min(f, K - f)), E =
    (Z[g] + conj Z[M - g]) / 2, O = -i (Z[g] - conj Z[M - g]) / 2 (indices
    mod M), X = E + W_K^g O with W_K^g the row g of ``split`` (-1 at g =
    M); then :func:`_power`."""
    M = K // 2
    F = wts.shape[0]
    fb = np.arange(F)
    g = np.minimum(fb, K - fb)
    a, b = g % M, (M - g) % M
    ar, ai, br, bi = re[:, a], im[:, a], re[:, b], im[:, b]
    er, ei = 0.5 * (ar + br), 0.5 * (ai - bi)
    o_r, o_i = 0.5 * (ai + bi), 0.5 * (br - ar)
    last = np.minimum(g, M - 1)
    wr = np.where(g < M, split[last, 0], -1.0)
    wi = np.where(g < M, split[last, 1], 0.0)
    xr = er + (wr * o_r - wi * o_i)
    xi = ei + (wr * o_i + wi * o_r)
    return _power(xr, xi, wts, round_f32)


# csrc/stft_psd.cu::PAIR_MAX_RATIO: two frames share a transform when both
# are finite, neither is all zero after detrend and window, and their
# energies are within this ratio
PAIR_MAX_RATIO = 65536.0


def paired_frames(v: np.ndarray) -> np.ndarray:
    """(T,) bool: frame t (even) shares a transform with frame t + 1, and
    t + 1 with t, by the odd kernel's guard on the detrended, windowed
    frames v (T, K). What differs from the card: the energies are numpy's
    sums, not the kernel's block reduction (a pair at the ratio's edge may
    fall on the other side)."""
    T = v.shape[0]
    e = (v * v).sum(axis=1)
    a, b = e[0:T - 1:2], e[1:T:2]
    with np.errstate(invalid="ignore", over="ignore"):
        ok = (np.isfinite(a) & np.isfinite(b) & (a > 0) & (b > 0)
              & (np.maximum(a, b) <= PAIR_MAX_RATIO * np.minimum(a, b)))
    paired = np.zeros(T, bool)
    paired[0:2 * ok.size:2] = ok
    paired[1:2 * ok.size:2] = ok
    return paired


def psd_odd_fft(frames: np.ndarray, window: np.ndarray, plan,
                wts: np.ndarray, detrend: str = "none",
                round_f32: bool = True, pack: bool = True) -> np.ndarray:
    """(T, F) PSD by the odd-nperseg kernel's arithmetic
    (``csrc/stft_psd.cu::stft_odd_fft_psd_kernel``), in float64, with
    ``plan`` = ``core/stft.py::fft_plan(nperseg)``, K = nperseg odd:

    - v = (frame - line) · window (:func:`detrended`), per frame;
    - frames 2j and 2j + 1 of the clip share one K-point transform, z =
      v_a + i v_b at slot perm[i], where :func:`paired_frames` says so
      (and ``pack``); a frame without a partner, or whose pair the guard
      refuses, is transformed alone, z = v + 0i;
    - the K-point transform (:func:`_transform`);
    - a pair's bins A[f] = (Z[f] + conj Z[K - f]) / 2 and B[f] = (Z[f] -
      conj Z[K - f]) / 2i (indices mod K), a lone frame's X[f] = Z[f];
      then (re² + im²)·w, inf past float32's range, rounded once to
      float32 unless round_f32 is False.

    What differs from the card: the detrend's sums and the guard's
    energies are numpy's, not the kernel's block reductions, and numpy
    rounds the products where the card may fuse them (FMA)."""
    K = frames.shape[-1]

    def transform(re, im):
        zr = np.empty_like(re)
        zi = np.empty_like(im)
        zr[:, plan.perm], zi[:, plan.perm] = re, im
        return _transform(zr, zi, plan, K)

    v = detrended(frames.astype(np.float64), detrend) * window
    return _pair_psd(v, transform, wts, round_f32, pack)


def _pair_psd(v: np.ndarray, transform, wts: np.ndarray, round_f32: bool,
              pack: bool = True) -> np.ndarray:
    """The odd kernels' pairing and pair epilogue on the detrended,
    windowed odd frames v (T, K), with ``transform(re, im)`` the kernel's
    K-point transform of values in natural order: frames 2j and 2j + 1
    share one transform, z = v_a + i v_b, where :func:`paired_frames` says
    so (and ``pack``), their bins A[f] = (Z[f] + conj Z[K - f]) / 2 and
    B[f] = (Z[f] - conj Z[K - f]) / 2i (indices mod K); any other frame
    is transformed alone, z = v + 0i, X[f] = Z[f]; then :func:`_power`."""
    T, K = v.shape
    F = wts.shape[0]
    paired = (paired_frames(v) if pack else np.zeros(T, bool))
    out = np.empty((T, F))
    fb = np.arange(F)
    a_rows = np.flatnonzero(paired)[0::2]
    if a_rows.size:
        zr, zi = transform(v[a_rows], v[a_rows + 1])
        j = (K - fb) % K
        ar, ai, br, bi = zr[:, fb], zi[:, fb], zr[:, j], zi[:, j]
        out[a_rows] = _power(0.5 * (ar + br), 0.5 * (ai - bi), wts, False)
        out[a_rows + 1] = _power(0.5 * (ai + bi), 0.5 * (br - ar), wts,
                                 False)
    alone = np.flatnonzero(~paired)
    if alone.size:
        zr, zi = transform(v[alone], np.zeros((alone.size, K)))
        out[alone] = _power(zr[:, :F], zi[:, :F], wts, False)
    return out.astype(np.float32) if round_f32 else out


def _bluestein_transform(re: np.ndarray, im: np.ndarray, plan):
    """The N-point DFT of the (T, N) values re + i im in natural order, in
    natural order, as the Bluestein kernel computes it
    (``csrc/stft_psd.cu::bluestein_transform`` on the pass engine
    ``conv_transform``, ``plan`` =
    ``core/stft.py::bluestein_plan``): a = x·w (the chirp rows) in slots
    0..N-1 of M, zero past them; M's stages in frequency; each slot
    conj(b̂·slot); the stages in time; X[k] = w_k·conj(slot k).

    With ``plan.ranks == 2`` the M slots are the two blocks' halves of M/2
    as the cluster indexes them: the plan's last stage is radix 2 at span
    M/2, which in frequency leaves rank 0's slots as they are (its
    partner slots hold zeros: a + 0 = a) and gives rank 1 W^k·a from rank
    0's slot k, and in time gives rank 0 a + W^k·b from rank 1's slot k;
    every other stage, and the product, runs on each half alone with the
    rows of the whole plan."""
    T, N = re.shape
    M = plan.m
    tw = plan.twiddles
    cr, ci = tw[plan.chirp:plan.chirp + N, 0], tw[plan.chirp:plan.chirp + N, 1]
    ar, ai = _cmul(cr, ci, re, im)
    bhat = tw[plan.bhat:plan.bhat + M]

    def product(sr, si, b):
        pr, pi = _cmul(b[:, 0], b[:, 1], sr, si)
        return pr, -pi

    if plan.ranks == 1:
        sr, si = np.zeros((T, M)), np.zeros((T, M))
        sr[:, :N], si[:, :N] = ar, ai
        _stages(sr, si, plan, M, dif=True)
        sr, si = product(sr, si, bhat)
        _stages(sr, si, plan, M)
        o_r, o_i = sr[:, :N], si[:, :N]
    else:
        H = M // 2
        p, L, row, _ = plan.stages[-1].tolist()
        assert (p, L) == (2, H) and N <= H
        wr, wi = tw[row:row + H, 0], tw[row:row + H, 1]
        local = plan._replace(stages=plan.stages[:-1])
        h0r, h0i = np.zeros((T, H)), np.zeros((T, H))
        h0r[:, :N], h0i[:, :N] = ar, ai
        h1r, h1i = _cmul(wr, wi, h0r, h0i)
        halves = []
        for r, (hr, hi) in enumerate(((h0r, h0i), (h1r, h1i))):
            _stages(hr, hi, local, H, dif=True)
            hr, hi = product(hr, hi, bhat[r * H:(r + 1) * H])
            _stages(hr, hi, local, H)
            halves.append((hr, hi))
        (h0r, h0i), (h1r, h1i) = halves
        tr, ti = _cmul(wr[:N], wi[:N], h1r[:, :N], h1i[:, :N])
        o_r, o_i = h0r[:, :N] + tr, h0i[:, :N] + ti
    return _cmul(cr, ci, o_r, -o_i)


def psd_bluestein(frames: np.ndarray, window: np.ndarray, plan,
                  wts: np.ndarray, detrend: str = "none",
                  round_f32: bool = True, pack: bool = True) -> np.ndarray:
    """(T, F) PSD by the Bluestein kernel's arithmetic
    (``csrc/stft_psd.cu::stft_bluestein_psd_kernel``), in float64, with
    ``plan`` = ``core/stft.py::bluestein_plan(nperseg)``:

    - v = (frame - line) · window (:func:`detrended`);
    - even K: z[m] = v[2m] + i v[2m + 1], the N = K/2-point transform
      (:func:`_bluestein_transform`), then the split step and epilogue of
      :func:`_split_psd` with the plan's split rows;
    - odd K: the odd kernel's pairing and pair epilogue (:func:`_pair_psd`)
      around the N = K-point transform.

    What differs from the card: the detrend's sums and the guard's
    energies are numpy's, not the kernel's block reductions, and numpy
    rounds the products where the card may fuse them (FMA)."""
    K = frames.shape[-1]
    v = detrended(frames.astype(np.float64), detrend) * window
    if K % 2:
        return _pair_psd(v, lambda re, im: _bluestein_transform(re, im, plan),
                         wts, round_f32, pack)
    re, im = _bluestein_transform(v[:, 0::2], v[:, 1::2], plan)
    return _split_psd(re, im, plan.twiddles[plan.split:], K, wts, round_f32)


def fft_operands(cfg: SpecConfig, fs: float = FS):
    """The FFT kernel's host operands as numpy float64: window, twiddle
    table, weights."""
    return (_window_f64(cfg), fft_twiddles(cfg.nperseg),
            onesided_weights(cfg, fs))


def mixed_operands(cfg: SpecConfig, fs: float = FS):
    """The mixed-radix kernel's host operands: window, plan, weights."""
    return (_window_f64(cfg), fft_plan(cfg.nperseg),
            onesided_weights(cfg, fs))


def bluestein_operands(cfg: SpecConfig, fs: float = FS):
    """The Bluestein kernel's host operands: window, plan, weights."""
    return (_window_f64(cfg), bluestein_plan(cfg.nperseg),
            onesided_weights(cfg, fs))


def trend(n: int) -> np.ndarray:
    """The trend of a ramp clip of n samples: 5·t + 3 with t running from 0
    to 8 over the clip, the linear-detrend signal of
    ``tests/test_extended_modes.py`` (5·t + 3 over 8.2 s) scaled to the
    clip's length."""
    return 3.0 + 40.0 * np.arange(n) / n


def clip(cfg: SpecConfig, seed: int, offset: float,
         ramp: bool = False, pairs: bool = False) -> np.ndarray:
    """White noise of 8·nperseg float32 samples, plus offset, plus
    :func:`trend` for a ramp clip. A pairs clip (:func:`pair_breakers`)
    holds the frames that the odd kernel's pairing must keep apart."""
    rs = np.random.RandomState(seed)
    x = rs.randn(8 * cfg.nperseg) + offset
    if ramp:
        x = x + trend(x.size)
    if pairs:
        x = pair_breakers(x, cfg)
    return x.astype(np.float32)


def pair_breakers(x: np.ndarray, cfg: SpecConfig) -> np.ndarray:
    """x with frame 1 all zero (beside frame 0), a NaN in frame 3 where no
    other frame reads (beside frame 2), and frame 5 scaled by 1e-6
    (beside frame 4): the zero, NaN and 1e6-ratio neighbours of the odd
    kernel's pairs, at hop 7/8 nperseg (scipy's default) or more."""
    K, hop = cfg.nperseg, cfg.hop_
    x = x.copy()
    x[hop:hop + K] = 0.0
    x[3 * hop + K // 2] = np.nan
    x[5 * hop:5 * hop + K] *= 1e-6
    return x


ONE_CLIP = [
    ("north_star 1024/256", SpecConfig.north_star(1024, 256), 3.0, False),
    ("scipy_default 1024", SpecConfig.scipy_default(1024), 0.0, True),
    ("scipy_default 1024", SpecConfig.scipy_default(1024), 3.0, True),
    ("north_star 8192/2048", SpecConfig.north_star(8192, 2048), 0.0, False),
    ("scipy_default 8192", SpecConfig.scipy_default(8192), 0.0, True),
    ("scipy_default 8192", SpecConfig.scipy_default(8192), 3.0, True),
]

SWEEP = [
    ("north_star 128/32", SpecConfig.north_star(128, 32)),
    ("north_star 256/64", SpecConfig.north_star(256, 64)),
    ("north_star 512/128", SpecConfig.north_star(512, 128)),
    ("north_star 1024/256", SpecConfig.north_star(1024, 256)),
    ("scipy_default 1024", SpecConfig.scipy_default(1024)),
]

MIXED_SWEEP = [
    ("north_star 960/240", SpecConfig.north_star(960, 240)),
    ("scipy_default 992", SpecConfig.scipy_default(992)),
    ("scipy_default 4192", SpecConfig.scipy_default(4192)),
    ("scipy_default 7968", SpecConfig.scipy_default(7968)),
    ("scipy_default 8032", SpecConfig.scipy_default(8032)),
    ("scipy_default 8160", SpecConfig.scipy_default(8160)),
]

# the odd route (odd nperseg, Rader at the primes 4093 and 8191) and the
# Rader stage on the mixed-radix kernel (8186 = 2 · 4093)
ODD_SWEEP = [(f"scipy_default {k}", SpecConfig.scipy_default(k))
             for k in (1023, 4093, 8186, 8191)]

# the Bluestein route: even on one block (1126, 8182), odd on one block
# (563, 2049) and on a cluster of two (8185, 8189)
BLUESTEIN_SWEEP = [(f"scipy_default {k}", SpecConfig.scipy_default(k))
                   for k in (563, 1126, 2049, 8182, 8185, 8189)]

LINEAR_SWEEP = [(name, dataclasses.replace(cfg, detrend="linear"))
                for name, cfg in (
                    ("north_star 1024/256", SpecConfig.north_star(1024, 256)),
                    ("scipy_default 992", SpecConfig.scipy_default(992)),
                    ("scipy_default 8032", SpecConfig.scipy_default(8032)),
                    ("scipy_default 8160", SpecConfig.scipy_default(8160)))]

# clip kind -> (offset, ramp, pairs)
CLIP_KINDS = {"noise": (0.0, False, False), "noise + 3": (3.0, False, False),
              "ramp": (0.0, True, False), "pairs": (3.0, False, True)}


def one_clip_table() -> None:
    print("config                 clip       fp32 chain  fp32 16-sums  "
          "f64, A f32  f64, A f64  (dB against scipy float64, seed 0)")
    for name, cfg, offset, all_columns in ONE_CLIP:
        x = clip(cfg, 0, offset)
        frames = frames_of(x, cfg)
        a_re, a_im = dft_matrices(cfg)
        wts = onesided_weights(cfg, FS)
        cols = [psd_fp32_chain(frames, a_re, a_im, wts)]
        if all_columns:
            cols += [psd_fp32_chain(frames, a_re, a_im, wts, block=16),
                     psd_f64(frames, a_re, a_im, wts, np.float32),
                     psd_f64(frames, a_re, a_im, wts)]
        errs = [f"{display_error_db(p.T, x.astype(np.float64), cfg):.2e}"
                for p in cols]
        errs += ["—"] * (4 - len(errs))
        kind = "noise + 3" if offset else "noise"
        print(f"{name:22s} {kind:10s} " + "  ".join(f"{e:10s}" for e in errs),
              flush=True)


def sweep_table(seeds: int, only=None) -> None:
    print(f"\nconfig                 clip, detrend       fp32 chain: worst  "
          f"seed  above {CONTRACT_DB:g} dB  worst of seeds 0-19 | f64, A "
          f"f64: worst | fft route: worst | mixed route: worst | odd route: "
          f"worst | bluestein route: worst  (seeds 0-{seeds - 1})")
    rows = ([(name, cfg, ("noise", "noise + 3"))
             for name, cfg in SWEEP + MIXED_SWEEP]
            + [(name, cfg, ("ramp",)) for name, cfg in LINEAR_SWEEP]
            + [(name, cfg, ("noise", "noise + 3", "pairs"))
               for name, cfg in ODD_SWEEP + BLUESTEIN_SWEEP])
    if only:
        rows = [r for r in rows if any(o in r[0] for o in only)]
    for name, cfg, kinds in rows:
        chain = (name, cfg) in SWEEP
        a_re, a_im = dft_matrices(cfg)
        wts = onesided_weights(cfg, FS)
        # the radix-2 model at powers of two, the mixed-radix model off the
        # float32 chain's rows (at 1024 its plan is all radix-2 stages)
        models = {}
        if cfg.nperseg & (cfg.nperseg - 1) == 0:
            models["fft"] = (psd_fft, fft_operands(cfg))
        if max(plan_radices(cfg.nperseg)) > MAX_MIXED_RADIX:
            models["bluestein"] = (psd_bluestein, bluestein_operands(cfg))
        elif cfg.nperseg % 2:
            models["odd"] = (psd_odd_fft, mixed_operands(cfg))
        elif not chain:
            models["mixed"] = (psd_mixed_fft, mixed_operands(cfg))
        for kind in kinds:
            offset, ramp, pairs = CLIP_KINDS[kind]
            fp32, f64 = [], []
            routes = {route: [] for route in models}
            for s in range(seeds):
                x = clip(cfg, s, offset, ramp, pairs)
                x64 = x.astype(np.float64)
                frames = frames_of(x, cfg)
                if chain:
                    fp32.append(display_error_db(
                        psd_fp32_chain(frames, a_re, a_im, wts).T, x64, cfg))
                f64.append(display_error_db(
                    psd_f64(frames, a_re, a_im, wts).T, x64, cfg))
                for route, (model, ops) in models.items():
                    routes[route].append(display_error_db(
                        model(frames, *ops, detrend=cfg.detrend).T, x64,
                        cfg))
            if chain:
                fp32 = np.asarray(fp32)
                left = (f"{fp32.max():.2e}           {int(fp32.argmax()):4d}"
                        f"  {int((fp32 > CONTRACT_DB).sum()):3d} of "
                        f"{seeds:<4d}     {fp32[:20].max():.2e}           ")
            else:
                left = f"{'—':<49s}"
            cols = [f"{max(routes[r]):.2e}" if r in routes else "—"
                    for r in ("fft", "mixed", "odd", "bluestein")]
            print(f"{name:22s} {kind + ', ' + cfg.detrend:19s} {left} | "
                  f"{max(f64):.2e}           | {cols[0]:<17s}| "
                  f"{cols[1]:<19s}| {cols[2]:<17s}| {cols[3]}", flush=True)
        dft_matrices.cache_clear()      # 533 MB a config at 8160


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=100,
                    help="clips per config and offset in the sweep")
    ap.add_argument("--only", nargs="*",
                    help="the sweep's rows whose config names contain one "
                         "of these, without the first table")
    args = ap.parse_args(argv)
    if not args.only:
        one_clip_table()
    sweep_table(args.seeds, args.only)


if __name__ == "__main__":
    main()
