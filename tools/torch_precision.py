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

The HMM kernels' steps are modelled here too, lane by lane
(:func:`hmm_step_state_lanes`, :func:`hmm_step_lanes`), with their
M-step (:func:`hmm_m_step_kernel`); ``tests/test_torch_hmm_lanes.py``
holds the K^2-lane step to the one-state-a-lane step bitwise and the
M-step to ``models/hmm.py::_m_step_stats``.

scipy is an oracle here, as in ``bench.py`` and the tests; the port's
package never imports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from spectral_tpu_torch.config import SpecConfig  # noqa: E402
from spectral_tpu_torch.core.stft import (  # noqa: E402
    MAX_MIXED_RADIX, _window_f64, bluestein_plan, bluestein_route_plan,
    dft_matrices, fft_plan, fft_twiddles, onesided_weights, plan_radices)
from spectral_tpu_torch.ops.stft_cuda import kernel_weights  # noqa: E402

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
    framing, window, detrend and transform length (nfft)."""
    from scipy.signal import spectrogram
    _f, _t, sxx = spectrogram(
        x64, fs=fs, window=cfg.window, nperseg=cfg.nperseg,
        noverlap=cfg.nperseg - cfg.hop_, nfft=cfg.nfft_,
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


def padded(v: np.ndarray, nfft: Optional[int]) -> np.ndarray:
    """Detrended, windowed frames v (T, L) zero-padded to nfft slots, the
    FFT kernels' zero-padded load (slots L to nfft - 1 exactly zero)."""
    L = v.shape[-1]
    if nfft is None or nfft == L:
        return v
    return np.concatenate([v, np.zeros(v.shape[:-1] + (nfft - L,))], -1)


def psd_fft(frames: np.ndarray, window: np.ndarray, twiddles: np.ndarray,
            wts: np.ndarray, detrend: str = "none",
            round_f32: bool = True, nfft: Optional[int] = None,
            mode: str = "psd") -> np.ndarray:
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
      unless round_f32 is False (or the epilogue's other ``mode``,
      :func:`epilogue_out`).

    With ``nfft`` past the frames' L samples the transform is nfft points
    (K = nfft) over the frames zero-padded (:func:`padded`), the detrend
    over the L samples. window (L,), twiddles and wts are the kernel's host
    operands (``ops/stft_cuda.py::fft_constants``, whose window is this
    one zero-padded to nfft). What differs from the card:
    the detrend's sums are numpy's, not the kernel's block reduction;
    numpy rounds the products where the card may fuse them (FMA); the
    kernel's swizzle of shared-memory addresses moves values, not
    arithmetic."""
    f = frames.astype(np.float64)
    v = padded(detrended(f, detrend) * window, nfft)
    K = v.shape[-1]
    M = K // 2
    F = wts.shape[0]
    i = bit_reverse(M)
    re, im = v[:, 0::2][:, i], v[:, 1::2][:, i]
    _radix2_dit(re, im, twiddles)
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
    return epilogue_out(xr, np.where(fb > M, -xi, xi), wts, round_f32, mode)


def _cmul(wr, wi, yr, yi):
    """(wr + i wi)(yr + i yi) as the kernels compute it."""
    return wr * yr - wi * yi, wr * yi + wi * yr


def _radix2_dit(re: np.ndarray, im: np.ndarray,
                twiddles: np.ndarray) -> None:
    """:func:`psd_fft`'s radix-2 decimation-in-time stages, in place, on
    (T, n) values loaded in bit-reversed order (n a power of two): stage h
    combines slots i0 and i0 + h with the table's row h - 1 + (j mod h)."""
    n = re.shape[-1]
    j = np.arange(n // 2)
    h = 1
    while h < n:
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


def psd_fft_split(frames: np.ndarray, window: np.ndarray,
                  twiddles: np.ndarray, wts: np.ndarray,
                  detrend: str = "none", round_f32: bool = True,
                  nfft: Optional[int] = None,
                  mode: str = "psd") -> np.ndarray:
    """(T, F) PSD by the radix-2 kernel's arithmetic past 8192
    (``csrc/stft_psd.cu::stft_fft_split_psd_kernel``: nfft K from 16384, a
    frame as two half transforms), in float64, M = K/2, H = M/2:

    - v and z as :func:`psd_fft`'s; then the first stage in frequency, in
      the load: u0_j = z_j + z_(j+H), u1_j = W_M^j (z_j - z_(j+H)) (the
      table's row H - 1 + j, ``r2_dif_butterfly``), j < H;
    - each half's H-point radix-2 transform (:func:`_radix2_dit`, from the
      bit-reversed load), Z[2k + h] its output k;
    - the split step and epilogue of :func:`_split_psd` on the table's rows
      M - 1 + g, each bin from the half of its parity.

    The half transforms are independent, so this is the arithmetic of the
    kernel's two blocks whatever their order. What differs from the card:
    the detrend's sums are numpy's, and numpy rounds the products where
    the card may fuse them (FMA)."""
    f = frames.astype(np.float64)
    v = padded(detrended(f, detrend) * window, nfft)
    T, K = v.shape
    M = K // 2
    H = M // 2
    zr, zi = v[:, 0::2], v[:, 1::2]
    ar, ai, br, bi = zr[:, :H], zi[:, :H], zr[:, H:], zi[:, H:]
    wr, wi = twiddles[H - 1:M - 1, 0], twiddles[H - 1:M - 1, 1]
    i = bit_reverse(H)
    re = np.empty((T, M))
    im = np.empty((T, M))
    for h, (ur, ui) in enumerate(((ar + br, ai + bi),
                                  _cmul(wr, wi, ar - br, ai - bi))):
        hr, hi = ur[:, i], ui[:, i]
        _radix2_dit(hr, hi, twiddles)
        re[:, h::2], im[:, h::2] = hr, hi
    return _split_psd(re, im, twiddles[M - 1:], K, wts, round_f32, mode)


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


def epilogue_out(xr, xi, wts, round_f32, mode="psd"):
    """The epilogues' output (``csrc/stft_psd.cu::store_bin``) of the bins
    X = xr + i xi and their weights: "psd", (re² + im²)·w; "magnitude",
    sqrt(re² + im²)·w (w the PSD weights' square roots); both inf past
    float32's |X|² range; "complex", X·w (w sqrt of the PSD scale, or 1);
    rounded once to float32 (complex64) unless round_f32 is False."""
    if mode == "complex":
        z = xr * wts + 1j * (xi * wts)
        return z.astype(np.complex64) if round_f32 else z
    s = xr * xr + xi * xi
    p = np.sqrt(s) if mode == "magnitude" else s
    p = np.where(s > F32_MAX, np.inf, p * wts)
    return p.astype(np.float32) if round_f32 else p



def psd_mixed_fft(frames: np.ndarray, window: np.ndarray, plan,
                  wts: np.ndarray, detrend: str = "none",
                  round_f32: bool = True, nfft: Optional[int] = None,
                  mode: str = "psd") -> np.ndarray:
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

    ``nfft`` and ``mode`` as :func:`psd_fft` (``plan`` then nfft's). What
    differs from the card: the detrend's sums are numpy's, not the
    kernel's block reduction, and numpy rounds the products where the card
    may fuse them (FMA)."""
    f = frames.astype(np.float64)
    v = padded(detrended(f, detrend) * window, nfft)
    T, K = v.shape
    M = K // 2
    re = np.empty((T, M))
    im = np.empty((T, M))
    re[:, plan.perm] = v[:, 0::2]
    im[:, plan.perm] = v[:, 1::2]
    re, im = _transform(re, im, plan, M)
    return _split_psd(re, im, plan.twiddles[plan.split:], K, wts, round_f32,
                      mode)


def _split_psd(re: np.ndarray, im: np.ndarray, split: np.ndarray, K: int,
               wts: np.ndarray, round_f32: bool,
               mode: str = "psd") -> np.ndarray:
    """The split step and the PSD epilogue of the even-K FFT kernels
    (``split_psd_epilogue``) on the (T, M) transform Z of the packed
    frames, M = K/2, in natural order: for bin f (g = min(f, K - f)), E =
    (Z[g] + conj Z[M - g]) / 2, O = -i (Z[g] - conj Z[M - g]) / 2 (indices
    mod M), X = E + W_K^g O with W_K^g the row g of ``split`` (-1 at g =
    M), conjugated past M (two sided); then :func:`epilogue_out`."""
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
    return epilogue_out(xr, np.where(fb > M, -xi, xi), wts, round_f32, mode)


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
                round_f32: bool = True, pack: bool = True,
                nfft: Optional[int] = None, mode: str = "psd") -> np.ndarray:
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
    v = padded(detrended(frames.astype(np.float64), detrend) * window, nfft)
    K = v.shape[-1]

    def transform(re, im):
        zr = np.empty_like(re)
        zi = np.empty_like(im)
        zr[:, plan.perm], zi[:, plan.perm] = re, im
        return _transform(zr, zi, plan, K)

    return _pair_psd(v, transform, wts, round_f32, pack, mode)


def _pair_psd(v: np.ndarray, transform, wts: np.ndarray, round_f32: bool,
              pack: bool = True, mode: str = "psd") -> np.ndarray:
    """The odd kernels' pairing and pair epilogue on the detrended,
    windowed odd frames v (T, K), with ``transform(re, im)`` the kernel's
    K-point transform of values in natural order: frames 2j and 2j + 1
    share one transform, z = v_a + i v_b, where :func:`paired_frames` says
    so (and ``pack``), their bins A[f] = (Z[f] + conj Z[K - f]) / 2 and
    B[f] = (Z[f] - conj Z[K - f]) / 2i (indices mod K); any other frame
    is transformed alone, z = v + 0i, X[f] = Z[f] (in complex mode past
    K/2, two sided, conj Z[K - f]); then :func:`epilogue_out` in
    ``mode``."""
    T, K = v.shape
    F = wts.shape[0]
    paired = (paired_frames(v) if pack else np.zeros(T, bool))
    out = np.empty((T, F), complex if mode == "complex" else float)
    fb = np.arange(F)
    a_rows = np.flatnonzero(paired)[0::2]
    if a_rows.size:
        zr, zi = transform(v[a_rows], v[a_rows + 1])
        j = (K - fb) % K
        ar, ai, br, bi = zr[:, fb], zi[:, fb], zr[:, j], zi[:, j]
        out[a_rows] = epilogue_out(0.5 * (ar + br), 0.5 * (ai - bi), wts,
                                   False, mode)
        out[a_rows + 1] = epilogue_out(0.5 * (ai + bi), 0.5 * (br - ar),
                                       wts, False, mode)
    alone = np.flatnonzero(~paired)
    if alone.size:
        zr, zi = transform(v[alone], np.zeros((alone.size, K)))
        mirror = (2 * fb > K) & (mode == "complex")
        g = np.where(mirror, K - fb, fb)
        out[alone] = epilogue_out(zr[:, g], np.where(mirror, -zi[:, g],
                                                     zi[:, g]),
                                  wts, False, mode)
    if not round_f32:
        return out
    return out.astype(np.complex64 if mode == "complex" else np.float32)


def _bluestein_transform(re: np.ndarray, im: np.ndarray, plan):
    """The N-point DFT of the (T, N) values re + i im in natural order, in
    natural order, as the Bluestein kernel computes it
    (``csrc/stft_psd.cu::bluestein_transform`` on the pass engine
    ``conv_transform``, ``plan`` =
    ``core/stft.py::bluestein_plan``): a = x·w (the chirp rows) in slots
    0..N-1 of M, zero past them; M's stages in frequency; each slot
    conj(b̂·slot); the stages in time; X[k] = w_k·conj(slot k).

    With ``plan.ranks`` R = 2, 4 or 8 the M slots are the cluster's R
    blocks of H = M / R, slot q H + j at rank q's slot j, as the cluster
    indexes them: the plan's last log2 R stages are radix 2 at spans H,
    2H, ..., M/2 and cross the ranks, pairing slot j of ranks q and q +
    2^t; in frequency they run first on each column j (span M/2 first,
    (a, b) <- (a + b, W (a - b)), the row's k = (q mod 2^t) H + j), in
    time last (span H first, (a, b) <- (a + W b, a - W b)); every other
    stage, and the product, runs on each rank's slots alone with the rows
    of the whole plan. On two ranks the inputs and outputs lie in rank 0's
    slots (N <= H), so rank 0's crossing in frequency adds zeros (a + 0 =
    a) and the kernel (``bluestein_transform<2>``) skips it, and only rank
    0's outputs are read; on four and eight
    (``stft_bluestein_cluster_psd_kernel``) both sides compute."""
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
        R = plan.ranks
        r = R.bit_length() - 1
        H = M // R
        rows = []
        for t, (p, L, row, _) in enumerate(plan.stages[-r:].tolist()):
            assert (p, L) == (2, H << t)
            rows.append(row)
        local = plan._replace(stages=plan.stages[:-r])
        sr, si = np.zeros((T, M)), np.zeros((T, M))
        sr[:, :N], si[:, :N] = ar, ai
        # the slots as the ranks hold them: rank q's (T, H) columns
        ranks = [[sr[:, q * H:(q + 1) * H].copy(),
                  si[:, q * H:(q + 1) * H].copy()] for q in range(R)]
        j = np.arange(H)

        def crossing(t, dif):
            span = 1 << t
            for q in range(R):
                if q & span:
                    continue
                k = (q & (span - 1)) * H + j
                wr, wi = tw[rows[t] + k, 0], tw[rows[t] + k, 1]
                (a_r, a_i), (b_r, b_i) = ranks[q], ranks[q + span]
                if dif:
                    ranks[q] = [a_r + b_r, a_i + b_i]
                    ranks[q + span] = list(_cmul(wr, wi, a_r - b_r,
                                                 a_i - b_i))
                else:
                    t_r, t_i = _cmul(wr, wi, b_r, b_i)
                    ranks[q] = [a_r + t_r, a_i + t_i]
                    ranks[q + span] = [a_r - t_r, a_i - t_i]

        for t in reversed(range(r)):
            crossing(t, True)
        for q in range(R):
            hr, hi = ranks[q]
            _stages(hr, hi, local, H, dif=True)
            hr, hi = product(hr, hi, bhat[q * H:(q + 1) * H])
            _stages(hr, hi, local, H)
            ranks[q] = [hr, hi]
        for t in range(r):
            crossing(t, False)
        o_r = np.concatenate([h[0] for h in ranks], axis=1)[:, :N]
        o_i = np.concatenate([h[1] for h in ranks], axis=1)[:, :N]
    return _cmul(cr, ci, o_r, -o_i)


def psd_bluestein(frames: np.ndarray, window: np.ndarray, plan,
                  wts: np.ndarray, detrend: str = "none",
                  round_f32: bool = True, pack: bool = True,
                  nfft: Optional[int] = None,
                  mode: str = "psd") -> np.ndarray:
    """(T, F) PSD by the Bluestein kernel's arithmetic
    (``csrc/stft_psd.cu::stft_bluestein_psd_kernel``), in float64, with
    ``plan`` = ``core/stft.py::bluestein_plan(nperseg)``:

    - v = (frame - line) · window (:func:`detrended`);
    - even K: z[m] = v[2m] + i v[2m + 1], the N = K/2-point transform
      (:func:`_bluestein_transform`), then the split step and epilogue of
      :func:`_split_psd` with the plan's split rows;
    - odd K: the odd kernel's pairing and pair epilogue (:func:`_pair_psd`)
      around the N = K-point transform.

    A ``plan`` of two halves (``core/stft.py::bluestein_split_plan``)
    takes :func:`psd_bluestein_split`.

    What differs from the card: the detrend's sums and the guard's
    energies are numpy's, not the kernel's block reductions, and numpy
    rounds the products where the card may fuse them (FMA)."""
    if plan.halves == 2:
        return psd_bluestein_split(frames, window, plan, wts, detrend,
                                   round_f32, nfft, mode)
    v = padded(detrended(frames.astype(np.float64), detrend) * window, nfft)
    K = v.shape[-1]
    if K % 2:
        return _pair_psd(v, lambda re, im: _bluestein_transform(re, im, plan),
                         wts, round_f32, pack, mode)
    re, im = _bluestein_transform(v[:, 0::2], v[:, 1::2], plan)
    return _split_psd(re, im, plan.twiddles[plan.split:], K, wts, round_f32,
                      mode)


def psd_bluestein_split(frames: np.ndarray, window: np.ndarray, plan,
                        wts: np.ndarray, detrend: str = "none",
                        round_f32: bool = True,
                        nfft: Optional[int] = None,
                        mode: str = "psd") -> np.ndarray:
    """(T, F) PSD by the Bluestein kernel's arithmetic past 8192 at nfft K
    divisible by 4 (``csrc/stft_psd.cu::stft_bluestein_psd_kernel``'s
    SPLIT form, ``plan`` = ``core/stft.py::bluestein_split_plan(K)``), in
    float64, M = K/2, N = K/4:

    - v and z as :func:`psd_bluestein`'s; then the first stage in
      frequency, in the load: u0_j = z_j + z_(j+N), u1_j = W_M^j (z_j -
      z_(j+N)), W_M^j the plan's split row 2j, j < N;
    - each half's N-point Bluestein transform (:func:`_bluestein_transform`
      on the plan's one block or cluster of two), Z[2k + h] its output k;
    - the split step and epilogue of :func:`_split_psd` on the plan's
      split rows, each bin from the half of its parity.

    What differs from the card: the detrend's sums are numpy's, and numpy
    rounds the products where the card may fuse them (FMA)."""
    v = padded(detrended(frames.astype(np.float64), detrend) * window, nfft)
    T, K = v.shape
    M, N = K // 2, K // 4
    assert plan.halves == 2 and plan.n == N
    split = plan.twiddles[plan.split:plan.split + M]
    zr, zi = v[:, 0::2], v[:, 1::2]
    ar, ai, br, bi = zr[:, :N], zi[:, :N], zr[:, N:], zi[:, N:]
    wr, wi = split[0:M:2, 0], split[0:M:2, 1]
    re = np.empty((T, M))
    im = np.empty((T, M))
    for h, (ur, ui) in enumerate(((ar + br, ai + bi),
                                  _cmul(wr, wi, ar - br, ai - bi))):
        re[:, h::2], im[:, h::2] = _bluestein_transform(ur, ui, plan)
    return _split_psd(re, im, split, K, wts, round_f32, mode)


# ---------------------------------------------------------------------------
# The backward kernels of csrc/stft_grad_mixed.cu in numpy: the mixed and odd
# routes' FFT adjoints (the frames' gradient d from the output's gradient g)

def _cotangent(xr, xi, g, w, mode):
    """``stft_grad.cu::cotangent_of`` on arrays: (H_re, H_im) of bins X =
    xr + i xi with weights w from the output's gradient g (complex for
    the complex outputs): the PSD's 2 w g X, the magnitude's w g X / |X|
    (0 at |X| = 0), the complex STFT's w g; 0 where |X|^2 is past
    float32's range."""
    if mode == "complex":
        return w * g.real, w * g.imag
    s = xr * xr + xi * xi
    keep = s <= F32_MAX
    with np.errstate(invalid="ignore", divide="ignore"):
        if mode == "magnitude":
            keep = keep & (s != 0)
            c = w * g / np.sqrt(np.where(keep, s, 1.0))
        else:
            c = 2.0 * w * g
    c = np.where(keep, c, 0.0)
    return c * xr, c * xi


def _one_sided_cotangent(xr, xi, g, wts, K: int, band, two_sided: bool,
                         mode: str):
    """``stft_grad_mixed.cu::one_sided_cotangent`` on (T, K//2 + 1) bins X:
    H at the band's bins (g's column f - lo; ``wts`` every bin's weight),
    0 elsewhere, plus, two-sided, conj H[K - f] from conj X[f] for 0 < f <
    K/2."""
    lo, hi = band
    T, nb = xr.shape
    hr, hi_ = np.zeros((T, nb)), np.zeros((T, nb))
    f = np.arange(nb)
    on = (f >= lo) & (f < hi)
    if on.any():
        cr, ci = _cotangent(xr[:, on], xi[:, on], g[:, f[on] - lo], wts[f[on]],
                            mode)
        hr[:, on], hi_[:, on] = cr, ci
    m = K - f
    mir = two_sided & (f > 0) & (2 * f < K) & (m >= lo) & (m < hi)
    if mir.any():
        cr, ci = _cotangent(xr[:, mir], -xi[:, mir], g[:, m[mir] - lo],
                            wts[m[mir]], mode)
        hr[:, mir] = hr[:, mir] + cr
        hi_[:, mir] = hi_[:, mir] - ci
    return hr, hi_


def _halved(hr, hi, K: int):
    """S from H1: bin 0 (and K/2 for even K) real, the others halved."""
    sr, si = 0.5 * hr, 0.5 * hi
    sr[:, 0], si[:, 0] = hr[:, 0], 0.0
    if K % 2 == 0:
        sr[:, K // 2], si[:, K // 2] = hr[:, K // 2], 0.0
    return sr, si


def _inverse_transform(re, im, plan, n: int):
    """The kernels' inverse transform of (T, n) values re + i im given in
    natural order: without a Rader stage the plan's stages in frequency
    in place (``_stages(dif=True)``), value j then at slot perm[j]; with
    one the values at the Rader order's slots and the Rader transform
    (:func:`_transform`); natural order out."""
    if plan.rader < 0:
        _stages(re, im, plan, n, dif=True)
        return re[:, plan.perm], im[:, plan.perm]
    sr, si = np.empty_like(re), np.empty_like(im)
    sr[:, plan.perm], si[:, plan.perm] = re, im
    return _transform(sr, si, plan, n)


def _frame_gradient(dv: np.ndarray, window: np.ndarray, detrend: str):
    """The window and the detrend's projection (its own transpose) of d_v
    over the first L samples: the kernels' store."""
    L = window.shape[0]
    return detrended(dv[:, :L] * window, detrend)


def grad_mixed_fft(frames: np.ndarray, window: np.ndarray, plan,
                   wts: np.ndarray, g: np.ndarray, detrend: str = "none",
                   nfft: Optional[int] = None, mode: str = "psd",
                   band=None, two_sided: bool = False) -> np.ndarray:
    """(T, L) frames' gradient by the mixed-radix backward kernel's
    arithmetic (``csrc/stft_grad_mixed.cu::stft_mixed_fft_backward_kernel``,
    and with a Rader stage the odd backward kernel's PACKED form), float64,
    ``plan`` = ``fft_plan(nfft)``, K = nfft even, M = K/2; g (T, F) the
    gradient of the output ``mode`` ("psd", "magnitude", "complex") at the
    band's F bins (``band`` = (lo, hi), the full band when None), ``wts``
    every bin's weight of that output:

    - X recomputed as :func:`psd_mixed_fft` computes it (skipped for the
      complex output): the load at perm, the M-point transform, the split
      step at bins k = 0..M (``split_bin``);
    - H1 (:func:`_one_sided_cotangent`), S (bins 0 and M real, the others
      halved), conj Z'[k] = the inverse split step of S[k], S[M - k] and
      W_K^k (``inverse_split``);
    - the inverse transform of conj Z' (:func:`_inverse_transform`: the
      passes in frequency in place, or the Rader transform), y[j] the
      conjugate of z'[j] = d_v[2j] + i d_v[2j + 1];
    - the window and the detrend's projection (:func:`_frame_gradient`).

    What differs from the card: the detrend's sums are numpy's, and numpy
    rounds the products where the card may fuse them (FMA)."""
    v = padded(detrended(frames.astype(np.float64), detrend) * window, nfft)
    M = v.shape[-1] // 2

    def transform(re, im):
        zr, zi = np.empty_like(re), np.empty_like(im)
        zr[:, plan.perm], zi[:, plan.perm] = re, im
        return _transform(zr, zi, plan, M)

    return _grad_packed(v, window, detrend, plan.twiddles[plan.split:],
                        transform, lambda re, im: _inverse_transform(
                            re, im, plan, M), wts, g, mode, band, two_sided)


def _grad_packed(v, window, detrend, split, transform, inverse, wts, g,
                 mode, band, two_sided):
    """The even-K backward kernels' arithmetic on the detrended, windowed
    (T, K) frames v: X of the packed frame (``transform(re, im)``, the
    M = K/2-point DFT of values in natural order, natural order out) by the
    split step (``split`` the W_K^k rows), H1, S, conj Z' by the inverse
    split step, ``inverse(re, im)`` of conj Z' in natural order (the DFT,
    natural order out: y[j] = conj z'[j]), then the store."""
    T, K = v.shape
    M = K // 2
    nb = M + 1
    band = (0, wts.shape[0]) if band is None else band
    split = split[:M]
    k = np.arange(nb)
    wr = np.where(k < M, split[np.minimum(k, M - 1), 0], -1.0)
    wi = np.where(k < M, split[np.minimum(k, M - 1), 1], 0.0)
    xr, xi = np.zeros((T, nb)), np.zeros((T, nb))
    if mode != "complex":
        re, im = transform(v[:, 0::2], v[:, 1::2])
        a, b = k % M, (M - k) % M
        ar, ai, br, bi = re[:, a], im[:, a], re[:, b], im[:, b]
        er, ei = 0.5 * (ar + br), 0.5 * (ai - bi)
        o_r, o_i = 0.5 * (ai + bi), 0.5 * (br - ar)
        xr = er + (wr * o_r - wi * o_i)
        xi = ei + (wr * o_i + wi * o_r)
    sr, si = _halved(*_one_sided_cotangent(xr, xi, g, wts, K, band,
                                           two_sided, mode), K)
    kk = np.arange(M)
    tr, ti = sr[:, M - kk], si[:, M - kk]
    s_r, s_i = sr[:, :M], si[:, :M]
    er, ei = s_r + tr, s_i - ti
    dr, di = s_r - tr, s_i + ti
    o_r = dr * wr[:M] + di * wi[:M]
    o_i = di * wr[:M] - dr * wi[:M]
    yr, yi = inverse(er - o_i, -(ei + o_r))
    dv = np.empty((T, K))
    dv[:, 0::2], dv[:, 1::2] = yr, -yi
    return _frame_gradient(dv, window, detrend)


def pair_units(paired_fwd: np.ndarray, sr: np.ndarray,
               si: np.ndarray) -> np.ndarray:
    """(T,) bool: frame t shares the odd backward kernel's inverse with its
    partner (frames 2j and 2j + 1): both were transformed together in the
    recompute (``paired_fwd``, :func:`paired_frames`; every pair for the
    complex outputs, which recompute nothing) and the cotangents' guard
    passes: each frame's sum of |S|^2 finite, nonzero and within
    PAIR_MAX_RATIO of its partner's. What differs from the card: the sums
    are numpy's, not the kernel's block reduction."""
    T = sr.shape[0]
    e = (sr * sr + si * si).sum(axis=1)
    a, b = e[0:T - 1:2], e[1:T:2]
    with np.errstate(invalid="ignore", over="ignore"):
        ok = (np.isfinite(a) & np.isfinite(b) & (a > 0) & (b > 0)
              & (np.maximum(a, b) <= PAIR_MAX_RATIO * np.minimum(a, b)))
    ok = ok & paired_fwd[0:2 * ok.size:2]
    paired = np.zeros(T, bool)
    paired[0:2 * ok.size:2] = ok
    paired[1:2 * ok.size:2] = ok
    return paired


def grad_odd_fft(frames: np.ndarray, window: np.ndarray, plan,
                 wts: np.ndarray, g: np.ndarray, detrend: str = "none",
                 nfft: Optional[int] = None, mode: str = "psd", band=None,
                 two_sided: bool = False) -> np.ndarray:
    """(T, L) frames' gradient by the odd backward kernel's arithmetic
    (``csrc/stft_grad_mixed.cu::stft_odd_fft_backward_kernel``), float64,
    ``plan`` = ``fft_plan(nfft)``, K = nfft odd, g, wts, ``mode``,
    ``band`` and ``two_sided`` as :func:`grad_mixed_fft`:

    - X recomputed as :func:`psd_odd_fft` computes it (the forward's
      pairing, :func:`paired_frames`; skipped for the complex output): a
      pair's A and B from one K-point transform, a lone frame's Z;
    - H1 at bins f = 0..(K - 1)/2 (:func:`_one_sided_cotangent`) and S
      (bin 0 real, the others halved: odd K has no Nyquist bin);
    - frames 2j and 2j + 1 inverted together where :func:`pair_units`
      says so: conj Z' = conj(S_a + i S_b) extended Hermitian (at bin f
      (S_a.re - S_b.im, -(S_a.im + S_b.re)), at K - f (S_a.re + S_b.im,
      S_a.im - S_b.re), at 0 (S_a, -S_b)); each other frame alone, conj Z'
      = conj S at f and S at K - f;
    - the inverse transform (:func:`_inverse_transform`), d_a = Re y, d_b =
      -Im y, a lone frame's d = Re y;
    - the window and the detrend's projection (:func:`_frame_gradient`).

    What differs from the card: the detrend's sums and both guards' sums
    are numpy's, and numpy rounds the products where the card may fuse
    them (FMA)."""
    v = padded(detrended(frames.astype(np.float64), detrend) * window, nfft)
    K = v.shape[-1]

    def transform(re, im):
        zr, zi = np.empty_like(re), np.empty_like(im)
        zr[:, plan.perm], zi[:, plan.perm] = re, im
        return _transform(zr, zi, plan, K)

    return _grad_pairs(v, window, detrend, transform,
                       lambda re, im: _inverse_transform(re, im, plan, K),
                       wts, g, mode, band, two_sided)


def _grad_pairs(v, window, detrend, transform, inverse, wts, g, mode, band,
                two_sided):
    """The odd-K backward kernels' arithmetic on the detrended, windowed
    (T, K) frames v: the recompute's pairing (:func:`paired_frames`) around
    ``transform(re, im)`` (the K-point DFT of values in natural order,
    natural order out), S, the cotangents' pairing (:func:`pair_units`),
    conj Z' and ``inverse(re, im)`` of it in natural order (the DFT,
    natural order out), then the store."""
    T, K = v.shape
    H = K // 2
    nb = H + 1
    band = (0, wts.shape[0]) if band is None else band
    f = np.arange(nb)
    xr, xi = np.zeros((T, nb)), np.zeros((T, nb))
    fwd = paired_frames(v) if mode != "complex" else np.zeros(T, bool)
    if mode != "complex":
        a_rows = np.flatnonzero(fwd)[0::2]
        if a_rows.size:
            zr, zi = transform(v[a_rows], v[a_rows + 1])
            j = (K - f) % K
            ar, ai, br, bi = zr[:, f], zi[:, f], zr[:, j], zi[:, j]
            xr[a_rows], xi[a_rows] = 0.5 * (ar + br), 0.5 * (ai - bi)
            xr[a_rows + 1], xi[a_rows + 1] = 0.5 * (ai + bi), 0.5 * (br - ar)
        alone = np.flatnonzero(~fwd)
        if alone.size:
            zr, zi = transform(v[alone], np.zeros((alone.size, K)))
            xr[alone], xi[alone] = zr[:, f], zi[:, f]
    else:
        fwd = np.zeros(T, bool)
        fwd[0:2 * (T // 2)] = True
    sr, si = _halved(*_one_sided_cotangent(xr, xi, g, wts, K, band,
                                           two_sided, mode), K)
    inv = pair_units(fwd, sr, si)
    dv = np.empty((T, K))
    m = K - f[1:]
    a_rows = np.flatnonzero(inv)[0::2]
    if a_rows.size:
        ar, ai = sr[a_rows], si[a_rows]
        br, bi = sr[a_rows + 1], si[a_rows + 1]
        zr, zi = np.empty((a_rows.size, K)), np.empty((a_rows.size, K))
        zr[:, 0], zi[:, 0] = ar[:, 0], -br[:, 0]
        zr[:, 1:nb], zi[:, 1:nb] = ar[:, 1:] - bi[:, 1:], -(ai[:, 1:]
                                                             + br[:, 1:])
        zr[:, m], zi[:, m] = ar[:, 1:] + bi[:, 1:], ai[:, 1:] - br[:, 1:]
        yr, yi = inverse(zr, zi)
        dv[a_rows], dv[a_rows + 1] = yr, -yi
    alone = np.flatnonzero(~inv)
    if alone.size:
        s_r, s_i = sr[alone], si[alone]
        zr, zi = np.empty((alone.size, K)), np.empty((alone.size, K))
        zr[:, 0], zi[:, 0] = s_r[:, 0], 0.0
        zr[:, 1:nb], zi[:, 1:nb] = s_r[:, 1:], -s_i[:, 1:]
        zr[:, m], zi[:, m] = s_r[:, 1:], s_i[:, 1:]
        yr, _ = inverse(zr, zi)
        dv[alone] = yr
    return _frame_gradient(dv, window, detrend)


def grad_bluestein(frames: np.ndarray, window: np.ndarray, plan,
                   wts: np.ndarray, g: np.ndarray, detrend: str = "none",
                   nfft: Optional[int] = None, mode: str = "psd", band=None,
                   two_sided: bool = False) -> np.ndarray:
    """(T, L) frames' gradient by the Bluestein backward kernel's arithmetic
    (``csrc/stft_grad_mixed.cu::stft_bluestein_fft_backward_kernel``),
    float64, ``plan`` = ``bluestein_plan(nfft)``, g, wts, ``mode``, ``band``
    and ``two_sided`` as :func:`grad_mixed_fft`. Every transform, the
    recompute's and the inverse's, is :func:`_bluestein_transform` (the
    chirp times each value on its way in, the convolution, X[k] = w_k
    conj(slot k) out; a plan of two ranks modelled as the cluster indexes
    its halves):

    - even K (N = K/2): :func:`grad_mixed_fft`'s arithmetic, the packed
      frame's transform and the inverse of conj Z' both Bluestein's (the
      kernel writes w_k conj Z'[k] into slot k and reads y_j = w_j
      conj(slot j) = conj z'[j]);
    - odd K (N = K): :func:`grad_odd_fft`'s pairings, each transform
      Bluestein's.

    What differs from the card: the detrend's sums and both guards' sums
    are numpy's, and numpy rounds the products where the card may fuse
    them (FMA)."""
    v = padded(detrended(frames.astype(np.float64), detrend) * window, nfft)

    def transform(re, im):
        return _bluestein_transform(re, im, plan)

    if v.shape[-1] % 2:
        return _grad_pairs(v, window, detrend, transform, transform, wts, g,
                           mode, band, two_sided)
    return _grad_packed(v, window, detrend, plan.twiddles[plan.split:],
                        transform, transform, wts, g, mode, band, two_sided)


def fft_operands(cfg: SpecConfig, fs: float = FS, out=None):
    """The FFT kernel's host operands as numpy float64: window (nperseg
    points; the kernel's is zero-padded to nfft), twiddle table of nfft,
    weights of the output ``out`` (``stft_cuda.kernel_weights``)."""
    return (_window_f64(cfg), fft_twiddles(cfg.nfft_),
            kernel_weights(cfg, fs, out))


def mixed_operands(cfg: SpecConfig, fs: float = FS, out=None):
    """The mixed-radix kernel's host operands: window, plan of nfft,
    weights."""
    return (_window_f64(cfg), fft_plan(cfg.nfft_),
            kernel_weights(cfg, fs, out))


def bluestein_operands(cfg: SpecConfig, fs: float = FS, out=None):
    """The Bluestein kernel's host operands: window, plan of nfft (the
    whole transform's, ``bluestein_plan``), weights."""
    return (_window_f64(cfg), bluestein_plan(cfg.nfft_),
            kernel_weights(cfg, fs, out))


def bluestein_route_operands(cfg: SpecConfig, fs: float = FS, out=None):
    """The operands of the form the Bluestein kernel runs at nfft
    (``bluestein_route_plan``: the two halves past 8192 where nfft is
    divisible by 4), for :func:`psd_bluestein`."""
    return (_window_f64(cfg), bluestein_route_plan(cfg.nfft_),
            kernel_weights(cfg, fs, out))


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


# ---------------------------------------------------------------------------
# The HMM kernels' steps (csrc/hmm.cu), lane by lane in numpy float64: the
# one-state-a-lane step (fwd_step, bwd_step, the scan's steps; KM 8, and
# KM 2 and 4 before the K^2-lane step) and the K^2-lane step (k2_step,
# k2_lse, est_scan_kernel's K^2 form), each on the lanes that compute.
# ---------------------------------------------------------------------------

HMM_STEPS = ("fwd", "bwd", "scan_fwd", "scan_bwd")


def _ordered_max(vals, K: int):
    """The kernels' max: index order, a strict >, the first element
    first."""
    m = vals[0]
    for i in range(1, K):
        if vals[i] > m:
            m = vals[i]
    return m


def _ordered_sum(vals, K: int):
    s = vals[0]
    for i in range(1, K):
        s = s + vals[i]
    return s


def _step_operands(x, coef, lbv):
    return ([np.float64(v) for v in x], np.asarray(coef, np.float64),
            np.asarray(lbv, np.float64))


def hmm_step_state_lanes(kind: str, x, coef, lbv, K: int, KM: int):
    """One step of the one-state-a-lane form on a warp: lane j holds state
    jj = min(j, K - 1); x (K,) the states' values, coef (K, K) LA (or the
    chunk's transfer F for the scan's steps), lbv (K,) the emissions
    (lb[t] forward, lb[t + 1] backward; unused by the scan's steps).
    Returns the K new values (and, for the scan's steps, the
    normalization's max M; the forward scan also the normalized incoming
    vector)."""
    x, A, lb = _step_operands(x, coef, lbv)
    lanes = [x[min(j, K - 1)] for j in range(32)]
    out, extra = [], None
    if kind == "scan_fwd":
        M = _ordered_max(lanes, K)
        vin = [v - M for v in lanes]
        extra = (M, vin[:K])
    elif kind == "bwd":
        u = [lb[min(j, K - 1)] + lanes[j] for j in range(32)]
    for j in range(K):
        jj = min(j, K - 1)
        w = []
        for i in range(KM):
            ii = i if i < K else 0
            if kind == "fwd":
                w.append(lanes[i] + (A[i, jj] if i < K else 0.0))
            elif kind == "bwd":
                w.append((A[jj, i] if i < K else 0.0) + u[i])
            elif kind == "scan_fwd":
                w.append(vin[i] + A[ii, jj])
            else:
                w.append(A[jj, ii] + lanes[i])
        m = _ordered_max(w, K)
        s = _ordered_sum([np.exp(w[i] - m) for i in range(K)], K)
        r = m + np.log(s)
        out.append(lb[jj] + r if kind == "fwd" else r)
    if kind == "scan_bwd":
        M = _ordered_max(out, K)
        out = [v - M for v in out]
        extra = M
    return out, extra


def hmm_step_lanes(kind: str, x, coef, lbv, K: int, KM: int):
    """The same step on a group of KM^2 lanes, lane (o, r) = (q // KM, q %
    KM): every lane of row o holds x[min(o, K - 1)]; the row values by
    shuffles from lanes (i, 0), the row's K terms and their ordered max,
    ONE exp a lane (its own term, w[r]), the row's K exps by shuffles from
    lanes (o, i), summed in index order. Returns what
    :func:`hmm_step_state_lanes` returns, read from lanes (o, 0), after
    checking that every lane of a row holds the same value."""
    x, A, lb = _step_operands(x, coef, lbv)
    G = KM * KM
    lanes = [x[min(q // KM, K - 1)] for q in range(G)]

    def rows(vals):                       # k2_rows: vi[i] from lane (i, 0)
        vi = [vals[i * KM] for i in range(KM)]
        return vi, _ordered_max(vi, K)

    if kind == "bwd":
        lanes = [lb[min(q // KM, K - 1)] + lanes[q] for q in range(G)]
    vi, M = rows(lanes)
    w_all, m_all = [], []
    for q in range(G):
        o, r = divmod(q, KM)
        oo = min(o, K - 1)
        w = []
        for i in range(KM):
            ii = i if i < K else 0
            if kind == "fwd":
                w.append(vi[i] + (A[i, oo] if i < K else 0.0))
            elif kind == "bwd":
                w.append(vi[i] + (A[oo, i] if i < K else 0.0))
            elif kind == "scan_fwd":
                w.append((vi[i] - M) + A[ii, oo])
            else:
                w.append(A[oo, ii] + vi[i])
        w_all.append(w)
        m_all.append(_ordered_max(w, K))
    with np.errstate(over="ignore"):       # lanes past K: never summed
        e = [np.exp(w_all[q][q % KM] - m_all[q]) for q in range(G)]
    new = []
    for q in range(G):
        o = q // KM
        s = _ordered_sum([e[o * KM + i] for i in range(KM)], K)
        res = m_all[q] + np.log(s)
        new.append(lb[min(o, K - 1)] + res if kind == "fwd" else res)
    extra = None
    if kind == "scan_fwd":
        extra = (M, [lanes[o * KM] - M for o in range(K)])
    elif kind == "scan_bwd":
        _, M2 = rows(new)
        new = [v - M2 for v in new]
        extra = M2
    for o in range(K):
        row = new[o * KM:(o + 1) * KM]
        if any(v.tobytes() != row[0].tobytes() for v in row):
            raise AssertionError(f"row {o}'s lanes disagree")
    return [new[o * KM] for o in range(K)], extra


def hmm_m_step_kernel(params, stats, covars_prior: float = 1e-2):
    """csrc/hmm.cu's m_step<KM> in numpy float64, operation for operation:
    thread 0 the start row, threads 32 + i transmat row i, threads 64 +
    k D + d mean and covariance (k, d). params (startprob (K,), transmat
    (K, K), means (K, D), covars (K, D)); stats (gamma0 (K,), sum gamma
    (K,), gamma^T X (K, D), gamma^T X^2 (K, D), sum xi (K, K))."""
    f = np.float64
    start, trans, means, _ = (np.asarray(p, np.float64) for p in params)
    g0, gs, gx, gx2, xi = (np.asarray(s, np.float64) for s in stats)
    K, D = means.shape
    num = [f(0.0) if start[k] == 0.0 else g0[k] for k in range(K)]
    ssum = _ordered_sum(num, K)
    den = f(1.0) if ssum == 0.0 else ssum
    new_start = np.array([num[k] / den for k in range(K)])
    new_trans = np.empty((K, K))
    for i in range(K):
        num = [f(0.0) if trans[i, j] == 0.0 else xi[i, j] for j in range(K)]
        rsum = _ordered_sum(num, K)
        den = f(1.0) if rsum == 0.0 else rsum
        new_trans[i] = [num[j] / den for j in range(K)]
    new_means = np.empty((K, D))
    new_covars = np.empty((K, D))
    for k in range(K):
        for d in range(D):
            denom, obs, obs2 = gs[k], gx[k, d], gx2[k, d]
            mu = obs / max(denom, f(1e-30)) if denom > 0.0 else means[k, d]
            num = (obs2 - (f(2.0) * mu) * obs) + (mu * mu) * denom
            new_means[k, d] = mu
            new_covars[k, d] = (f(covars_prior) + num) / max(denom, f(1e-5))
    return new_start, new_trans, new_means, new_covars


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
