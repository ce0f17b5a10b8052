"""The STFT backward on the mixed-radix, odd and Bluestein routes
(``stft_mixed_fft_backward_kernel``, ``stft_odd_fft_backward_kernel``,
``stft_bluestein_fft_backward_kernel``), held on the CPU to the dense
backward and to the JAX package.

The kernels recompute X on their route's forward engine and take the
transform's adjoint as a c2r transform on the same engine
(``csrc/stft_grad_mixed.cu``); their plain version is
``ops/stft_cuda.py::frames_backward_fft_reference`` (torch.fft in
float64), which takes every nfft, odd included. Here, on seeded numpy
inputs:

- the plain FFT adjoint against the dense plain backward
  (``frames_backward_reference``, the folded matrices) within EXACT of each
  clip's largest |d|: mixed 96, 960 linear, 992, 8160, the generic prime
  8032 (p = 251), the Rader plans (mixed 514 and 1006, odd 257 and 8191),
  odd 33 and 1023, Bluestein 563, 1028, 1126, 2049 and 587, zero padding
  (1000/1536, 1024/2047, 2000/2049), two-sided, magnitude with zero bins,
  complex, a band, centered, frames of equal samples;
- the chain through the plain FFT adjoint against ``jax.grad`` of the JAX
  package's ``power_spectrogram`` and ``stft`` at tests/test_torch_grad.py's
  tolerance, the Bluestein route's configs among them;
- numpy models of the kernels' arithmetic
  (``tools/torch_precision.py::grad_mixed_fft``, ``grad_odd_fft``,
  ``grad_bluestein``: the passes in frequency on conjugated values, the
  inverse split step, the Rader transform again, the Bluestein transform
  again with the chirp on the way in and the cluster's halves as its
  ranks index them, the odd pairings and the cotangents' guard) against
  the plain adjoint within EXACT, NaN gradients (which stay in their
  frame), zero and quiet frames beside loud ones and odd T included;
- the wrapper's dispatch off the CPU (meta tensors): the mixed route
  (PACKED Rader plans included), the odd route and the Bluestein route
  (even, odd, cluster, zero-padded, every output) launch their kernel and
  the overlap-add alone, with no recompute of X and no dense operands; B1
  only when forced; each wrapper refusing another route's config; the
  ctypes prototypes against the C launchers (the Bluestein one's too).
"""

import dataclasses
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import torch_precision as tp  # noqa: E402

from spectral_tpu.config import SpecConfig as JaxSpecConfig  # noqa: E402
from spectral_tpu.core import stft as jstft  # noqa: E402

from spectral_tpu_torch import SpecConfig  # noqa: E402
from spectral_tpu_torch.core.stft import (  # noqa: E402
    _window_f64, bluestein_plan, center_pad, fft_plan, frame_signal,
    num_frames)
from spectral_tpu_torch.ops import stft_cuda  # noqa: E402

FS = 1000.0
EXACT = 1e-12       # of each clip's largest |d|, float64 against float64
TOL = 1e-4          # against JAX (float32), as tests/test_torch_grad.py
SD = SpecConfig.scipy_default
CSRC = Path(stft_cuda.__file__).resolve().parent / "csrc"


def jcfg(cfg):
    return JaxSpecConfig.from_json(cfg.to_json())


def clip_rel(got, want):
    """The worst clip's largest |Δ| over its largest |want|, NaN required
    in the same places and left out of both."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    nan = np.isnan(want)
    assert (np.isnan(got) == nan).all()
    b = want.shape[0]
    diff = np.where(nan, 0.0, np.abs(got - want)).reshape(b, -1).max(axis=1)
    scale = np.where(nan, 0.0, np.abs(want)).reshape(b, -1).max(axis=1)
    return float((diff / scale).max())


def signal(seed, shape, dtype=np.float64):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


def cotangent(seed, shape, out):
    rs = np.random.RandomState(seed)
    g = rs.rand(*shape)
    if out in ("complex", "stft"):
        g = g + 1j * (rs.rand(*shape) - 0.5)
    return torch.from_numpy(g)


@pytest.fixture
def drop_large_operands():
    """The dense (K, F) matrices past nfft 4096 take half a GB each:
    dropped from the operand cache after the test."""
    yield
    for key in [k for k in stft_cuda._CONSTANTS if k[0] == "dense"
                and k[2].nfft_ > 4096]:
        stft_cuda._CONSTANTS.pop(key)


# ---------------------------------------------------------------------------
# the plain FFT adjoint against the dense plain backward, float64
# ---------------------------------------------------------------------------

def _adjoint_cases():
    cases = {}
    for k in (96, 33):
        for det in ("none", "constant", "linear"):
            cases[f"k{k}_{det}"] = (SpecConfig(nperseg=k, hop=k // 4,
                                               detrend=det), "psd", None)
    for k in (992, 8160, 8032, 514, 1006, 257, 8191, 1023):
        cases[f"scipy_{k}"] = (SD(k), "psd", None)
    cases.update({
        "linear_960": (SpecConfig(nperseg=960, hop=240, detrend="linear"),
                       "psd", None),
        "linear_8191": (dataclasses.replace(SD(8191), detrend="linear"),
                        "psd", None),
        "nfft_1536_over_1000": (dataclasses.replace(SD(1000), nfft=1536),
                                "psd", None),
        "nfft_2047_over_1024": (dataclasses.replace(SD(1024), nfft=2047),
                                "psd", None),
        "nfft_45_over_30": (dataclasses.replace(SD(30), nfft=45), "psd",
                            None),
        "two_sided_mixed": (dataclasses.replace(SD(96), onesided=False),
                            "psd", None),
        "two_sided_odd": (dataclasses.replace(SD(33), onesided=False), "psd",
                          None),
        "two_sided_rader": (dataclasses.replace(SD(514), onesided=False),
                            "psd", None),
        "band_mixed": (SD(96), "psd", (3, 20)),
        "band_odd": (SD(45), "psd", (2, 15)),
        "two_sided_band_odd": (dataclasses.replace(SD(33), onesided=False),
                               "psd", (10, 30)),
    })
    for out in ("magnitude", "complex", "stft"):
        for k in (96, 33, 514):
            cases[f"{out}_{k}"] = (SD(k), out, None)
        cases[f"{out}_two_sided_odd"] = (
            dataclasses.replace(SD(45), onesided=False), out, None)
    cases.update({
        "bluestein_even_1028": (SD(1028), "psd", None),
        "bluestein_odd_563": (SD(563), "psd", None),
        "bluestein_linear_2049": (dataclasses.replace(SD(2049),
                                                      detrend="linear"),
                                  "psd", None),
        "bluestein_nfft_2049_over_2000": (dataclasses.replace(SD(2000),
                                                              nfft=2049),
                                          "psd", None),
        "bluestein_two_sided_magnitude_587": (
            dataclasses.replace(SD(587), onesided=False, mode="magnitude"),
            "magnitude", None),
        "bluestein_stft_1126": (SD(1126), "stft", None),
        "bluestein_band_563": (SD(563), "psd", (20, 200)),
    })
    return cases


ADJOINT_CASES = _adjoint_cases()


def _dense_frames_grad(g, x, cfg, band, out):
    consts = stft_cuda.dft_constants(cfg, FS, "cpu", band, out)
    X = torch.complex(*stft_cuda._reference_dft(x, consts, cfg))
    return stft_cuda.frames_backward_reference(g, X, consts, out)


def _ld_detrend(v, detrend):
    if detrend == "none":
        return v
    L = v.shape[-1]
    v = v - v.sum(axis=-1, keepdims=True) / L
    if detrend == "linear":
        c = np.arange(L, dtype=np.longdouble) - np.longdouble(L - 1) / 2
        v = v - (v * c).sum(axis=-1, keepdims=True) / (c * c).sum() * c
    return v


def _longdouble_adjoint(g, x, cfg, band, out):
    """The frames' gradient by its definition in extended precision
    (np.longdouble, scipy.fft's long-double transforms): X of each frame,
    the cotangent (the PSD's 2 w g X, the magnitude's w g X / |X|, the
    complex STFT's w g), the one-sided fold, the c2r inverse, the window
    and the detrend's projection; rounded to float64 at the end."""
    import scipy.fft as sfft
    ld = np.longdouble
    K, L = cfg.nfft_, cfg.nperseg
    lo, hi = stft_cuda.check_band(cfg, band)
    w = _window_f64(cfg).astype(ld)
    frames = frame_signal(x, L, cfg.hop_).numpy().astype(ld)
    X = sfft.rfft(_ld_detrend(frames, cfg.detrend) * w, n=K)
    bins = np.arange(lo, hi)
    mirrored = bins > K // 2
    one = np.where(mirrored, K - bins, bins)
    Xb = np.where(mirrored, X[..., one].conj(), X[..., one])
    wts = stft_cuda.kernel_weights(cfg, FS, out)[lo:hi].astype(ld)
    gg = g.numpy()
    if out in ("complex", "stft"):
        h = wts * gg.real.astype(ld) + 1j * (wts * gg.imag.astype(ld))
    elif out == "magnitude":
        a = np.abs(Xb)
        h = np.where(a == 0, 0, wts * gg.astype(ld) * Xb / np.where(
            a == 0, 1, a))
    else:
        h = 2 * wts * gg.astype(ld) * Xb
    Y = np.zeros(X.shape, X.dtype)
    np.add.at(Y, (Ellipsis, one), np.where(mirrored, h.conj(), h))
    Y[..., 1:(K + 1) // 2] *= ld(0.5)
    Y[..., 0] = Y[..., 0].real
    if K % 2 == 0:
        Y[..., K // 2] = Y[..., K // 2].real
    d = K * sfft.irfft(Y, n=K)[..., :L] * w
    return _ld_detrend(d, cfg.detrend).astype(np.float64)


@pytest.mark.parametrize("name", sorted(ADJOINT_CASES))
def test_fft_adjoint_matches_the_dense_backward(name, drop_large_operands):
    """frames_backward_fft_reference against frames_backward_reference,
    both float64, on the mixed, odd and Bluestein routes, within EXACT.
    Past nfft 4096 the dense product's own error passes EXACT (1.34e-12 of
    the clip's largest |d| at 8032, 8160 and 8191 against the long-double
    evaluation,
    1.5e-13 at 992 and 1023, where the plain FFT adjoint stays within
    1e-14 of it), so there both are held to the long-double evaluation
    (:func:`_longdouble_adjoint`): the plain FFT adjoint within EXACT, the
    dense backward within its own error at that size."""
    cfg, out, band = ADJOINT_CASES[name]
    assert stft_cuda.backward_route(cfg) in ("mixed", "odd", "bluestein")
    x = torch.from_numpy(signal(1, (2, 4 * cfg.nperseg + 37)))
    lo, hi = stft_cuda.check_band(cfg, band)
    T = num_frames(x.shape[-1], cfg.nperseg, cfg.hop_)
    g = cotangent(2, (2, T, hi - lo), out)
    got = stft_cuda.frames_backward_fft_reference(g, x, cfg, FS, band, out)
    dense = _dense_frames_grad(g, x, cfg, band, out)
    assert got.dtype == torch.float64
    assert got.shape == (2, T, cfg.nperseg)
    if cfg.nfft_ <= 4096:
        assert clip_rel(got, dense) <= EXACT
        return
    exact = _longdouble_adjoint(g, x, cfg, band, out)
    assert clip_rel(got, exact) <= EXACT
    assert clip_rel(dense, exact) <= EXACT * cfg.nfft_ / 4096


@pytest.mark.parametrize("k", [96, 33, 514])
@pytest.mark.parametrize("detrend", ["constant", "linear"])
def test_fft_adjoint_of_a_frame_of_equal_samples(k, detrend):
    """Magnitude mode on a frame of equal samples: its detrended X is 0
    exactly, the cotangent there 0, and the frame's gradient 0 in both
    versions."""
    cfg = dataclasses.replace(SD(k), mode="magnitude", detrend=detrend)
    x = signal(3, (2, 5 * k))
    x[0, :k] = 0.75
    x = torch.from_numpy(x)
    T = num_frames(5 * k, k, cfg.hop_)
    g = cotangent(4, (2, T, cfg.n_freqs), "magnitude")
    got = stft_cuda.frames_backward_fft_reference(g, x, cfg, FS)
    want = _dense_frames_grad(g, x, cfg, None, "magnitude")
    assert bool((got[0, 0] == 0).all()) and bool((want[0, 0] == 0).all())
    assert clip_rel(got, want) <= EXACT


@pytest.mark.parametrize("cfg", [
    dataclasses.replace(SD(96), center=True, pad_mode="reflect"),
    dataclasses.replace(SD(33), center=True, pad_mode="constant"),
], ids=["mixed_reflect", "odd_constant"])
def test_fft_adjoint_of_a_centered_config(cfg):
    """A centered config: the adjoints on the padded waveform, the pad's
    adjoint by autograd after both."""
    x = torch.from_numpy(signal(5, (2, 400))).requires_grad_()
    xp = center_pad(x, cfg)
    xd = xp.detach()
    T = num_frames(xd.shape[-1], cfg.nperseg, cfg.hop_)
    g = cotangent(6, (2, T, cfg.n_freqs), "psd")
    grads = []
    for d in (stft_cuda.frames_backward_fft_reference(g, xd, cfg, FS),
              _dense_frames_grad(g, xd, cfg, None, "psd")):
        dxp = stft_cuda.overlap_add_reference(d, xd.shape[-1], cfg.hop_)
        grads.append(torch.autograd.grad(xp, x, dxp, retain_graph=True)[0])
    assert clip_rel(*grads) <= EXACT


def test_fft_adjoint_of_odd_nfft_has_no_nyquist_bin():
    """Odd K: S[0] = Re H1[0] and every other one-sided bin halved. A
    cotangent at the last bin (K - 1)/2 alone gives d_v[n] = Re(H
    e^{2 pi i f n / K}) times the window."""
    cfg = SpecConfig(nperseg=33, hop=33, window="boxcar", detrend="none")
    x = torch.from_numpy(signal(7, (1, 33)))
    g = torch.zeros((1, 1, cfg.n_freqs), dtype=torch.complex128)
    g[0, 0, 16] = 0.3 - 0.7j
    got = stft_cuda.frames_backward_fft_reference(g, x, cfg, FS, out="stft")
    n = np.arange(33)
    want = np.real((0.3 - 0.7j) * np.exp(2j * np.pi * 16 * n / 33))
    np.testing.assert_allclose(got[0, 0].numpy(), want, atol=1e-13)


# ---------------------------------------------------------------------------
# the chain through the plain FFT adjoint against jax.grad
# ---------------------------------------------------------------------------

def fft_chain_grad(x, g, cfg, band=None, out=None):
    xt = torch.from_numpy(x).requires_grad_()
    xp = center_pad(xt, cfg)
    xd = xp.detach()
    d = stft_cuda.frames_backward_fft_reference(g, xd, cfg, FS, band, out)
    dxp = stft_cuda.overlap_add_reference(d, xd.shape[-1], cfg.hop_)
    if cfg.center:
        return torch.autograd.grad(xp, xt, dxp)[0].numpy()
    return dxp.numpy()


def jax_grad(fn, x):
    return np.asarray(jax.grad(fn)(jnp.asarray(x)))


PSD_CHAIN = {
    "mixed_96": SpecConfig(nperseg=96, hop=24),
    "odd_33": SpecConfig(nperseg=33, hop=8),
    "rader_257": SD(257),
    "odd_45_magnitude": dataclasses.replace(SD(45), mode="magnitude"),
    "mixed_96_two_sided": dataclasses.replace(SD(96), onesided=False),
    "odd_33_two_sided": dataclasses.replace(SD(33), onesided=False),
    "mixed_nfft_160": dataclasses.replace(SD(96), nfft=160),
    "odd_nfft_45": dataclasses.replace(SD(30), nfft=45),
    "odd_centered": dataclasses.replace(SD(33), center=True,
                                        pad_mode="reflect"),
    "mixed_linear": SpecConfig(nperseg=96, hop=24, detrend="linear"),
    "odd_linear": SpecConfig(nperseg=45, hop=11, detrend="linear"),
    "bluestein_563": SD(563),
    "bluestein_1028": SD(1028),
    "bluestein_563_two_sided": dataclasses.replace(SD(563), onesided=False),
    "bluestein_centered": dataclasses.replace(SD(563), center=True,
                                              pad_mode="reflect"),
}


@pytest.mark.parametrize("name", sorted(PSD_CHAIN))
@pytest.mark.parametrize("use_matmul", [False, True])
def test_psd_chain_through_the_fft_adjoint_matches_jax(name, use_matmul):
    """The loss sum(psd * c) through the plain FFT adjoint against jax.grad
    of the JAX package's power_spectrogram on both its engines."""
    cfg = PSD_CHAIN[name]
    assert stft_cuda.backward_route(cfg) in ("mixed", "odd", "bluestein")
    x = signal(3, (2, 1200), np.float32)
    shape = tuple(stft_cuda.stft_psd(torch.from_numpy(x), FS, cfg).shape)
    c = np.random.RandomState(4).rand(*shape).astype(np.float32)
    want = jax_grad(lambda v: jnp.sum(jstft.power_spectrogram(
        v, FS, jcfg(cfg), use_matmul=use_matmul) * c), x)
    got = fft_chain_grad(x.astype(np.float64), torch.from_numpy(c).double(),
                         cfg)
    assert clip_rel(got[None], want[None]) <= TOL


STFT_CHAIN = {
    "mixed_96": SD(96),
    "odd_33": SD(33),
    "odd_45_two_sided": dataclasses.replace(SD(45), onesided=False),
    "rader_514": SD(514),
    "odd_centered": dataclasses.replace(SD(33), center=True,
                                        pad_mode="constant"),
    "bluestein_563": SD(563),
    "bluestein_1028": SD(1028),
    "bluestein_563_two_sided": dataclasses.replace(SD(563), onesided=False),
    "bluestein_centered": dataclasses.replace(SD(563), center=True,
                                              pad_mode="constant"),
}


@pytest.mark.parametrize("name", sorted(STFT_CHAIN))
@pytest.mark.parametrize("which", [0, 1])
def test_stft_chain_through_the_fft_adjoint_matches_jax(name, which):
    """The unscaled STFT z through sum(Re z u + Im z v) and sum(|z|^2 c),
    through the plain FFT adjoint, against jax.grad of the JAX stft."""
    cfg = STFT_CHAIN[name]
    x = signal(7, (2, 1100), np.float32)
    z = stft_cuda.stft_complex(torch.from_numpy(x.astype(np.float64)), FS,
                               cfg, scaled=False)
    rs = np.random.RandomState(8)
    u, v, c = (rs.rand(*z.shape) - 0.5 for _ in range(3))
    if which == 0:
        g = torch.from_numpy(u + 1j * v)
        jloss = lambda s: jnp.sum(s.real * u + s.imag * v)  # noqa: E731
    else:
        g = 2 * torch.from_numpy(c) * z
        jloss = lambda s: jnp.sum(jnp.abs(s) ** 2 * c)      # noqa: E731
    want = jax_grad(lambda s: jloss(jstft.stft(s, jcfg(cfg),
                                               use_matmul=True)), x)
    got = fft_chain_grad(x.astype(np.float64), g, cfg, out="stft")
    assert clip_rel(got[None], want[None]) <= TOL


@pytest.mark.parametrize("cfg,band", [(SD(96), (5, 30)), (SD(45), (0, 12))],
                         ids=["mixed", "odd"])
def test_banded_chain_through_the_fft_adjoint_matches_jax(cfg, band):
    """The band's bins alone against jax.grad of the JAX package's
    power_spectrogram_fm with the same band."""
    x = signal(5, (2, 900), np.float32)
    lo, hi = band
    T = num_frames(900, cfg.nperseg, cfg.hop_)
    c = np.random.RandomState(6).rand(2, hi - lo, T).astype(np.float32)
    want = jax_grad(lambda v: jnp.sum(jstft.power_spectrogram_fm(
        v, FS, jcfg(cfg), use_matmul=True, band=band) * c), x)
    g = torch.from_numpy(c).double().transpose(1, 2)
    got = fft_chain_grad(x.astype(np.float64), g, cfg, band)
    assert clip_rel(got[None], want[None]) <= TOL


# ---------------------------------------------------------------------------
# the numpy models of the kernels' arithmetic against the plain adjoint
# ---------------------------------------------------------------------------

def _model_cases():
    cases = {}
    for k in (96, 352, 386, 992, 8160, 8032, 514, 1006, 8186, 33, 45, 257,
              1023, 4093, 8191):
        cases[f"scipy_{k}"] = (SD(k), "psd", None, {})
    for k in (96, 33, 257, 514):
        cases[f"linear_{k}"] = (SpecConfig(nperseg=k, hop=k // 4,
                                           detrend="linear"), "psd", None, {})
    for out in ("magnitude", "complex", "stft"):
        for k in (96, 33, 514, 257):
            cases[f"{out}_{k}"] = (SD(k), out, None, {})
    cases.update({
        "nfft_1536_over_1000": (dataclasses.replace(SD(1000), nfft=1536),
                                "psd", None, {}),
        "nfft_2047_over_1024": (dataclasses.replace(SD(1024), nfft=2047),
                                "psd", None, {}),
        "two_sided_mixed": (dataclasses.replace(SD(96), onesided=False),
                            "psd", None, {}),
        "two_sided_odd": (dataclasses.replace(SD(33), onesided=False),
                          "psd", None, {}),
        "two_sided_rader_stft": (dataclasses.replace(SD(514),
                                                     onesided=False),
                                 "stft", None, {}),
        "two_sided_odd_stft": (dataclasses.replace(SD(45), onesided=False),
                               "stft", None, {}),
        "band_mixed": (SD(96), "psd", (3, 20), {}),
        "band_odd": (SD(33), "psd", (2, 9), {}),
        "nan_g_odd": (SD(33), "psd", None, {"nan": True}),
        "nan_g_rader": (SD(257), "psd", None, {"nan": True}),
        "nan_g_odd_stft": (SD(45), "stft", None, {"nan": True}),
        "nan_g_mixed": (SD(96), "psd", None, {"nan": True}),
        "pair_breakers_odd": (SD(45), "psd", None, {"breakers": True}),
        "pair_breakers_magnitude": (dataclasses.replace(SD(33),
                                                        mode="magnitude"),
                                    "magnitude", None, {"breakers": True}),
        "quiet_cotangent_odd": (SD(33), "psd", None, {"quiet": True}),
        "odd_rader_1021": (SD(1021), "psd", None, {}),
        "odd_T_odd": (SD(33), "psd", None, {"n": 33 + 2 * 29 + 5}),
        "rader_T_odd": (SD(257), "psd", None, {"n": 257 + 2 * 225 + 5}),
    })
    # the Bluestein route: even (one frame a block), odd (paired), 7207
    # on the cluster's halves
    for k in (1028, 1126, 563, 587, 2049, 7207):
        cases[f"bluestein_{k}"] = (SD(k), "psd", None, {})
    for k in (1028, 563):
        cases[f"bluestein_linear_{k}"] = (
            SpecConfig(nperseg=k, hop=k // 4, detrend="linear"), "psd", None,
            {})
        for out in ("magnitude", "complex", "stft"):
            cases[f"bluestein_{out}_{k}"] = (SD(k), out, None, {})
    cases.update({
        "bluestein_stft_cluster_7207": (SD(7207), "stft", None, {}),
        "bluestein_two_sided_even": (
            dataclasses.replace(SD(1028), onesided=False), "psd", None, {}),
        "bluestein_two_sided_odd": (
            dataclasses.replace(SD(563), onesided=False), "psd", None, {}),
        "bluestein_two_sided_odd_stft": (
            dataclasses.replace(SD(587), onesided=False), "stft", None, {}),
        "bluestein_band_even": (SD(1028), "psd", (30, 300), {}),
        "bluestein_band_odd": (SD(563), "psd", (5, 90), {}),
        "bluestein_nfft_2049_over_2000": (
            dataclasses.replace(SD(2000), nfft=2049), "psd", None, {}),
        "bluestein_T_odd_563": (SD(563), "psd", None,
                                {"n": 563 + 2 * 493 + 5}),
        "bluestein_T_odd_cluster_7207": (SD(7207), "psd", None,
                                         {"n": 7207 + 2 * 6307 + 5}),
        "bluestein_nan_g_odd": (SD(563), "psd", None, {"nan": True}),
        "bluestein_nan_g_even": (SD(1028), "psd", None, {"nan": True}),
        "bluestein_nan_g_odd_stft": (SD(587), "stft", None, {"nan": True}),
        "bluestein_pair_breakers": (SD(563), "psd", None,
                                    {"breakers": True}),
        "bluestein_pair_breakers_magnitude": (
            dataclasses.replace(SD(587), mode="magnitude"), "magnitude",
            None, {"breakers": True}),
        "bluestein_quiet_cotangent": (SD(563), "psd", None, {"quiet": True}),
    })
    return cases


MODEL_CASES = _model_cases()


def _model_grad(cfg, out, band, opts):
    """The plain adjoint and the kernel's numpy model on the same seeded
    clips and gradient."""
    rs = np.random.RandomState(11)
    n = opts.get("n", 5 * cfg.nperseg + 37)
    x = rs.randn(2, n)
    if opts.get("breakers"):
        x[0] = tp.pair_breakers(x[0], cfg)
        x[0, 3 * cfg.hop_ + cfg.nperseg // 2] = 0.0   # NaN only in g
    T = num_frames(n, cfg.nperseg, cfg.hop_)
    lo, hi = stft_cuda.check_band(cfg, band)
    g = cotangent(12, (2, T, hi - lo), out).numpy()
    if opts.get("nan"):
        g[0, 1, (hi - lo) // 2] = np.nan      # frame 1 beside a finite 0
    if opts.get("quiet"):
        g[1, 2] *= 1e-6                       # frame 2's partner is loud
    want = stft_cuda.frames_backward_fft_reference(
        torch.from_numpy(g), torch.from_numpy(x), cfg, FS, band, out)
    route = stft_cuda.backward_route(cfg)
    plan = (bluestein_plan if route == "bluestein" else fft_plan)(cfg.nfft_)
    wts = stft_cuda.kernel_weights(cfg, FS, out)
    mode = "complex" if out in ("complex", "stft") else out
    model = {"mixed": tp.grad_mixed_fft, "odd": tp.grad_odd_fft,
             "bluestein": tp.grad_bluestein}[route]
    got = np.stack([model(
        frame_signal(torch.from_numpy(x[b]), cfg.nperseg, cfg.hop_).numpy(),
        _window_f64(cfg), plan, wts, g[b], cfg.detrend, cfg.nfft_, mode,
        (lo, hi), not cfg.onesided) for b in range(2)])
    return got, want.numpy(), g


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_kernel_models_match_the_plain_adjoint(name):
    """grad_mixed_fft / grad_odd_fft / grad_bluestein (the kernels'
    arithmetic, in numpy) against frames_backward_fft_reference, float64,
    within EXACT; a NaN in one frame's gradient stays in that frame."""
    cfg, out, band, opts = MODEL_CASES[name]
    got, want, g = _model_grad(cfg, out, band, opts)
    assert clip_rel(got, want) <= EXACT
    if opts.get("nan"):
        assert np.isnan(got[0, 1]).all()
        assert np.isfinite(np.delete(got[0], 1, axis=0)).all()
        assert np.isfinite(got[1]).all()


def test_bluestein_model_on_the_clusters_halves():
    """The Bluestein model's transform on the cluster's halves (7207: M =
    14,580 on two ranks, the inverse's input zero past N in rank 0's half
    as the recompute's) against the same plan on one block of M slots and
    against numpy's DFT."""
    plan = bluestein_plan(7207)
    assert (plan.m, plan.ranks) == (14580, 2)
    rs = np.random.RandomState(5)
    re_, im = rs.randn(2, 7207), rs.randn(2, 7207)
    want = np.fft.fft(re_ + 1j * im)
    scale = np.abs(want).max()
    for ranks in (2, 1):
        zr, zi = tp._bluestein_transform(re_, im, plan._replace(ranks=ranks))
        assert np.abs(zr + 1j * zi - want).max() <= 1e-12 * scale


def test_odd_model_pairs_the_inverse_by_the_cotangents_guard():
    """pair_units: a pair shares the inverse where it shared the
    recompute and both frames' S are finite, nonzero and within
    PAIR_MAX_RATIO; a NaN, zero or far quieter cotangent or an unpaired
    recompute keeps each frame alone, and an odd T's last frame has no
    partner."""
    rs = np.random.RandomState(13)
    sr, si = rs.rand(9, 5), rs.rand(9, 5)
    sr[2, 1] = np.nan                       # pair (2, 3)
    sr[5], si[5] = 0.0, 0.0                 # pair (4, 5)
    sr[6], si[6] = 1e-4 * sr[6], 1e-4 * si[6]   # pair (6, 7): 1e8 apart
    fwd = np.ones(9, bool)
    fwd[8] = False
    got = tp.pair_units(fwd, sr, si)
    assert got.tolist() == [True, True] + [False] * 7
    fwd[0:2] = False
    assert not tp.pair_units(fwd, sr, si).any()


def test_kernel_and_model_share_the_pairing_ratio():
    src = (CSRC / "stft_grad_mixed.cu").read_text()
    found = re.search(r"^constexpr double PAIR_MAX_RATIO = ([\d.]+);", src,
                      re.M)
    assert found and float(found.group(1)) == tp.PAIR_MAX_RATIO


# ---------------------------------------------------------------------------
# the wrapper off the CPU: which kernel the backward reaches
# ---------------------------------------------------------------------------

class _RecordingLib:
    """A library's launchers, recording each call and succeeding."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        if name.endswith("error_string"):
            return lambda code: b"no error"
        return lambda *args: self.calls.append((name, args)) or 0


class _NoStream:
    cuda_stream = 0


def _fail(*args, **kwargs):
    raise AssertionError("reached off the route's FFT adjoint")


def _meta_setup(monkeypatch):
    import contextlib
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _NoStream())
    calls = []
    monkeypatch.setattr(stft_cuda, "_grad_library",
                        lambda: _RecordingLib(calls))
    monkeypatch.setattr(stft_cuda, "_grad_mixed_library",
                        lambda: _RecordingLib(calls))
    return calls


def _meta_op(cfg, out=None, band=None):
    return stft_cuda.GradOp(FS, cfg, band, out or cfg.mode,
                            stft_cuda.route(cfg))


def _meta_backward(cfg, out=None, band=None, forced=None):
    op = _meta_op(cfg, out, band)
    lo, hi = stft_cuda.check_band(cfg, band)
    n = 4 * cfg.nperseg + 5
    T = num_frames(n, cfg.nperseg, cfg.hop_)
    x = torch.empty((2, n), device="meta")
    cplx = op.out in ("complex", "stft")
    g = torch.empty((2, T, hi - lo), device="meta",
                    dtype=torch.complex64 if cplx else torch.float32)
    dx = stft_cuda.stft_backward(x, g, op, _backward=forced)
    assert dx.shape == x.shape and dx.device.type == "meta"
    return T


DISPATCH = [
    ("mixed", SD(96), "psd", None),
    ("mixed", SD(8160), "psd", None),
    ("mixed", dataclasses.replace(SD(1000), nfft=1536), "stft", None),
    ("mixed", dataclasses.replace(SD(992), onesided=False,
                                  mode="magnitude"), None, (10, 900)),
    ("mixed", SD(514), "psd", None),              # a Rader plan: PACKED
    ("mixed", SD(8186), "complex", None),         # a Rader plan: PACKED
    ("odd", SD(33), "psd", None),
    ("odd", SD(8191), "psd", None),               # a Rader stage
    ("odd", dataclasses.replace(SD(1023), onesided=False,
                                mode="magnitude"), None, (3, 700)),
    ("odd", dataclasses.replace(SD(1024), nfft=2047), "stft", None),
    ("bluestein", SD(1126), "psd", None),        # even, two blocks an SM
    ("bluestein", SD(8182), "psd", None),        # even, one block
    ("bluestein", dataclasses.replace(SD(2049), mode="magnitude"), None,
     None),
    ("bluestein", SD(8185), "stft", None),       # odd, the cluster
    ("bluestein", dataclasses.replace(SD(2000), nfft=2049), "psd", None),
    ("bluestein", dataclasses.replace(SD(563), onesided=False), "complex",
     (10, 500)),
]


@pytest.mark.parametrize("kind,cfg,out,band", DISPATCH,
                         ids=[f"{k}_{c.nperseg}_{c.nfft_}_{o or c.mode}"
                              for k, c, o, _ in DISPATCH])
def test_backward_launches_the_routes_fft_adjoint_alone(monkeypatch, kind,
                                                        cfg, out, band):
    """On a tensor off the CPU the mixed, odd and Bluestein routes'
    backward is one launch of the route's FFT adjoint and the overlap-add:
    no recompute of X by the forward's complex epilogue, no dense operands,
    no plain version; the launch takes the forward's plan (its Rader row
    on the Rader plans; M and the rows of b^, the chirp and the split step
    on the Bluestein route) and the config's sizes."""
    calls = _meta_setup(monkeypatch)
    monkeypatch.setattr(stft_cuda, "_stft_psd_cuda", _fail)
    monkeypatch.setattr(stft_cuda, "dft_constants", _fail)
    monkeypatch.setattr(stft_cuda, "frames_backward_fft_reference", _fail)
    assert stft_cuda.backward_route(cfg) == kind
    before = dict(stft_cuda.grad_launches)
    T = _meta_backward(cfg, out, band)
    names = [name for name, _ in calls]
    assert names == [f"stft_{kind}_fft_backward_launch",
                     "overlap_add_launch"]
    args = calls[0][1]
    plan = (bluestein_plan if kind == "bluestein" else fft_plan)(cfg.nfft_)
    lo, hi = stft_cuda.check_band(cfg, band)
    if kind == "bluestein":
        assert args[5:10] == (len(plan.stages), plan.m, plan.bhat,
                              plan.chirp, plan.split)
        sizes = args[12:22]
        assert args[22] == lo
    elif kind == "mixed":
        assert args[7:9] == (plan.split, plan.rader)
        sizes = args[11:21]
        assert args[21] == lo
    else:
        assert args[7] == plan.rader
        sizes = args[10:20]
        assert args[20] == lo
    o = out or cfg.mode
    assert sizes == (2, 4 * cfg.nperseg + 5, T, hi - lo, cfg.nfft_,
                     cfg.nperseg, cfg.hop_,
                     stft_cuda.DETREND_CODES[cfg.detrend],
                     stft_cuda._out_mode(o), int(not cfg.onesided))
    moved = {k: stft_cuda.grad_launches[k] - before[k] for k in before}
    assert moved == {"stft_backward": 0, "stft_small_backward": 0,
                     "stft_fft_backward": 0,
                     "stft_mixed_backward": int(kind == "mixed"),
                     "stft_odd_backward": int(kind == "odd"),
                     "stft_bluestein_backward": int(kind == "bluestein"),
                     "overlap_add": 1}


@pytest.mark.parametrize("cfg", [SD(96), SD(514), SD(33), SD(8191),
                                 SD(1126), SD(2049)],
                         ids=["mixed", "packed", "odd", "odd_rader",
                              "bluestein_even", "bluestein_odd"])
def test_forced_dense_backward_launches_b1(monkeypatch, cfg):
    """_backward="dense" on a mixed, odd or Bluestein config recomputes X
    by the route's complex epilogue and launches stft_backward_launch
    (B1)."""
    calls = _meta_setup(monkeypatch)

    def meta_x(x, fs, cfg, *args, band=None, out_mode=None, **kwargs):
        lo, hi = stft_cuda.check_band(cfg, band)
        T = num_frames(x.shape[-1], cfg.nperseg, cfg.hop_)
        return torch.empty((x.shape[0], T, hi - lo), device="meta",
                           dtype=torch.complex64)

    monkeypatch.setattr(stft_cuda, "_stft_psd_cuda", meta_x)
    _meta_backward(cfg, forced="dense")
    assert [name for name, _ in calls] == ["stft_backward_launch",
                                           "overlap_add_launch"]


def test_each_fft_adjoint_refuses_another_routes_config():
    x = torch.empty((2, 900), device="meta")
    for cfg, wrong in ((SD(96), stft_cuda.frames_backward_odd),
                       (SD(33), stft_cuda.frames_backward_mixed),
                       (SD(2049), stft_cuda.frames_backward_mixed),
                       (SD(64), stft_cuda.frames_backward_odd),
                       (SD(33), stft_cuda.frames_backward_bluestein),
                       (SD(24), stft_cuda.frames_backward_bluestein)):
        T = num_frames(900, cfg.nperseg, cfg.hop_)
        g = torch.empty((2, T, cfg.n_freqs), device="meta")
        with pytest.raises(ValueError, match="is not on the"):
            wrong(g, x, cfg, FS)
    for cfg, forced in ((SD(96), "odd"), (SD(33), "mixed"), (SD(33), "fft"),
                        (SD(2049), "mixed"), (SD(96), "bluestein"),
                        (SD(24), "bluestein"), (SD(2049), "odd")):
        T = num_frames(900, cfg.nperseg, cfg.hop_)
        g = torch.empty((2, T, cfg.n_freqs), device="meta")
        with pytest.raises(ValueError, match=f"no '{forced}' backward"):
            stft_cuda.stft_backward(x, g, _meta_op(cfg), _backward=forced)


@pytest.mark.parametrize("cfg", [SD(96), SD(514), SD(33), SD(1028),
                                 SD(563)],
                         ids=["mixed", "packed", "odd", "bluestein_even",
                              "bluestein_odd"])
def test_cpu_tensors_take_the_plain_adjoint(cfg):
    """frames_backward_mixed / _odd / _bluestein on CPU tensors are the
    plain FFT adjoint."""
    n = max(700, 3 * cfg.nperseg)
    x = torch.from_numpy(signal(9, (2, n)))
    T = num_frames(n, cfg.nperseg, cfg.hop_)
    g = cotangent(10, (2, T, cfg.n_freqs), "psd")
    fn = {"mixed": stft_cuda.frames_backward_mixed,
          "odd": stft_cuda.frames_backward_odd,
          "bluestein": stft_cuda.frames_backward_bluestein}[
              stft_cuda.backward_route(cfg)]
    assert torch.equal(fn(g, x, cfg, FS),
                       stft_cuda.frames_backward_fft_reference(g, x, cfg, FS))


def _c_params(src, entry):
    found = re.search(rf"^int {entry}\((.*?)\) {{", src, re.M | re.S)
    assert found, entry
    return [p.strip() for p in found.group(1).split(",")]


def test_ctypes_prototypes_match_the_launchers(monkeypatch):
    """The wrapper's argtypes for each launcher of stft_grad_mixed.cu, one
    for each C parameter: pointers, 32-bit ints and the 64-bit n."""
    import ctypes

    class Entry:
        argtypes = None
        restype = None

    class Lib:
        def __getattr__(self, name):
            entry = Entry()
            setattr(self, name, entry)
            return entry

    from spectral_tpu_torch.ops import build
    monkeypatch.setattr(stft_cuda, "_GRAD_MIXED_LIB", [])
    monkeypatch.setattr(build, "load_library", lambda name: Lib())
    lib = stft_cuda._grad_mixed_library()
    src = (CSRC / "stft_grad_mixed.cu").read_text()
    for entry in ("stft_mixed_fft_backward_launch",
                  "stft_odd_fft_backward_launch",
                  "stft_bluestein_fft_backward_launch"):
        params = _c_params(src, entry)
        types = getattr(lib, entry).argtypes
        assert len(types) == len(params)
        for p, t in zip(params, types):
            if "*" in p:
                assert t is ctypes.c_void_p, p
            elif p.startswith("long long"):
                assert t is ctypes.c_longlong, p
            else:
                assert p.startswith("int ") and t is ctypes.c_int, p
